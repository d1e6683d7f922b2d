"""The port's shared-prefix serving on the CPU, against the JAX package.

One parameter tree drawn from a numpy seed serves in both packages (a
tiny float32 GPT and a GQA Llama: 4 query heads on 2 KV heads, 160
positions, buckets 16/32/64). On the CPU the flash path runs the
kernels' plain versions.

- A deterministic request trace (``TRACE``, at two entries and a
  24-page pool: a cold prefix in a same-prefix batch, a cross-prefix
  batch sharing pages at a tile shift whose short row finishes first,
  an unaligned prefix at the window edge that copies its group-end page
  on write and evicts the least recently used entry, a cross-prefix
  batch on the copy fallback that rebuilds an evicted entry and evicts
  an idle page set under pool pressure, an empty suffix beside a plain
  prompt, the evicted set adopted again) through the JAX engine (paged,
  16-token pages) and through the port for {contiguous, paged 16} x
  {einsum, flash}, with a full-precision cache (an int8 cache: the two
  batches that share pages at a shift and COW): greedy streams token
  for token, and
  every prefix counter (hits, misses, fallbacks, builds, adopted bytes,
  copy fallbacks, COW copies, entry-set evictions, shared pages while
  each batch runs, pages resident after) equal to the JAX engine's.
- The port's ``prefix_prefill_fn``, ``paged_scatter_fn`` and
  ``paged_cow_fn`` against the JAX functions on the same numpy inputs:
  caches' float leaves within 1e-5 (int8 scales included), int8
  payloads and first tokens exact, pools exact; ``PagePool.evict_idle``
  against the JAX pool's.
- In the port, a prefix stream equals the ``prefix + text`` stream,
  greedy and sampled, on both layouts (full-precision cache: an int8
  cache stores what the plain prompt attends in full precision).
- Concurrent first requests share one build; prefix and plain rows
  never share a batch; a hit does not tokenize the prefix again;
  oversized prefixes and suffixes are refused, over HTTP with a 422 at
  ``["prefix"]``.
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models import gpt as jgpt
from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.llama import LlamaLM as JaxLlama
from mlapi_tpu.ops import quant as jq
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.requests import _SyncSink as JaxSink
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models import gpt as tgpt
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.models.llama import LlamaLM
from mlapi_tpu_torch.ops import quant as tq
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
FAMILIES = {"gpt": (JaxGpt, GptLM, {}),
            "llama": (JaxLlama, LlamaLM, {"num_kv_heads": 2})}
BUCKETS = (16, 32, 64)
PAGE = 16
TOL = 1e-5
PA = "abcdefgh" * 3      # 24 tokens: bucket 32, lo 8 (page-aligned)
PB = "zyxwvuts" * 5      # 40 tokens: bucket 64, lo 24
PC = "b" * 135           # cap 143 < 144: stays unaligned at 135, lo 0
# (suffix, prefix, max_new_tokens) per batch, in order, at two entries
# and 24 usable pages (entries: PA 2 pages, PB 4, PC 9).
TRACE = (
    (("ij", PA, 8), ("qrstuvwxyz0123", PA, 8)),   # PA built, then a hit
    (("ij", PA, 4), ("kl", PB, 14)),              # P = 64, shifts 32, 0;
                                                  # row 0 ends: compaction
    (("mn", PC, 8), ("opq", PC, 4)),              # PA's entry and pages
                                                  # go; P = 135: COW a row
    (("ij", PC, 8), ("kl", PA, 8)),               # PA rebuilt, PB goes;
                                                  # shift 103: copy into 18
                                                  # pages, PC's idle set
                                                  # evicted for them
    (("", PA, 6), ("hello", None, 6)),            # empty suffix: plain
    (("zz", PC, 8), ("yy", PC, 8)),               # PC adopted again
)
POOL_PAGES, MAX_ENTRIES = 25, 2
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_fallbacks",
            "prefix_builds", "prefix_adopt_bytes", "kv_prefix_copy_fallback",
            "kv_pages_in_use")


def _cfg(family):
    return {**CFG, **FAMILIES[family][2]}


def _draw(family, seed=0):
    """The JAX tree's shapes, values from a numpy seed, wide enough that
    each prompt streams its own tokens."""
    jm = FAMILIES[family][0](**_cfg(family))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    return {f: _draw(f) for f in FAMILIES}


def _port_model(weights, family, **modes):
    model = FAMILIES[family][1](**_cfg(family), seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights[family]))
    model.configure(**modes)
    return model


def _port(weights, family, page=PAGE, kv_quant="none", impl="flash", **kw):
    model = _port_model(weights, family, kv_quant=kv_quant,
                        decode_attn_impl=impl)
    # The plain chunk, as the JAX engine here is pinned.
    return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                prompt_buckets=BUCKETS, kv_page_size=page,
                                fused_single=False, **kw)


def _jax(weights, family, page=PAGE, kv_quant="none", **kw):
    jm = FAMILIES[family][0](**_cfg(family), kv_quant=kv_quant)
    return JaxEngine(jm, jax.tree.map(jnp.asarray, weights[family]),
                     tokenizer=JaxByteTokenizer(), prompt_buckets=BUCKETS,
                     chunk=8, fused_single=False, kv_page_size=page, **kw)


def _batch(eng, sink_cls, specs):
    """One formed batch of ``(suffix, prefix, n_new)`` through the
    engine's ``_run_batch``; returns the streams and the shared pages
    seen at the first delivered token (the rows then hold theirs)."""
    outs = [[] for _ in specs]
    shared: list = []
    sinks = []
    for (text, prefix, n), out in zip(specs, outs):
        sink = sink_cls(eng._encode(text, n, 0.0, 0, None, prefix=prefix),
                        out)
        push = sink.push

        def probe(item, _push=push):
            if not shared:
                shared.append(eng.kv_pages_shared)
            _push(item)

        sink.push = probe
        sinks.append(sink)
    eng._run_batch(sinks)
    errors = [s.error for s in sinks if s.error is not None]
    assert not errors, errors
    return outs, shared[0]


def _trace(eng, sink_cls, trace=TRACE):
    eng.prefix.max_entries = MAX_ENTRIES
    streams, shared = [], []
    for specs in trace:
        outs, sh = _batch(eng, sink_cls, specs)
        streams.append(outs)
        shared.append(sh)
    counts = {k: getattr(eng, k) for k in COUNTERS}
    counts["cow_copies"] = eng.pool.cow_copies if eng.pool else 0
    counts["entry_evictions"] = eng.pool.entry_evictions if eng.pool else 0
    counts["kv_pages_shared"] = shared
    return streams, counts


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_trace_streams_and_counters_equal_jax(weights, family, kv_quant):
    """The JAX engine's trace once, then the port's four: contiguous and
    paged, einsum and flash. An int8 cache runs the trace's second and
    third batches (the JAX package compiles each batch's programs, a
    few seconds of CPU apiece): the cross-prefix formation sharing pages
    at a shift and the COW one, where the cache format matters."""
    trace = TRACE if kv_quant == "none" else TRACE[1:3]
    want_streams, want = _trace(
        _jax(weights, family, kv_quant=kv_quant, kv_pages=POOL_PAGES),
        JaxSink, trace)
    # The trace reached every path it names: builds, misses, hits,
    # fallbacks, copy fallbacks, COW copies, evicted page sets, which
    # batches shared pages, and pages resident at the end (the entries':
    # PC's 9; PB's 4 too in the int8 trace).
    reached = tuple(want[k] for k in (
        "prefix_builds", "prefix_misses", "prefix_hits", "prefix_fallbacks",
        "kv_prefix_copy_fallback", "cow_copies", "entry_evictions"))
    shared = [n > 0 for n in want["kv_pages_shared"]]
    if kv_quant == "none":
        assert reached == (4, 4, 6, 1, 1, 4, 1)
        assert shared == [True, True, True, False, False, True]
        assert want["kv_pages_in_use"] == 9
    else:
        assert reached == (3, 3, 1, 0, 0, 2, 0)
        assert shared == [True, True]
        assert want["kv_pages_in_use"] == 13
    for page in (None, PAGE):
        for impl in ("einsum", "flash"):
            eng = _port(weights, family, page, kv_quant, impl,
                        **({"kv_pages": POOL_PAGES} if page else {}))
            streams, got = _trace(eng, _SyncSink, trace)
            assert streams == want_streams, (page, impl)
            if page is None:
                # A contiguous cache has no pool: the same prefix
                # counters, none of the pool's.
                assert got["kv_pages_shared"] == [0] * len(trace)
                got = {k: v for k, v in got.items() if k.startswith(
                    ("prefix_hits", "prefix_m", "prefix_f", "prefix_b"))}
                assert got == {k: want[k] for k in got}, (page, impl)
            else:
                assert got == want, (page, impl)
                assert eng.pool.pages_shared == 0


# -- the model-level functions against JAX's ---------------------------

def _np_cache(rng, b, length, kvh, d, kv_quant):
    shape = (b, length, kvh, d)
    if kv_quant == "int8":
        return {"k_q": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.random(shape[:3] + (1,)).astype(np.float32),
                "v_q": rng.integers(-127, 128, shape).astype(np.int8),
                "v_scale": rng.random(shape[:3] + (1,)).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _assert_trees(got, want, tol=0.0):
    for ln in want:
        for name in want[ln]:
            g, w = np.asarray(got[ln][name]), np.asarray(want[ln][name])
            assert g.shape == w.shape and g.dtype == w.dtype, (ln, name)
            if tol and g.dtype == np.float32:
                np.testing.assert_allclose(g, w, atol=tol, rtol=0)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family,kv_quant", [("gpt", "none"),
                                             ("llama", "int8")])
def test_prefix_prefill_fn_equals_jax(weights, family, kv_quant):
    """A prefix KV under a 16-token suffix block: broadcast ``[1, P]``
    with the scalar ``lo``, and a per-row ``[B, P]`` stack with a
    per-row ``lo`` whose dummy row has an empty region (``lo == P``)."""
    cfg = _cfg(family)
    kvh = cfg.get("num_kv_heads", cfg["num_heads"])
    d = cfg["hidden_size"] // cfg["num_heads"]
    rng = np.random.default_rng(5)
    b, p, u, total = 4, 32, 16, 64
    suffix = rng.integers(4, 260, (b, u))
    hole = np.asarray([0, 3, 9, u - 1])
    jm = FAMILIES[family][0](**cfg, kv_quant=kv_quant)
    jp = jax.tree.map(jnp.asarray, weights[family])
    tm = _port_model(weights, family, kv_quant=kv_quant)
    keys = np.stack([JaxEngine._key_data(0)] * b)
    for rows, lo in ((1, 5), (b, np.asarray([5, 0, 17, p]))):
        kv = {f"layer_{n}": _np_cache(rng, rows, p, kvh, d, kv_quant)
              for n in range(cfg["num_layers"])}
        jfirst, jcache = jgpt.prefix_prefill_fn(jm, u, total)(
            jp, jax.tree.map(jnp.asarray, kv), jnp.asarray(suffix, jnp.int32),
            jnp.asarray(hole, jnp.int32), jnp.asarray(lo, jnp.int32), keys,
            jnp.zeros((b,), jnp.float32), jnp.zeros((b,), jnp.int32),
            jnp.ones((b,), jnp.float32),
        )
        tkv = {ln: {n: torch.as_tensor(a) for n, a in layer.items()}
               for ln, layer in kv.items()}
        tlo = lo if np.ndim(lo) == 0 else torch.as_tensor(lo)
        with torch.inference_mode():
            tfirst, tcache = tgpt.prefix_prefill_fn(
                tm, tkv, torch.as_tensor(suffix), torch.as_tensor(hole), tlo,
                np.zeros(b, np.int64), np.zeros(b, np.float32),
                np.zeros(b, np.int64), np.ones(b, np.float32), total=total,
            )
        assert tfirst.tolist() == np.asarray(jfirst).tolist()
        _assert_trees(_to_np(tcache), jax.tree.map(np.asarray, jcache), TOL)


def _pools(rng, kv_quant, n_pages=9, page=4, kvh=2, d=8):
    return {f"layer_{n}": _np_cache(rng, n_pages, page, kvh, d, kv_quant)
            for n in range(2)}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_scatter_fn_equals_jax(kv_quant):
    """A ``[2, 10]`` cache into 4-token pages at virtual offset 2: it
    spans three pages of each row's table, and row 0's first tile is
    the null page."""
    rng = np.random.default_rng(7)
    pools = _pools(rng, kv_quant)
    mini = {ln: _np_cache(rng, 2, 10, 2, 8, kv_quant) for ln in pools}
    table = np.asarray([[0, 3, 7, 1, 0], [5, 2, 8, 6, 0]], np.int32)
    want = jgpt.paged_scatter_fn()(
        jq.paged_cache_tree(jax.tree.map(jnp.asarray, pools),
                            jnp.asarray(table)),
        jax.tree.map(jnp.asarray, mini), jnp.asarray(table), jnp.int32(2),
    )
    tpools = {ln: {n: torch.as_tensor(a) for n, a in layer.items()}
              for ln, layer in pools.items()}
    cache = tq.paged_cache_tree(tpools, table)
    got = tgpt.paged_scatter_fn(
        cache, {ln: {n: torch.as_tensor(a) for n, a in layer.items()}
                for ln, layer in mini.items()}, table, 2)
    # Written in place, into the pool tensors themselves.
    assert got is cache and all(
        got[ln][n] is t for ln, layer in tpools.items()
        for n, t in layer.items())
    _assert_trees(_to_np(got), jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_cow_fn_equals_jax(kv_quant):
    rng = np.random.default_rng(8)
    pools = _pools(rng, kv_quant)
    table = np.asarray([[1, 2]], np.int32)
    src, dst = np.asarray([3, 1, 4], np.int32), np.asarray([6, 7, 8], np.int32)
    want = jgpt.paged_cow_fn()(
        jq.paged_cache_tree(jax.tree.map(jnp.asarray, pools),
                            jnp.asarray(table)),
        jnp.asarray(src), jnp.asarray(dst),
    )
    tpools = {ln: {n: torch.as_tensor(a) for n, a in layer.items()}
              for ln, layer in pools.items()}
    got = tgpt.paged_cow_fn(tq.paged_cache_tree(tpools, table), src, dst)
    # In place: the pool tensors hold the copies.
    assert all(got[ln][n] is t for ln, layer in tpools.items()
               for n, t in layer.items())
    _assert_trees(_to_np(got), jax.tree.map(np.asarray, want))


def test_evict_idle_equals_jax(weights):
    """``PagePool.evict_idle`` against the JAX pool's on the same
    sequence: three entry sets, the oldest held by a row (so the next
    two go, LRU first, and no more), then the hold dropped. Returns,
    surviving entries, references and the free list agree."""
    from mlapi_tpu.serving.paged_pool import PagePool as JaxPool
    from mlapi_tpu_torch.serving.paged_pool import PagePool

    pools = (JaxPool(JaxGpt(**_cfg("gpt")), page_size=PAGE, num_pages=9),
             PagePool(_port_model(weights, "gpt"), page_size=PAGE,
                      num_pages=9))
    seen = []
    for pool in pools:
        for fp in ("a", "b", "c"):
            pool.put_entry_pages(fp, pool.alloc(2))
        held = pool.entry_pages("a", holds=1)
        dropped = [pool.evict_idle(5)]
        after_held = (list(pool._entries), pool.pages_in_use)
        pool.release(held)
        dropped += [pool.evict_idle(5), pool.evict_idle(1)]
        seen.append((dropped, after_held, list(pool._entries),
                     pool.ref.tolist(), sorted(pool._free),
                     pool.entry_evictions))
    assert seen[0] == seen[1]
    assert seen[1][:3] == ([2, 1, 0], (["a"], 2), [])


# -- port equivalences and the engine's rules ---------------------------

@pytest.mark.parametrize("page", [None, PAGE])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_prefix_stream_equals_concatenated_prompt(weights, family, page):
    """Greedy and seeded sampling, a padded and an aligned prefix, a
    suffix whose pad hole and the prefix's own pad are both non-zero
    (Llama's rotated keys continue at the prefix's real length)."""
    eng = _port(weights, family, page)
    for prefix in (PA, "abcdefgh" * 4):
        for suffix in ("ij", "ijklmnopqrstuvwxyz"):
            for kw in ({}, dict(temperature=0.9, seed=12, top_k=50)):
                plain = eng.generate_text(prefix + suffix, max_new_tokens=10,
                                          **kw)
                via = eng.generate_text(suffix, max_new_tokens=10,
                                        prefix=prefix, **kw)
                assert via == plain, (prefix, suffix, kw)
    assert eng.prefix_misses == 2 and eng.prefix_hits == 6
    assert eng.prefix_fallbacks == 0


def test_concurrent_first_requests_share_one_build(weights):
    solo_eng = _port(weights, "llama", page=None)
    suffixes = ["ij", "klmn", "op", "qrstuv"]
    solo = [solo_eng.generate_text(s, max_new_tokens=6,
                                   prefix=PA)["token_ids"]
            for s in suffixes]
    eng = _port(weights, "llama", max_wait_ms=200.0)

    async def run():
        await eng.start()
        try:
            gens = await asyncio.gather(*[
                eng.submit(s, max_new_tokens=6, prefix=PA) for s in suffixes
            ])
            return [await _collect(g) for g in gens]
        finally:
            await eng.stop()

    base = eng.batch_calls
    assert asyncio.run(run()) == solo
    assert (eng.prefix_builds, eng.prefix_misses, eng.prefix_hits) == (1, 1, 3)
    assert eng.batch_calls - base <= 2


async def _collect(req) -> list[int]:
    out: list[int] = []
    while True:
        item = await req.queue.get()
        if item is None:
            return out
        if isinstance(item, Exception):
            raise item
        out.extend(item["token_ids"])


def test_prefix_and_plain_never_share_a_batch(weights):
    """A prefix request staged while a plain batch runs is handed to the
    next batch (never admitted), and each streams what it streams
    alone."""
    eng = _port(weights, "gpt", chunk=2, max_wait_ms=0.0)
    want_plain = eng.generate_text("abcd", max_new_tokens=24)["token_ids"]
    want_pre = eng.generate_text("ij", max_new_tokens=4,
                                 prefix=PA)["token_ids"]
    assert not eng._compatible([eng._encode("ij", 4, 0.0, 0, None,
                                            prefix=PA)],
                               eng._encode("ij", 4, 0.0, 0, None))

    async def run():
        await eng.start()
        try:
            a = await eng.submit("abcd", max_new_tokens=24, stream=True)
            head = await a.queue.get()
            b = await eng.submit("ij", max_new_tokens=4, prefix=PA)
            got_b = await _collect(b)
            return head["token_ids"] + await _collect(a), got_b
        finally:
            await eng.stop()

    assert asyncio.run(run()) == (want_plain, want_pre)
    assert eng.admitted == 0


def test_hit_does_not_tokenize_the_prefix_again(weights):
    eng = _port(weights, "gpt", page=None)
    eng.generate_text("ij", max_new_tokens=2, prefix=PA)
    calls = []
    orig = eng.tokenizer.token_ids
    eng.tokenizer.token_ids = lambda s: calls.append(s) or orig(s)
    eng.generate_text("kl", max_new_tokens=2, prefix=PA)
    assert PA not in calls and "kl" in calls


def test_oversized_prefix_and_suffix_refused(weights):
    eng = _port(weights, "gpt")
    cap = eng.model.max_positions - eng.prompt_buckets[0] - 1
    with pytest.raises(ValueError, match="fit the model window"):
        eng.generate_text("ij", max_new_tokens=2, prefix="a" * (cap + 10))
    with pytest.raises(ValueError, match="leaves no room"):
        eng.generate_text("ij", max_new_tokens=150, prefix="a" * 16)
    # Prefix 128 -> bucket 128 at page 16: 24 slots behind it for 8 new
    # tokens, and a 30-token suffix would be cut, so it is refused.
    with pytest.raises(ValueError, match="exceed the model window"):
        eng.generate_text("x" * 30, max_new_tokens=8, prefix="a" * 128)
    assert eng.kv_pages_in_use == 0


def _post(port, body):
    """The answer, or an NDJSON stream's last line."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read().splitlines()[-1])


def test_http_prefix_field_and_metrics(weights):
    want = _port(weights, "llama", page=None, kv_quant="int8").generate_text(
        "ij", max_new_tokens=6, prefix=PA)
    eng = _port(weights, "llama", kv_quant="int8")
    with BackgroundServer(build_app(eng)) as srv:
        got = _post(srv.port, {"text": "ij", "prefix": PA,
                               "max_new_tokens": 6})
        again = _post(srv.port, {"text": "ij", "prefix": PA,
                                 "max_new_tokens": 6, "stream": True})
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "ij", "prefix": "a" * 200})
        assert e.value.code == 422
        detail = json.loads(e.value.read())["detail"]
        assert detail[0]["loc"] == ["prefix"]
        # An adapter on an engine without adapter slots: the JAX
        # engine's AdapterUnavailable, a 404.
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "ij", "adapter": "t1"})
        assert e.value.code == 404
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=60
        ) as r:
            metrics = json.loads(r.read())
    assert got["token_ids"] == want["token_ids"]
    assert got["prompt_tokens"] == want["prompt_tokens"] == 26
    assert again["done"] and again["token_ids"] == want["token_ids"]
    c, g = metrics["counters"], metrics["gauges"]
    assert (c["generate.prefix_hits"], c["generate.prefix_misses"],
            c["generate.prefix_builds"], c["generate.prefix_fallbacks"]) == (
        1, 1, 1, 0)
    # int8 at 2 KV heads of 8, 2 layers: a 32-slot entry's K and V.
    assert c["generate.prefix_adopt_bytes"] == 2 * 2 * 32 * 2 * (8 + 4)
    assert c["generate.kv_prefix_copy_fallback"] == 0
    assert g["generate.kv_pages_shared"] == 0
    assert g["generate.kv_pages_in_use"] == 2
