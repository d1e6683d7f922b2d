"""The port's host KV tier on the CPU, against the JAX package.

``serving/kv_tier.py`` (``KVTier``, ``payload_bytes``,
``payload_from_contiguous``), the spill seam in
``PagePool._spill_and_release``, the restore seams in
``PrefixCache.entry`` / ``paged_entry`` / ``PagePool.restore_entry``,
``--kv-tier-bytes`` / ``--kv-tier-disk-dir`` and the tier's
``/metrics`` block. The tiny models of ``tests/test_paged_kv_tier.py``
(vocab 260, hidden 32, 2 layers, 4 heads, 160 positions, float32; the
Llama on 2 KV heads) with weights drawn from a numpy seed.

- Tier bookkeeping, as the JAX tier's own tests hold it: exact byte
  arithmetic, the LRU bytes budget, respill and drop, the disk round
  trip and the stale-file sweep, the page shape of a contiguous
  payload, and bf16 leaves carried bit for bit.
- Both seams on {gpt, llama-GQA} x {none, int8} x {paged 16,
  contiguous}: a prefix evicted by the pool (``evict_idle``, paged) or
  by the prefix dict's own LRU restores with no prefill (``builds``
  flat), the restored greedy stream equals the never-evicted one, and
  spill and restore bytes equal ``n_pages x kv_page_bytes`` (one
  bucket-wide page on a contiguous engine).
- A blob the port's pool spills equals the JAX package's blob of the
  same prefix (``payload_from_contiguous`` of its entry): int8 payloads
  and scales exactly, float payloads within 1e-5.
- Failure discipline, as the JAX tier's tests pin it: ``tier_spill``
  degrades to discarding, ``tier_restore`` falls back cold at both
  seams, both counted with pages conserved; geometry drift drops the
  blob; pool pressure during a restore rejects with nothing
  half-installed; an ``alloc`` waits for an eviction in flight.
- The CLI flags and their mis-pair error, a classifier's refusal, and
  the tier's counters on ``/metrics`` over HTTP.
"""

import json
import os
import subprocess
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.llama import LlamaLM as JaxLlama
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.kv_tier import (
    payload_from_contiguous as jax_payload_from_contiguous,
)
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.models.llama import LlamaLM
from mlapi_tpu_torch.ops.quant import kv_page_bytes, kv_tree_bytes
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.__main__ import build_engine, parse_args
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.kv_tier import (
    KVTier,
    payload_bytes,
    payload_from_contiguous,
    to_device,
    to_host,
)
from mlapi_tpu_torch.serving.paged_pool import PagePoolExhausted
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer
from mlapi_tpu_torch.utils.vocab import LabelVocab

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
FAMILIES = {"gpt": (JaxGpt, GptLM, {}),
            "llama": (JaxLlama, LlamaLM, {"num_kv_heads": 2})}
BUCKETS = (16, 32, 64)
PAGE = 16
PRE = "You are a helpful bot."      # 22 tokens: bucket 32, two pages
TIER_METRICS = ("kv_prefix_restore_hits", "kv_prefix_restore_misses",
                "kv_prefix_restore_bytes", "kv_prefix_restore_failures",
                "kv_prefix_spill_count", "kv_prefix_spill_bytes",
                "kv_prefix_spill_failures", "kv_tier_evictions")
TIER_GAUGES = ("kv_tier_bytes_in_use", "kv_tier_entries")


def _cfg(family):
    return {**CFG, **FAMILIES[family][2]}


def _draw(family, seed=0):
    """The JAX tree's shapes, values from a numpy seed."""
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


def _model(weights, family="gpt", kv_quant="none"):
    model = FAMILIES[family][1](**_cfg(family), seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights[family]))
    model.configure(kv_quant=kv_quant, decode_attn_impl="flash")
    return model


def _engine(weights, family="gpt", kv_quant="none", page=PAGE,
            tier=1 << 24, **kw):
    return TextGenerationEngine(
        _model(weights, family, kv_quant), tokenizer=ByteTokenizer(),
        prompt_buckets=BUCKETS, kv_page_size=page, kv_tier_bytes=tier,
        **kw)


def _payload(n_pages, page=8, heads=4, hd=8, seed=0):
    """A synthetic page-shaped blob payload (one f32 layer)."""
    rng = np.random.default_rng(seed)
    return {"layer_0": {
        n: rng.standard_normal((n_pages, page, heads, hd)).astype(np.float32)
        for n in ("k", "v")}}


# -- tier bookkeeping (no engine) ---------------------------------------


def test_payload_bytes_lru_respill_and_drop():
    p = _payload(3)
    assert payload_bytes(p) == 2 * 3 * 8 * 4 * 8 * 4
    with pytest.raises(ValueError, match="kv_tier_bytes"):
        KVTier(0)
    one = payload_bytes(_payload(2))
    tier = KVTier(2 * one)           # room for exactly two blobs
    for fp in ("a", "b"):
        tier.spill(fp, _payload(2), 8)
    tier.lookup("a")                  # b is now the coldest
    tier.spill("c", _payload(2), 8)
    assert tier.evictions == 1
    assert tier.lookup("b") is None and tier.lookup("a") is not None
    assert tier.bytes_in_use == 2 * one and tier.restore_misses == 1
    big = KVTier(one // 2)            # a blob that can never fit
    big.spill("x", _payload(2), 8)
    assert big.entries == 0 and big.evictions == 1
    tier = KVTier(1 << 20)
    tier.spill("fp", _payload(2), 8)
    b1 = tier.bytes_in_use
    tier.spill("fp", _payload(2, seed=1), 8)   # replaces
    assert tier.bytes_in_use == b1 and tier.entries == 1
    assert tier.spill_count == 2
    tier.drop("fp")
    assert tier.entries == 0 and tier.bytes_in_use == 0
    tier.drop("fp")                   # idempotent


def test_disk_round_trip_and_stale_sweep(tmp_path):
    d = str(tmp_path / "tier")
    tier = KVTier(1 << 20, disk_dir=d)
    pay = _payload(2)
    tier.spill("fp", pay, 8)
    assert len(os.listdir(d)) == 1    # the payload on disk
    blob = tier.lookup("fp")
    for ln, layer in pay.items():
        for name, a in layer.items():
            np.testing.assert_array_equal(blob.payload[ln][name], a)
    assert blob.nbytes == payload_bytes(pay)
    tier.drop("fp")
    assert os.listdir(d) == []
    tier.spill("fp2", pay, 8)
    os.unlink(os.path.join(d, os.listdir(d)[0]))
    assert tier.lookup("fp2") is None and tier.entries == 0
    # Files of a dead owner go at the next tier's start; a live pid's
    # (or an unsignalable one's) and foreign files stay.
    proc = subprocess.Popen(["true"])
    proc.wait()
    dead = os.path.join(d, f"kvtier-{proc.pid}-0.npz")
    alive = os.path.join(d, "kvtier-1-0.npz")
    foreign = os.path.join(d, "notes.txt")
    for p in (dead, alive, foreign):
        open(p, "wb").close()
    KVTier(1 << 20, disk_dir=d)
    assert not os.path.exists(dead)
    assert os.path.exists(alive) and os.path.exists(foreign)


def test_contiguous_payload_page_shape_and_bf16_bits():
    k = torch.arange(20 * 4 * 8, dtype=torch.float32).reshape(1, 20, 4, 8)
    pay = payload_from_contiguous({"layer_0": {"k": k}}, 8)
    a = pay["layer_0"]["k"]
    assert a.shape == (3, 8, 4, 8)
    flat = a.reshape(1, 24, 4, 8)
    np.testing.assert_array_equal(flat[:, :20], k.numpy())
    assert not flat[:, 20:].any()
    want = jax_payload_from_contiguous({"layer_0": {"k": k.numpy()}}, 8)
    np.testing.assert_array_equal(want["layer_0"]["k"], a)
    # A bf16 leaf crosses as its own bits (numpy has no bfloat16).
    x = torch.randn(3, 16, 2, 8).to(torch.bfloat16)
    h = to_host(x)
    assert h.dtype == np.uint16 and h.nbytes == x.numel() * 2
    assert torch.equal(to_device(h, torch.bfloat16, "cpu"), x)


# -- evict -> restore: stream identity, no prefill ----------------------


@pytest.mark.parametrize("page", [PAGE, None])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_evict_restore_stream_identity(weights, family, kv_quant, page):
    """Both seams: the restored stream equals the never-evicted one,
    ``builds`` stays flat, and bytes follow the closed form."""
    eng = _engine(weights, family, kv_quant, page)
    tier = eng.kv_tier
    ref = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert eng.prefix.builds == 1
    entry = eng.prefix.entry(PRE)
    if page:
        # Seam 1, the pool (the brownout lever): the pages spill, the
        # entry survives, the next use restores the pages.
        n_pages = len(eng.pool.entry_pages(PRE))
        blob_bytes = n_pages * kv_page_bytes(eng.model, page)
        assert blob_bytes == n_pages * eng.kv_page_bytes()
        assert eng.pool.evict_idle(1) == 1
        assert tier.spill_count == 1 and tier.spill_bytes == blob_bytes
        assert eng.pool.entry_pages(PRE) is None
        out = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
        assert out["token_ids"] == ref["token_ids"]
        assert tier.restore_hits == 1 and tier.restore_bytes == blob_bytes
        assert eng.prefix.builds == 1
    else:
        # One bucket-wide page: the entry's own cache bytes.
        blob_bytes = kv_tree_bytes(entry.kv)
    # Seam 2, the prefix dict's LRU: the whole entry goes; the next
    # use rebuilds it from the blob (and, paged, restores its pages).
    eng.prefix.max_entries = 1
    eng.generate_text(" q", max_new_tokens=4, prefix="other prefix")
    assert tier.spill_count == (2 if page else 1)
    builds, hits = eng.prefix.builds, tier.restore_hits
    out2 = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert out2["token_ids"] == ref["token_ids"]
    assert eng.prefix.builds == builds
    assert tier.restore_hits == hits + (2 if page else 1)
    assert tier.restore_bytes == tier.restore_hits * blob_bytes
    if page:
        # Only the restored entry's own holds ("other prefix" left the
        # dict, and its pages with it).
        assert eng.kv_pages_in_use == n_pages


def test_entry_lru_rebuild_equals_untiered_engine(weights):
    """The restored stream of a tiered engine equals a tier-less
    engine's; a tier-less engine carries no tier state."""
    plain = _engine(weights, page=None, tier=0)
    want = plain.generate_text(" ask", max_new_tokens=6, prefix=PRE)
    eng = _engine(weights, page=None)
    eng.prefix.max_entries = 1
    eng.generate_text(" ask", max_new_tokens=6, prefix=PRE)
    eng.generate_text(" q", max_new_tokens=4, prefix="sys B")
    assert eng.kv_tier.spill_count == 1
    out = eng.generate_text(" ask", max_new_tokens=6, prefix=PRE)
    assert out["token_ids"] == want["token_ids"]
    assert eng.prefix.builds == 2 and eng.kv_tier.restore_hits == 1
    assert plain.kv_tier is None and plain.pool is None
    assert plain.kv_prefix_restore_hits == plain.kv_prefix_spill_count == 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_blob_payload_equals_jax(weights, family, kv_quant):
    """A blob the port's pool spilled, against the JAX package's.

    (a) The tier itself: JAX's ``payload_from_contiguous`` over the
    port entry's own cache bytes (what JAX's pool spill gathers: the
    bucket is page-aligned, so no pad) equals the port's blob bit for
    bit, int8 payloads and scales included, with the entry metadata.
    (b) Across packages, the JAX engine's blob of the same prefix from
    its own prefill: float leaves and scales within 1e-5; int8 payloads
    equal except at a rounding tie (the prefills' float keys agree to a
    few ulps, which can move ``x / scale`` across a half-integer): each
    such value is off by one and its ``x / scale`` in the port's float
    cache lies within 1e-3 of a half-integer."""
    eng = _engine(weights, family, kv_quant)
    eng.generate_text(" q1", max_new_tokens=2, prefix=PRE)
    entry = eng.prefix.entry(PRE)
    eng.pool.evict_idle(1)
    blob = eng.kv_tier.lookup(PRE)
    same = jax_payload_from_contiguous(
        {ln: {n: t.numpy() for n, t in layer.items()}
         for ln, layer in entry.kv.items()}, PAGE)
    assert (blob.bucket, blob.lo, blob.used) == (
        entry.bucket, entry.lo, entry.used)
    assert blob.nbytes == payload_bytes(same)
    assert {ln: set(layer) for ln, layer in blob.payload.items()} == {
        ln: set(layer) for ln, layer in same.items()}
    for ln, layer in same.items():
        for name, a in layer.items():
            got = blob.payload[ln][name]
            assert got.dtype == a.dtype, name
            np.testing.assert_array_equal(got, a, err_msg=name)
    jm = FAMILIES[family][0](**_cfg(family), kv_quant=kv_quant)
    jeng = JaxEngine(jm, jax.tree.map(jnp.asarray, weights[family]),
                     tokenizer=JaxByteTokenizer(), prompt_buckets=BUCKETS,
                     chunk=8, kv_page_size=PAGE, kv_tier_bytes=1 << 24)
    jentry = jeng.prefix.entry(PRE)
    assert (jentry.bucket, jentry.lo, jentry.used) == (
        blob.bucket, blob.lo, blob.used)
    want = jax_payload_from_contiguous(jentry.kv, PAGE)
    flt = (_engine(weights, family, "none").prefix.entry(PRE).kv
           if kv_quant == "int8" else None)
    for ln, layer in want.items():
        for name, a in layer.items():
            got = blob.payload[ln][name]
            assert got.shape == a.shape and got.dtype == a.dtype, name
            if a.dtype != np.int8:
                np.testing.assert_allclose(got, a, atol=1e-5, rtol=0,
                                           err_msg=name)
                continue
            off = np.argwhere(got != a)
            assert np.all(np.abs(got.astype(int) - a) <= 1), name
            x = flt[ln][name[0]].numpy().reshape(a.shape)
            scale = blob.payload[ln][name[0] + "_scale"]
            for i in map(tuple, off):
                r = abs(x[i] / scale[i[:-1] + (0,)])
                assert abs(r - np.floor(r) - 0.5) < 1e-3, (name, i, r)


# -- failure discipline -------------------------------------------------


def test_spill_fault_degrades_to_discard(weights):
    eng = _engine(weights)
    ref = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    with faults.active("tier_spill:raise"):
        assert eng.pool.evict_idle(1) == 1
    assert eng.kv_tier.spill_count == 0
    assert eng.kv_tier.spill_failures == 1 and eng.kv_tier.entries == 0
    assert eng.pool.entry_pages("sys") is None and eng.kv_pages_in_use == 0
    out = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    assert out["token_ids"] == ref["token_ids"]   # adopted again
    assert eng.kv_tier.restore_hits == 0 and eng.prefix.builds == 1
    # The dict-LRU seam degrades the same way.
    eng.prefix.max_entries = 1
    with faults.active("tier_spill:raise"):
        eng.generate_text(" q", max_new_tokens=4, prefix="sys B")
    assert eng.kv_tier.spill_failures == 2 and eng.kv_tier.entries == 0


def test_restore_fault_falls_back_cold_at_both_seams(weights):
    eng = _engine(weights)
    ref = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    eng.pool.evict_idle(1)
    with faults.active("tier_restore:raise"):
        out = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    assert out["token_ids"] == ref["token_ids"]
    assert eng.kv_tier.restore_failures == 1
    assert eng.kv_tier.restore_hits == 0 and eng.kv_tier.entries == 1
    n_pages = len(eng.pool.entry_pages("sys"))
    assert eng.kv_pages_in_use == n_pages    # the adopt; nothing leaked
    eng.pool.evict_idle(1)
    out = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    assert out["token_ids"] == ref["token_ids"]
    assert eng.kv_tier.restore_hits == 1
    # The entry-rebuild seam: a cold prefill, counted.
    eng.prefix.max_entries = 1
    eng.generate_text(" q", max_new_tokens=4, prefix="sys B")
    builds = eng.prefix.builds
    with faults.active("tier_restore:raise"):
        out = eng.generate_text(" q1", max_new_tokens=6, prefix="sys")
    assert out["token_ids"] == ref["token_ids"]
    assert eng.prefix.builds == builds + 1
    assert eng.kv_tier.restore_failures >= 2


def test_geometry_drift_drops_the_blob(weights):
    eng = _engine(weights)
    ref = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    eng.pool.evict_idle(1)
    blob = eng.kv_tier.lookup(PRE)
    # A blob of another page size (a stale disk tier, say): dropped at
    # the restore, never applied.
    eng.kv_tier.spill(PRE, {
        ln: {n: a.reshape((-1, 8) + a.shape[2:]) for n, a in layer.items()}
        for ln, layer in blob.payload.items()}, 8)
    out = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert out["token_ids"] == ref["token_ids"]
    assert eng.kv_tier.entries == 0
    # A tampered bucket: the entry rebuild declines, drops, builds.
    eng.prefix.max_entries = 1
    eng.pool.evict_idle(1)
    eng.generate_text(" q", max_new_tokens=4, prefix="other")
    with eng.kv_tier._lock:
        eng.kv_tier._blobs[PRE].bucket = 999
    builds = eng.prefix.builds
    out2 = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert out2["token_ids"] == ref["token_ids"]
    assert eng.prefix.builds == builds + 1


def test_restore_under_pool_pressure_rejects_loudly(weights):
    eng = _engine(weights)
    ref = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    eng.pool.evict_idle(1)
    n_pages = eng.kv_tier.lookup(PRE).num_pages
    # Fewer free pages than the blob needs: the restore's own alloc
    # fails before any write or registration.
    free = eng.kv_pages_total - eng.kv_pages_in_use
    hold = eng.pool.alloc(free - (n_pages - 1))
    with pytest.raises(PagePoolExhausted):
        eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert eng.kv_pages_in_use == len(hold)
    assert eng.pool.entry_pages(PRE) is None
    assert eng.kv_tier.entries == 1 and eng.kv_tier.restore_hits == 0
    # Room for the restore but not the suffix: the restored set stays
    # resident on its own hold (accounted, evictable), rows released.
    eng.pool.release(hold)
    hold = eng.pool.alloc(eng.kv_pages_total - eng.kv_pages_in_use - n_pages)
    with pytest.raises(PagePoolExhausted):
        eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    pages = eng.pool.entry_pages(PRE)
    assert pages is not None and len(pages) == n_pages
    assert np.all(eng.pool.ref[pages] == 1)
    assert eng.kv_pages_in_use == len(hold) + n_pages
    eng.pool.release(hold)
    out = eng.generate_text(" q1", max_new_tokens=6, prefix=PRE)
    assert out["token_ids"] == ref["token_ids"]


def test_alloc_waits_for_an_eviction_in_flight(weights):
    eng = _engine(weights)
    pool = eng.pool
    pool.put_entry_pages("victim", pool.alloc(2))   # the only victim
    hold = pool.alloc(pool.pages_total - pool.pages_in_use)
    started = threading.Event()
    real_spill = eng.kv_tier.spill

    def slow_spill(*a, **kw):
        started.set()
        time.sleep(0.3)
        return real_spill(*a, **kw)

    eng.kv_tier.spill = slow_spill
    done = {}
    t = threading.Thread(target=lambda: done.update(n=pool.evict_idle(1)))
    t.start()
    assert started.wait(5)
    pages = pool.alloc(1)   # mid-spill: waits, does not shed
    t.join(10)
    assert not t.is_alive()
    assert done["n"] == 1 and len(pages) == 1
    assert eng.kv_tier.spill_count == 1
    pool.release(pages)
    pool.release(hold)
    assert pool.pages_in_use == 0


# -- CLI and /metrics ----------------------------------------------------


def test_cli_flags_refusals_and_metrics_over_http(weights, tmp_path):
    args = parse_args(["--checkpoint", "c", "--kv-tier-bytes", "4096",
                       "--kv-tier-disk-dir", "d"])
    assert (args.kv_tier_bytes, args.kv_tier_disk_dir) == (4096, "d")
    args = parse_args(["--checkpoint", "c"])
    assert (args.kv_tier_bytes, args.kv_tier_disk_dir) == (0, None)
    with pytest.raises(SystemExit):
        parse_args(["--checkpoint", "c", "--kv-tier-disk-dir", "d"])
    with pytest.raises(ValueError, match="kv_tier_disk_dir requires "
                                         "kv_tier_bytes > 0"):
        _engine(weights, tier=0, kv_tier_disk_dir=str(tmp_path))
    lin = get_model("linear", num_features=4, num_classes=3, seed=0,
                    device="cpu")
    clf = save_checkpoint(
        tmp_path / "clf", lin.state_dict(), vocab=LabelVocab(("a", "b", "c")),
        config={"model": "linear",
                "model_kwargs": {"num_features": 4, "num_classes": 3}})
    with pytest.raises(ValueError) as e:
        build_engine(clf, device="cpu", kv_tier_bytes=1 << 20)
    assert str(e.value) == (
        "kv_tier_bytes/kv_tier_disk_dir apply to generative checkpoints "
        "(they cache prefix KV); LinearClassifier has none")
    gpt = save_checkpoint(
        tmp_path / "gpt", params_from_jax(weights["gpt"]),
        config={"model": "gpt_lm", "model_kwargs": CFG,
                "tokenizer": ByteTokenizer().fingerprint()})
    eng = build_engine(gpt, device="cpu", decode_attn_impl="flash",
                       kv_page_size=PAGE, kv_tier_bytes=1 << 24,
                       kv_tier_disk_dir=str(tmp_path / "tier"))
    assert eng.kv_tier.disk_dir == str(tmp_path / "tier")
    assert eng.pool.tier is eng.kv_tier

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(body).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with BackgroundServer(build_app(eng)) as srv:
        body = {"prefix": PRE, "text": " q1", "max_new_tokens": 6}
        want = post(srv.port, body)["token_ids"]
        eng.pool.evict_idle(1)
        assert post(srv.port, body)["token_ids"] == want
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
            snap = json.loads(r.read())
    c, g = snap["counters"], snap["gauges"]
    for name in TIER_METRICS:
        assert c[f"generate.{name}"] == getattr(eng, name), name
    for name in TIER_GAUGES:
        assert g[f"generate.{name}"] == getattr(eng, name), name
    assert c["generate.kv_prefix_spill_count"] == 1
    assert c["generate.kv_prefix_restore_hits"] == 1
    assert (c["generate.kv_prefix_restore_bytes"]
            == c["generate.kv_prefix_spill_bytes"]
            == g["generate.kv_tier_bytes_in_use"] > 0)
    assert c["generate.kv_entry_evictions"] == 1
    assert g["generate.kv_tier_entries"] == 1
    assert "generate.fused_calls" in c
    assert len(os.listdir(tmp_path / "tier")) == 1
