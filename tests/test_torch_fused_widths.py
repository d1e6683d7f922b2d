"""The port's fused-chunk widths on the CPU, against the JAX package.

Both engines run at their defaults (``fused_single=True``, ``chunk`` 8,
``default_max_new_tokens`` 32, so ``fused_max_new`` 64 and the ladder
32, 64); the JAX engine is never warmed up, so its strict-mode gate,
which the port has no counterpart of, stays off. The small GPT of
``tests/test_paged_kv_tier.py`` (vocab 260, hidden 32, 2 layers, 4
heads, 160 positions, float32), its weights drawn from a numpy seed,
serves in both. On the CPU the flash impl runs the kernels' plain
versions.

One JAX engine trace per module (``reference``), then the port's on
the contiguous layout and on 16-token pages:

- one formed batch of 8 non-streaming prompts at budgets 20 and 100
  (100 is above ``fused_max_new``, so the widths cap at 64; the
  20-token rows finish and the batch compacts);
- a non-streaming batch with a streaming joiner staged: while the
  joiner is live the widths drop to ``chunk``;
- a non-streaming solo prompt beside a streaming one at formation
  (plain widths for the whole run);
- two window-incompatible groups through the unit scheduler at 1 and 2
  lanes, one non-streaming (fused widths) and one streaming (a ``sched_unit`` delay on the first
  formation holds the dispatch thread until both groups are queued, so
  the interleaving is the same in both packages).

Greedy streams token for token, and ``chunk_calls``, ``fused_calls``,
``batch_calls``, ``compactions``, ``admitted`` and every ``sched_*``
counter (``sched_lane_stall_max`` included) equal the JAX engine's.
The width policy itself (``tiers``, ``chunk_width``, ``width_at``)
equals JAX's ``FusedSinglePath`` on the same inputs.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.serving import faults as jfaults
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.fused_single import FusedSinglePath as JaxFused
from mlapi_tpu.serving.requests import _SyncSink as JaxSink
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.app import _generate_metrics
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.fused_single import FusedSinglePath
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
BUCKETS = (16, 32, 64)
POOL_PAGES = 100         # 8 rows of a 144-slot window, and two lanes
# Formed batches: (suffix, max_new_tokens, stream) per row; a batch's
# last entry may be a staged joiner (``"join"``).
WIDE = [(f"row {i} says", 20 if i % 2 else 100, False) for i in range(8)]
JOIN = [("fused rows", 40, False), ("more fused", 40, False),
        ("join", 10, True, "join")]
MIXED = [("not streaming", 40, False), ("streaming", 24, True)]
BATCHES = (WIDE, JOIN, MIXED)
# Two window-incompatible groups (16 + 128 and 128 + 32 slots): the
# first decodes in two 64-wide chunks, the second streams in plain ones.
GROUPS = ([("hello world", 100, False), ("hello there", 60, False)],
          [("x" * 100, 24, True)])
COUNTERS = ("chunk_calls", "fused_calls", "batch_calls", "compactions",
            "admitted", "growths")
SCHED = ("sched_units_prefill", "sched_units_decode", "sched_units_admit",
         "sched_units_compact", "sched_units_spec", "sched_units_score",
         "sched_deadline_preempts", "sched_pages_deferred",
         "sched_adapters_deferred", "sched_tenant_pages_deferred",
         "sched_tenant_adapters_deferred", "sched_batches_live_max",
         "sched_lane_stall_max")


@pytest.fixture(scope="module")
def weights():
    """N(0, 0.3) matrices from a seed, zero biases, unit LayerNorm
    scales: each prompt streams its own tokens."""
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        fill = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return np.full(s.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax(weights, sched=2):
    return JaxEngine(JaxGpt(**CFG), jax.tree.map(jnp.asarray, weights),
                     tokenizer=JaxByteTokenizer(), prompt_buckets=BUCKETS,
                     chunk=8, max_wait_ms=0.0, kv_page_size=16,
                     kv_pages=POOL_PAGES, sched_max_batches=sched)


def _port(weights, page, sched=2, **kw):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights))
    model.configure(decode_attn_impl="flash")
    return TextGenerationEngine(
        model, tokenizer=ByteTokenizer(), prompt_buckets=BUCKETS,
        max_wait_ms=0.0, kv_page_size=page,
        kv_pages=POOL_PAGES if page else None, sched_max_batches=sched,
        **kw)


def _counts(eng, names=COUNTERS) -> dict:
    return {k: getattr(eng, k) for k in names}


def _sync(eng, sink_cls):
    """Each batch of ``BATCHES`` formed on the caller's thread (a staged
    joiner admitted at a boundary); returns the streams and the counters
    after each batch."""
    streams, counts = [], []
    for spec in BATCHES:
        sinks, staged = [], []
        for text, n, stream, *join in spec:
            req = eng._encode(text, n, 0.0, 0, None, stream=stream)
            sink = sink_cls(req, [])
            (staged if join else sinks).append(sink)
        everyone = sinks + staged   # admission appends to ``sinks``
        eng._admit[:] = staged
        eng._run_batch(sinks, admit=bool(staged))
        assert not eng._admit
        for s in everyone:
            assert s.error is None, s.error
        streams.append([s._out for s in everyone])
        counts.append(_counts(eng))
    return streams, counts


async def _collect(req):
    out: list[int] = []
    while (item := await req.queue.get()) is not None:
        assert not isinstance(item, Exception), item
        out.extend(item["token_ids"])
    return out


async def _groups(eng, fl):
    """Both groups queued with no await between them; the first
    formation waits 0.3 s at its ``sched_unit`` point, so the second
    group is pending before any unit runs."""
    await eng.start()
    loop = asyncio.get_running_loop()
    try:
        fl.arm("sched_unit:delay=0.3:times=1")
        before = _counts(eng, COUNTERS + SCHED)
        reqs = [eng._encode(text, n, 0.0, 0, loop, stream=stream)
                for group in GROUPS for text, n, stream in group]
        for r in reqs:
            eng._queue.put_nowait(r)
        outs = await asyncio.gather(*map(_collect, reqs))
        while not eng.sched.idle:
            await asyncio.sleep(0.005)
        after = _counts(eng, COUNTERS + SCHED)
        return outs, {k: after[k] - before[k] for k in after}
    finally:
        fl.disarm()
        await eng.stop()


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's sync trace, then its scheduler runs at 1 and 2
    lanes."""
    eng = _jax(weights)
    streams, counts = _sync(eng, JaxSink)
    sched = {n: asyncio.run(_groups(_jax(weights, n), jfaults))
             for n in (1, 2)}
    return streams, counts, sched


def test_reference_trace_exercises_every_width(reference):
    streams, counts, sched = reference
    wide, join, mixed = counts[0], counts[1], counts[2]
    # WIDE: 64-wide chunks (the cap) after the first token, the short
    # rows done after the first, then a compaction and the last 64.
    assert wide["fused_calls"] == 1 and wide["chunk_calls"] == 2
    assert wide["compactions"] == 1
    # JOIN: admitted at the first boundary (the batch grows), the
    # streaming joiner's 9 tokens take two plain chunks, then one
    # 32-wide chunk finishes the 40-token rows.
    assert join["fused_calls"] == 2 and join["admitted"] == 1
    assert join["growths"] == 1
    assert join["chunk_calls"] - wide["chunk_calls"] == 3
    # MIXED: a streaming row at formation pins the plain chunk: 39
    # tokens in five 8-wide chunks.
    assert mixed["fused_calls"] == 2
    assert mixed["chunk_calls"] - join["chunk_calls"] == 5
    for batch, got in zip(BATCHES, streams):
        assert [len(s) for s in got] == [n for _, n, *_ in batch]
    outs1, d1 = sched[1]
    outs2, d2 = sched[2]
    assert outs1 == outs2
    assert [len(o) for o in outs1] == [n for g in GROUPS for _, n, _ in g]
    # 2 fused chunks and 3 plain ones (the streaming group's 23 tokens).
    assert d1["fused_calls"] == d2["fused_calls"] == 1
    assert d1["chunk_calls"] == d2["chunk_calls"] == 5
    assert d1["sched_batches_live_max"] == 1
    assert d2["sched_batches_live_max"] == 2
    assert d2["sched_lane_stall_max"] >= 1


@pytest.mark.parametrize("page", [None, 16])
def test_sync_streams_and_counters_equal_jax(weights, reference, page):
    want_streams, want_counts, _ = reference
    got_streams, got_counts = _sync(_port(weights, page), _SyncSink)
    assert got_streams == want_streams
    assert got_counts == want_counts


@pytest.mark.parametrize("page", [None, 16])
@pytest.mark.parametrize("lanes", [1, 2])
def test_scheduler_streams_and_sched_counters_equal_jax(
        weights, reference, lanes, page):
    want_outs, want = reference[2][lanes]
    outs, got = asyncio.run(_groups(_port(weights, page, lanes), faults))
    assert outs == want_outs
    assert got == want


def test_plain_chunk_pinned_by_fused_single_false(weights, reference):
    """``fused_single=False`` (what the other parity files pin) gives
    the same streams through plain chunks and no fused run."""
    eng = _port(weights, 16, fused_single=False)
    streams, counts = _sync(eng, _SyncSink)
    assert streams == reference[0]
    assert counts[-1]["fused_calls"] == 0
    assert counts[-1]["chunk_calls"] > reference[1][-1]["chunk_calls"]
    c, g = {}, {}
    _generate_metrics(eng, c, g)
    assert c["generate.fused_calls"] == 0
    assert c["generate.chunk_calls"] == counts[-1]["chunk_calls"]


@pytest.mark.parametrize("chunk,default,cap", [
    (8, 32, None), (8, 20, 200), (16, 32, 40), (4, 8, 100), (8, 100, None)])
def test_width_policy_equals_jax(chunk, default, cap):
    """``tiers``, ``chunk_width`` and ``width_at`` against JAX's
    ``FusedSinglePath`` over one engine stand-in: budgets around every
    rung, streaming rows at formation and live, rows part-way done."""
    def engine(cls):
        eng = types.SimpleNamespace(
            chunk=chunk, default_max_new_tokens=default,
            fused_single=True, _strict_admit=False,
            fused_max_new=cap if cap is not None else max(64, default))
        tier = chunk
        while tier < default:
            tier *= 2
        eng.default_tier = tier
        return cls(eng)

    mine, ref = engine(FusedSinglePath), engine(JaxFused)
    assert mine.tiers() == ref.tiers()
    for n_max in (1, chunk, chunk + 1, default, 2 * default, 500):
        for stream in (False, True):
            reqs = [types.SimpleNamespace(n_new=n_max, stream=stream),
                    types.SimpleNamespace(n_new=max(1, n_max // 3),
                                          stream=False)]
            run = types.SimpleNamespace(reqs=reqs, n_new_max=n_max,
                                        sched=[0, 0], b_cur=2, total=0)
            run.fused_w = ref.chunk_width(run)
            assert mine.chunk_width(run) == run.fused_w
            for done in (0, 1, n_max // 2, n_max - 1):
                run.sched = [done, min(done, reqs[1].n_new - 1)]
                for live in ([0], [1], [0, 1]):
                    assert (mine.width_at(run, live)
                            == ref.width_at(run, live)), (n_max, done, live)
    off = types.SimpleNamespace(chunk=8, fused_single=False)
    assert FusedSinglePath(off).chunk_width(
        types.SimpleNamespace(reqs=[])) == 0
