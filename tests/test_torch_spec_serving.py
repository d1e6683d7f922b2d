"""The port's speculative serving on the CPU, against the JAX package's
engine.

The small GPT of the scheduler tests (vocab 260, hidden 32, 2 layers, 4
heads, 160 positions, float32), its weights drawn from a numpy seed,
and a draft of the same shape whose weights are the target's plus
N(0, 0.02) noise (it agrees often, not always). Both packages serve the
pair with ``spec_k=3`` and 2-token chunks; on the CPU the flash impl
runs the kernels' plain versions. One JAX engine (paged 16) serves one
trace, once per module:

- a solo greedy row, two- and three-row greedy batches (batched
  speculation and its realign handoff: one page-multiple shift, a host
  table edit, and one sub-page repack), a long solo row;
- a batch handed off mid-phase (``_spec_should_yield`` patched to yield
  after three calls), its rows at different positions;
- a lone row that re-engages after a staged joiner was admitted and
  finished (its history replays into a fresh draft cache);
- the declines: a prefix row, an adapter row, a sampled row without
  ``spec_sample``, and a batch under brownout (the fleet backlog set to
  the queue bound).

The port serves the same trace paged 16 (flash and einsum) and
contiguous (flash): every stream equals the port's draft-less engine's
and, but for the sampled row (each package draws from its own
generators), the JAX engine's; and every ``spec_*`` counter equals the JAX
engine's (the realign routes are paged-only, 0 contiguous). Through the
unit scheduler at ``sched_max_batches`` 1 and 2, groups submitted one
after another give the same streams and counters, ``sched_units_spec``
included. Port-only: ``spec_sample`` speculates sampled solo rows
(deterministic per seed; draft == target accepts every proposal), the
engine's argument checks, ``from_checkpoint(draft_checkpoint=)``, the
CLI flags and the ``/metrics`` keys.
"""

import asyncio
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.requests import _SyncSink as JaxSink
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving.__main__ import build_engine, parse_args
from mlapi_tpu_torch.serving.app import _generate_metrics
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
K = 3
SPEC = ("spec_rounds", "spec_drafted", "spec_accepted",
        "spec_realign_table_ops", "spec_realign_repacks",
        "brownout_spec_suppressed")
PREFIX = "You are terse. "
RANK = 2

# (kind, requests): each request (text, n_new, temperature, prefix,
# adapter). "plain" groups run as one formed batch; "yield" with the
# yield seam patched; "rejoin" with a joiner staged before formation;
# "brownout" under rung 1.
G = lambda text, n, temp=0.0, prefix=None, adapter=None: (  # noqa: E731
    text, n, temp, prefix, adapter)
TRACE = (
    ("plain", (G("hello world", 20),)),
    ("plain", (G("abc", 5), G("xyzzy plugh", 21))),
    ("plain", (G("one", 12), G("two three", 5), G("four", 9))),
    ("plain", (G("q" * 40, 30),)),
    ("yield", (G("left", 24), G("right side", 24))),
    ("rejoin", (G("a lone row", 28), G("joiner", 4))),
    ("plain", (G("with a prefix", 10, prefix=PREFIX),)),
    ("plain", (G("tenant row", 10, adapter="t1"),)),
    ("plain", (G("sampled", 10, temp=0.8),)),
    ("brownout", (G("pressure", 10), G("more pressure", 8))),
)
# The groups the scheduler runs: a solo row and a batch.
SCHED_TRACE = (TRACE[0], TRACE[2])
SAMPLED = 8  # the sampled group's index: its bytes are each package's own


def _draw(seed, base=None, scale=0.3):
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) >= 2:
            return (scale * rng.standard_normal(s.shape)).astype(np.float32)
        fill = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return np.full(s.shape, fill, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    if base is not None:
        tree = jax.tree.map(lambda b, n: b + n if n.ndim >= 2 else b,
                            base, tree)
    return tree


@pytest.fixture(scope="module")
def weights():
    target = _draw(0)
    return target, _draw(1, base=target, scale=0.02)


@pytest.fixture(scope="module")
def adapter(weights):
    rng = np.random.default_rng(5)
    payload: dict = {}
    for n in range(CFG["num_layers"]):
        ln = f"layer_{n}"
        for t in ("qkv", "attn_out", "ffn_up", "ffn_down"):
            d_in, d_out = weights[0][ln][t]["kernel"].shape
            payload.setdefault(ln, {})[t] = {
                "a": (0.3 * rng.standard_normal((d_in, RANK))).astype(
                    np.float32),
                "b": (0.3 * rng.standard_normal((RANK, d_out))).astype(
                    np.float32),
            }
    return payload


def _jax(weights, adapter):
    eng = JaxEngine(
        JaxGpt(**CFG), jax.tree.map(jnp.asarray, weights[0]),
        tokenizer=JaxByteTokenizer(), fused_single=False, max_wait_ms=0.0,
        kv_page_size=16, chunk=2, spec_k=K, adapter_slots=2,
        draft=(JaxGpt(**CFG), jax.tree.map(jnp.asarray, weights[1])),
    )
    eng.register_adapter("t1", adapter)
    return eng


def _model(tree, impl):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    model.configure(decode_attn_impl=impl)
    return model


def _port(weights, adapter, page=16, impl="flash", draft=True, **kw):
    eng = TextGenerationEngine(
        _model(weights[0], impl), tokenizer=ByteTokenizer(),
        max_wait_ms=0.0, kv_page_size=page, chunk=2, spec_k=K,
        adapter_slots=2, fused_single=False,   # as the JAX engine here
        draft=_model(weights[1], impl) if draft else None, **kw,
    )
    eng.register_adapter("t1", adapter)
    return eng


def _counters(eng) -> dict:
    return {c: getattr(eng, c) for c in SPEC}


@contextlib.contextmanager
def _seam(eng, kind):
    """The group's condition: the yield seam patched to yield after
    three calls, or brownout rung 1 through the fleet backlog."""
    if kind == "yield":
        calls = {"n": 0}
        real = eng._spec_should_yield

        def yield_after_three():
            calls["n"] += 1
            return calls["n"] > 3 or real()

        eng._spec_should_yield = yield_after_three
    if kind == "brownout":
        eng.router_queue_depth = eng.max_queue
    try:
        yield
    finally:
        eng.__dict__.pop("_spec_should_yield", None)
        eng.router_queue_depth = 0


def _sync_trace(eng, sink_cls, trace=TRACE):
    """Each group as one formed batch on the caller's thread; returns
    (streams per group, counters after each group)."""
    streams, counts = [], []
    for kind, group in trace:
        sinks = []
        for text, n, temp, prefix, aid in group:
            req = eng._encode(text, n, temp, 7, None, prefix=prefix,
                              adapter=aid)
            sinks.append(sink_cls(req, []))
        formed, staged = (sinks[:1], sinks[1:]) if kind == "rejoin" else \
            (sinks, [])
        eng._admit[:] = staged
        with _seam(eng, kind):
            eng._run_batch(formed, admit=bool(staged))
        assert not eng._admit
        for s in sinks:
            assert s.error is None, s.error
        streams.append([s._out for s in sinks])
        counts.append(_counters(eng))
    return streams, counts


async def _sched_trace(eng):
    """Each group queued at once (one formed batch) through the unit
    scheduler, once the previous group's lane has retired (else the
    collector would stage it as joiners of that lane)."""
    await eng.start()
    loop = asyncio.get_running_loop()
    try:
        streams = []
        for _, group in SCHED_TRACE:
            reqs = [eng._encode(text, n, 0.0, 0, loop, stream=True)
                    for text, n, *_ in group]
            for r in reqs:
                eng._queue.put_nowait(r)
            outs = []
            for r in reqs:
                out = []
                while (item := await r.queue.get()) is not None:
                    assert not isinstance(item, Exception), item
                    out.extend(item["token_ids"])
                outs.append(out)
            streams.append(outs)
            while eng.sched.batches_live:
                await asyncio.sleep(0.005)
        return streams, {**_counters(eng),
                         "sched_units_spec": eng.sched_units_spec}
    finally:
        await eng.stop()


@pytest.fixture(scope="module")
def reference(weights, adapter):
    """The JAX engine's streams and counters over the trace, then its
    scheduler run."""
    eng = _jax(weights, adapter)
    streams, counts = _sync_trace(eng, JaxSink)
    base = {**_counters(eng), "sched_units_spec": eng.sched_units_spec}
    s_streams, s_counts = asyncio.run(_sched_trace(eng))
    delta = {c: s_counts[c] - base[c] for c in s_counts}
    return streams, counts, s_streams, delta


def test_reference_trace_exercises_every_path(reference):
    streams, counts, _, _ = reference
    last = counts[-1]
    # Speculation engaged with partial acceptance, both realign routes
    # ran, and the brownout group counted one suppression a run.
    assert 0 < last["spec_accepted"] < last["spec_drafted"]
    assert last["spec_realign_table_ops"] >= 1
    assert last["spec_realign_repacks"] >= 1
    assert last["brownout_spec_suppressed"] == 1
    # The declined groups (prefix, adapter, sampled, brownout) ran no
    # round.
    for i in (6, 7, 8, 9):
        assert counts[i]["spec_rounds"] == counts[i - 1]["spec_rounds"]
    # The yield and rejoin groups speculated.
    for i in (4, 5):
        assert counts[i]["spec_rounds"] > counts[i - 1]["spec_rounds"]
    assert [len(s) for s in streams[5]] == [28, 4]


@pytest.mark.parametrize("page,impl", [(16, "flash"), (16, "einsum"),
                                       (None, "flash")],
                         ids=["paged-flash", "paged-einsum",
                              "contiguous-flash"])
def test_streams_and_counters_equal_jax(reference, weights, adapter, page,
                                        impl):
    want_streams, want_counts, _, _ = reference
    eng = _port(weights, adapter, page, impl)
    streams, counts = _sync_trace(eng, _SyncSink)
    # The sampled group draws from the port's own generators.
    assert streams[:SAMPLED] + streams[SAMPLED + 1:] == \
        want_streams[:SAMPLED] + want_streams[SAMPLED + 1:]
    plain_eng = _port(weights, adapter, page, impl, draft=False)
    plain, _ = _sync_trace(plain_eng, _SyncSink)
    assert streams == plain
    for got, want in zip(counts, want_counts):
        if page is None:
            # A contiguous cache realigns by one roll: no table op, no
            # repack.
            want = {**want, "spec_realign_table_ops": 0,
                    "spec_realign_repacks": 0}
        assert got == want
    if page is not None:
        # Every row's pages came back: what stays is the prefix entry's.
        assert eng.kv_pages_in_use == plain_eng.kv_pages_in_use == 1


@pytest.mark.parametrize("sched", [1, 2])
def test_scheduler_runs_spec_units_as_jax(reference, weights, adapter,
                                          sched):
    _, _, want_streams, want = reference
    assert want["sched_units_spec"] >= 2 and want["spec_rounds"] > 0
    eng = _port(weights, adapter, sched_max_batches=sched)
    streams, got = asyncio.run(_sched_trace(eng))
    assert streams == want_streams
    assert got == want


def test_spec_sample_speculates_sampled_solo_rows(weights, adapter):
    eng = _port(weights, adapter, spec_sample=True)
    runs = [eng.generate_text("sampled", max_new_tokens=16,
                              temperature=0.8, seed=s, top_k=40,
                              top_p=0.95)["token_ids"]
            for s in (3, 3, 4)]
    assert eng.spec_rounds > 0
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(len(r) == 16 for r in runs)
    # Draft == target: p/q is exactly 1, every proposal accepted, k + 1
    # tokens a full round.
    same = TextGenerationEngine(
        _model(weights[0], "flash"), tokenizer=ByteTokenizer(),
        kv_page_size=16, chunk=2, spec_k=K, spec_sample=True,
        draft=_model(weights[0], "flash"))
    out = same.generate_text("sampled", max_new_tokens=17, temperature=0.8,
                             seed=3)["token_ids"]
    assert len(out) == 17
    assert same.spec_accepted == same.spec_drafted == 4 * K
    assert same.spec_rounds == 4


def test_engine_checks_and_from_checkpoint(weights, tmp_path):
    small = dict(CFG, max_positions=128)
    with pytest.raises(ValueError, match="share a vocabulary"):
        TextGenerationEngine(_model(weights[0], "einsum"),
                             tokenizer=ByteTokenizer(),
                             draft=GptLM(**dict(CFG, vocab_size=300),
                                         device="cpu"))
    with pytest.raises(ValueError, match=r"draft window \(128\) must cover "
                                         r"the target's \(160\)"):
        TextGenerationEngine(_model(weights[0], "einsum"),
                             tokenizer=ByteTokenizer(),
                             draft=GptLM(**small, device="cpu"))
    tok = ByteTokenizer().fingerprint()
    paths = {}
    for name, tree, fp in (("target", weights[0], tok),
                           ("draft", weights[1], tok),
                           ("other", weights[1], {"kind": "other"})):
        paths[name] = save_checkpoint(
            tmp_path / name, params_from_jax(tree),
            config={"model": "gpt_lm", "model_kwargs": CFG,
                    "tokenizer": fp})
    eng = build_engine(paths["target"], device="cpu", kv_quant="int8",
                       decode_attn_impl="flash", kv_page_size=16,
                       draft_checkpoint=paths["draft"], spec_sample=True)
    assert eng.meta["draft"] == str(paths["draft"])
    assert eng.spec_sample and eng.spec_k == 4
    assert (eng.draft_model.kv_quant, eng.draft_model.decode_attn_impl) == (
        "int8", "flash")
    eng.warmup()
    assert len(eng.generate_text("hi", max_new_tokens=8)["token_ids"]) == 8
    assert eng.spec_rounds > 0
    with pytest.raises(ValueError, match="different tokenizer"):
        TextGenerationEngine.from_checkpoint(
            paths["target"], device="cpu", draft_checkpoint=paths["other"])


def test_cli_flags_and_metrics_keys(weights, adapter):
    args = parse_args(["--checkpoint", "t", "--draft-checkpoint", "d",
                       "--spec-sample"])
    assert (args.draft_checkpoint, args.spec_sample) == ("d", True)
    args = parse_args(["--checkpoint", "t"])
    assert (args.draft_checkpoint, args.spec_sample) == (None, False)
    eng = _port(weights, adapter)
    eng.generate_text("hello world", max_new_tokens=12)
    c, g = {}, {}
    _generate_metrics(eng, c, g)
    for name in (*SPEC, "sched_units_spec"):
        assert c[f"generate.{name}"] == getattr(eng, name)
    assert c["generate.spec_rounds"] > 0
