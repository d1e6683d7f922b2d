"""The port's unit scheduler on the CPU, against the JAX package's engine.

The small GPT of ``tests/test_scheduler.py`` (vocab 260, hidden 32, 2
layers, 4 heads, 160 positions, float32), its weights drawn from a numpy
seed, serves in both packages. On the CPU the flash impl runs the
kernels' plain versions. Requests are queued before the collector first
runs, so both engines form the same groups.

- Two window-incompatible groups (a 16-token prompt with 34 new tokens
  beside a sampled request, and a 100-token prompt with 8) through one
  JAX engine at ``sched_max_batches=2`` and through the port at 1 and 2,
  contiguous and paged 16, einsum and flash: greedy streams equal the
  JAX engine's; ``sched_units_prefill``, ``sched_batches_live_max`` and
  the pages resident after the run are exact; at 2 the trace switches
  lanes at least twice; the sampled stream is the same at 1 and 2.
- Pending groups start in deadline-slack order, the order the JAX
  engine starts them in.
- A pool too small for two worst cases defers the second lane:
  ``sched_pages_deferred`` equals the JAX engine's and both finish.
- A long joiner of a paged batch is prefilled between decode chunks: its
  stream, ``prefill_chunks`` and ``interleaved_prefills`` equal the JAX
  engine's (a contiguous batch admits it in one prefill, same stream).
- The port's own contracts: a ``sched_unit`` raise kills one lane only
  with its pages back; a deadline expires at a unit boundary; an
  infeasible deadline is a 503 with retry-after; drain covers the
  scheduler's queue and ``/healthz`` reads draining; the brownout rungs
  clamp budgets and evict an idle prefix page set; lanes run under
  inference mode; spec units count, a kind no lane yields is refused by
  name.
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

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.serving import faults as jfaults
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.__main__ import parse_args
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.requests import DeadlineExceeded, DrainCancelled
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
# Never one window: 128 + 34 > 160, while each alone fits.
SHORT = ("hello world", 34)
LONG = ("x" * 100, 8)
# (text, n_new, temperature, seed, top_k, top_p): batches with SHORT.
SAMPLED = ("sample me", 12, 0.8, 7, 20, 0.9)


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


def _jax(weights, page=16, **kw):
    kw.setdefault("chunk", 2)
    return JaxEngine(JaxGpt(**CFG), jax.tree.map(jnp.asarray, weights),
                     tokenizer=JaxByteTokenizer(), fused_single=False,
                     max_wait_ms=0.0, kv_page_size=page, **kw)


def _port(weights, page=16, impl="flash", sched=2, **kw):
    kw.setdefault("chunk", 2)
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights))
    model.configure(decode_attn_impl=impl)
    # The plain chunk, as the JAX engine here is pinned.
    return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                max_wait_ms=0.0, kv_page_size=page,
                                sched_max_batches=sched, fused_single=False,
                                **kw)


async def _collect(req):
    """(tokens, terminal error or None)."""
    out: list[int] = []
    while True:
        item = await req.queue.get()
        if item is None:
            return out, None
        if isinstance(item, Exception):
            return out, item
        out.extend(item["token_ids"])


async def _wait_for(pred, timeout_s: float = 60.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not pred():
        assert loop.time() < deadline, "condition never became true"
        await asyncio.sleep(0.005)


def _enqueue(eng, specs):
    """Encode and queue every request with no await between them, so
    the collector's first pop sees them all."""
    loop = asyncio.get_running_loop()
    reqs = [eng._encode(text, n, temp, seed, loop, top_k, top_p,
                        stream=True)
            for text, n, temp, seed, top_k, top_p in specs]
    for r in reqs:
        eng._queue.put_nowait(r)
    return reqs


def _switches(trace) -> int:
    lanes = [lane for lane, _ in trace]
    return sum(a != b for a, b in zip(lanes, lanes[1:]))


async def _two_groups(eng):
    await eng.start()
    try:
        reqs = _enqueue(eng, [(*SHORT, 0.0, 0, 0, 1.0), SAMPLED,
                              (*LONG, 0.0, 0, 0, 1.0)])
        outs = await asyncio.gather(*map(_collect, reqs))
        assert [e for _, e in outs] == [None] * 3
        await _wait_for(lambda: eng.kv_pages_in_use == 0)
        counts = {k: getattr(eng, k) for k in (
            "sched_units_prefill", "sched_batches_live_max",
            "kv_pages_in_use")}
        return [t for t, _ in outs], counts, list(eng.sched.trace)
    finally:
        await eng.stop()


def test_two_groups_streams_and_counts_equal_jax(weights):
    (want_a, _, want_b), want, jtrace = asyncio.run(
        _two_groups(_jax(weights, sched_max_batches=2)))
    assert len(want_a) == SHORT[1] and len(want_b) == LONG[1]
    assert want == {"sched_units_prefill": 2, "sched_batches_live_max": 2,
                    "kv_pages_in_use": 0}
    assert _switches(jtrace) >= 2
    for page in (None, 16):
        for impl in ("einsum", "flash"):
            sampled = []
            for sched in (1, 2):
                (a, s, b), got, trace = asyncio.run(
                    _two_groups(_port(weights, page, impl, sched)))
                where = (page, impl, sched)
                assert (a, b) == (want_a, want_b), where
                assert got == {**want, "sched_batches_live_max": sched}, \
                    where
                if sched == 2:
                    assert _switches(trace) >= 2, (where, trace)
                assert len(s) == SAMPLED[1] and s != a[:len(s)], where
                sampled.append(s)
            # The sampled row formed the same batch in both modes.
            assert sampled[0] == sampled[1], (page, impl)


async def _slack_order(eng, fl):
    """A blocker holds the one lane; group A (loose deadline) then group
    B (tight), both window-incompatible with it, queue behind it.
    Returns the order the two finish in."""
    await eng.start()
    try:
        order: list[str] = []

        async def tagged(req, tag):
            out = await _collect(req)
            order.append(tag)
            return out

        fl.arm("decode:every=1:delay=0.05")
        blocker = await eng.submit("hold", max_new_tokens=40, stream=True)
        await _wait_for(lambda: eng.sched_batches_live == 1)
        ra = await eng.submit("a" * 100, max_new_tokens=24, stream=True,
                              deadline_ms=120000.0)
        await _wait_for(lambda: eng.sched.backlog >= 1)
        rb = await eng.submit(LONG[0], max_new_tokens=8, stream=True,
                              deadline_ms=60000.0)
        await _wait_for(lambda: eng.sched.backlog >= 2)
        outs = await asyncio.gather(_collect(blocker), tagged(ra, "A"),
                                    tagged(rb, "B"))
        assert [e for _, e in outs] == [None] * 3
        return order
    finally:
        fl.disarm()
        await eng.stop()


def test_pending_groups_start_in_deadline_slack_order(weights):
    want = asyncio.run(_slack_order(_jax(weights, sched_max_batches=1),
                                    jfaults))
    assert want == ["B", "A"]
    got = asyncio.run(_slack_order(_port(weights, sched=1), faults))
    assert got == want


async def _page_budget(eng, fl):
    """15 usable 8-token pages: lane A (16 + 32 slots: 6 pages) runs;
    B (16 + 64 slots: 10 pages) is handed back by A's admission (its
    budget overruns A's cache), then waits for the page budget."""
    await eng.start()
    try:
        fl.arm("decode:every=1:delay=0.02")
        ra = await eng.submit("hold", max_new_tokens=30, stream=True)
        await _wait_for(lambda: eng.sched_batches_live == 1)
        rb = await eng.submit("bbbb", max_new_tokens=64, stream=True)
        (ta, ea), (tb, eb) = await asyncio.gather(_collect(ra),
                                                  _collect(rb))
        assert ea is None and eb is None
        assert (len(ta), len(tb)) == (30, 64)
        await _wait_for(lambda: eng.kv_pages_in_use == 0)
        return eng.sched_pages_deferred
    finally:
        fl.disarm()
        await eng.stop()


def test_page_budget_defers_the_second_lane(weights):
    want = asyncio.run(_page_budget(
        _jax(weights, page=8, kv_pages=16, sched_max_batches=2), jfaults))
    assert want == 1
    got = asyncio.run(_page_budget(
        _port(weights, page=8, kv_pages=16, sched=2), faults))
    assert got == want


# Buckets 8/16: a 40-byte joiner rounds up to 48, three 16-wide chunks.
IL_BUCKETS = (8, 16)
IL_LANE = ("hold the lane", 64)
IL_JOINER = ("a long joiner prefills between decode chunks"[:40], 8)


async def _interleaved(eng, fl):
    await eng.start()
    try:
        fl.arm("decode:every=1:delay=0.05")
        lane = await eng.submit(IL_LANE[0], max_new_tokens=IL_LANE[1],
                                stream=True)
        first = await lane.queue.get()
        joiner = await eng.submit(IL_JOINER[0], max_new_tokens=IL_JOINER[1],
                                  stream=True)
        (tl, el), (tj, ej) = await asyncio.gather(_collect(lane),
                                                  _collect(joiner))
        assert el is None and ej is None
        await _wait_for(lambda: eng.kv_pages_in_use == 0)
        counts = {k: getattr(eng, k) for k in (
            "prefill_chunks", "interleaved_prefills", "batch_calls")}
        return first["token_ids"] + tl, tj, counts
    finally:
        fl.disarm()
        await eng.stop()


def test_long_joiner_prefills_between_decode_chunks(weights):
    want_l, want_j, want = asyncio.run(_interleaved(
        _jax(weights, chunk=8, prompt_buckets=IL_BUCKETS), jfaults))
    assert len(want_l) == IL_LANE[1] and len(want_j) == IL_JOINER[1]
    # One batch: the joiner's three chunks ran inside the lane.
    assert want == {"prefill_chunks": 3, "interleaved_prefills": 1,
                    "batch_calls": 1}
    for page, impl in ((16, "einsum"), (16, "flash"), (None, "flash")):
        lane, joiner, got = asyncio.run(_interleaved(
            _port(weights, page, impl, chunk=8, prompt_buckets=IL_BUCKETS),
            faults))
        assert (lane, joiner) == (want_l, want_j), (page, impl)
        if page:
            assert got == want, impl
        else:
            # A contiguous batch admits it in one prefill.
            assert got == {"prefill_chunks": 0, "interleaved_prefills": 0,
                           "batch_calls": 1}


# -- the port's own contracts ------------------------------------------


def test_sched_unit_raise_kills_one_lane_only(weights):
    async def run():
        eng = _port(weights)
        await eng.start()
        try:
            pair = [(*SHORT, 0.0, 0, 0, 1.0), (*LONG, 0.0, 0, 0, 1.0)]
            ref = await asyncio.gather(*map(_collect, _enqueue(eng, pair)))
            await _wait_for(lambda: eng.kv_pages_in_use == 0)
            # Both lanes formed (units 1-2); a later unit raises.
            faults.arm("sched_unit:after=6:raise")
            outs = await asyncio.gather(*map(_collect, _enqueue(eng, pair)))
            errs = [e for _, e in outs if e is not None]
            assert len(errs) == 1 and isinstance(errs[0],
                                                 faults.InjectedFault)
            for (t, e), (want, _) in zip(outs, ref):
                if e is None:
                    assert t == want  # the other lane streamed on
            faults.disarm()
            await _wait_for(lambda: eng.sched.idle)
            await _wait_for(lambda: eng.kv_pages_in_use == 0)
            toks, err = await _collect(await eng.submit("after",
                                                        max_new_tokens=4))
            assert err is None and len(toks) == 4
        finally:
            faults.disarm()
            await eng.stop()

    asyncio.run(run())


def test_deadline_expires_at_a_unit_boundary(weights):
    async def run():
        eng = _port(weights)
        await eng.start()
        try:
            faults.arm("decode:every=1:delay=0.03")
            req = await eng.submit("slow one", max_new_tokens=60,
                                   stream=True, deadline_ms=150.0)
            toks, err = await _collect(req)
            assert isinstance(err, DeadlineExceeded)
            assert err.code == "deadline_exceeded" and len(toks) < 60
            assert eng.deadline_expired_decode == 1
            faults.disarm()
            await _wait_for(lambda: eng.sched.idle)
            await _wait_for(lambda: eng.kv_pages_in_use == 0)
            toks, err = await _collect(await eng.submit("after",
                                                        max_new_tokens=4))
            assert err is None and len(toks) == 4
        finally:
            faults.disarm()
            await eng.stop()

    asyncio.run(run())


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def test_deadlines_drain_and_brownout_over_http(weights):
    """``deadline_ms`` is served; 0 is a 422; a deadline the estimate
    says cannot be met is a 503 with retry-after; a draining server
    sheds with a 503 and reads draining; queue pressure clamps a budget
    (rung 1) and evicts an idle prefix page set (rung 2)."""
    eng = _port(weights, max_queue=8)
    with BackgroundServer(build_app(eng)) as srv:
        out = _post(srv.port, {"text": "in time", "max_new_tokens": 4,
                               "deadline_ms": 60000})
        assert len(out["token_ids"]) == 4
        for bad in (0, -5):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, {"text": "x", "deadline_ms": bad})
            assert e.value.code == 422
            assert json.loads(e.value.read())["detail"][0]["loc"] == [
                "deadline_ms"]
        eng.latency.record_first(5000.0)  # a p95 TTFT of 5 s
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "x", "deadline_ms": 100})
        assert e.value.code == 503 and int(e.value.headers["retry-after"]) >= 1
        assert eng.shed_deadline_infeasible == 1
        # Rung 2 evicts an idle prefix page set: make one resident.
        _post(srv.port, {"text": " hi", "prefix": "a shared prefix",
                         "max_new_tokens": 2})
        assert eng.kv_pages_in_use > 0
        eng.router_queue_depth = 4          # half of max_queue: rung 1
        assert eng._brownout_level() == 1
        out = _post(srv.port, {"text": "clamp", "max_new_tokens": 40})
        assert len(out["token_ids"]) == eng.default_max_new_tokens
        assert eng.brownout_tokens_clamped == 1 and eng.kv_pages_in_use > 0
        eng.router_queue_depth = 6          # three quarters: rung 2
        out = _post(srv.port, {"text": "evict", "max_new_tokens": 2})
        assert eng.pool.entry_evictions == 1
        eng.router_queue_depth = 0
        metrics = _get(srv.port, "/metrics")
        assert metrics["counters"]["generate.brownout_tokens_clamped"] == 1
        assert metrics["counters"]["generate.shed_deadline_infeasible"] == 1
        assert metrics["gauges"]["generate.sched_batches_live_max"] == 1
        eng.draining = True
        assert _get(srv.port, "/healthz")["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "late"})
        assert e.value.code == 503 and "retry-after" in e.value.headers
        assert _get(srv.port, "/metrics")["counters"][
            "generate.shed_draining"] == 1
        eng.draining = False


def test_drain_covers_the_scheduler_queue(weights):
    async def run():
        eng = _port(weights, sched=1)
        await eng.start()
        try:
            faults.arm("decode:every=1:delay=0.05")
            blocker = await eng.submit(SHORT[0], max_new_tokens=60,
                                       stream=True)
            await _wait_for(lambda: eng.sched_batches_live == 1)
            pend = await eng.submit(LONG[0], max_new_tokens=8, stream=True)
            await _wait_for(lambda: eng.sched.backlog >= 1)
            gather = asyncio.gather(_collect(blocker), _collect(pend))
            await eng.drain(0.05)  # the budget runs out: the sweep
            (_, eb), (_, ep) = await gather
            assert eb is None or isinstance(eb, DrainCancelled)
            assert isinstance(ep, DrainCancelled)  # never laned
            await _wait_for(lambda: eng.sched.idle)
            await _wait_for(lambda: eng.kv_pages_in_use == 0)
        finally:
            faults.disarm()
            await eng.stop()

    asyncio.run(run())


def test_lanes_run_under_inference_mode(weights):
    eng = _port(weights)
    seen = []
    step = eng.model.decode_step

    def recording(*args, **kwargs):
        logits, cache = step(*args, **kwargs)
        seen.append((torch.is_inference_mode_enabled(), logits.grad_fn))
        return logits, cache

    eng.model.decode_step = recording

    async def run():
        await eng.start()
        try:
            reqs = _enqueue(eng, [(*SHORT, 0.0, 0, 0, 1.0),
                                  (*LONG, 0.0, 0, 0, 1.0)])
            outs = await asyncio.gather(*map(_collect, reqs))
            assert [e for _, e in outs] == [None, None]
        finally:
            await eng.stop()

    asyncio.run(run())
    assert seen and all(mode and fn is None for mode, fn in seen)


def test_unported_units_are_refused_by_name_and_flags_parse(weights):
    from mlapi_tpu_torch.serving.scheduler import UnitScheduler, _ScoreUnit

    from mlapi_tpu_torch.serving.scheduler import _Lane

    eng = _port(weights)
    sched = UnitScheduler(eng, max_batches=2)
    sched.stop()  # its dispatch thread must not race the calls below
    # Score units are served since the scoring slice: a stopped
    # scheduler refuses one as the JAX scheduler does, so its scoring
    # path falls back to worker threads.
    with pytest.raises(RuntimeError, match="scheduler stopped"):
        sched.submit_score(lambda: None, lambda e: None)
    assert _ScoreUnit(None, None, 3, None, None, 1.0).target == 0.005
    # Tenant quotas are served since Queue A item 5: without a ledger
    # the tenant term never blocks, as in the JAX scheduler.
    assert sched._tenant_block(None, 0) is None

    class Waiter:
        cancelled = False

        def __init__(self):
            self.frames = []

        def push(self, item):
            self.frames.append(item)

    class Run:
        reqs = [Waiter()]

        def units(self):
            # Spec units are served since Queue A item 6; a kind no
            # lane yields is refused by name.
            yield "spec"
            yield "bogus"

        def _paged_cleanup(self):
            pass

    run = Run()
    eng._wake_collector = lambda: None
    lane = _Lane(1, run, run.units(), 0)
    sched._lanes.append(lane)
    sched._advance(lane)
    assert lane in sched._lanes and eng.sched_units_spec == 1
    assert sched.trace[-1] == (1, "spec") and not run.reqs[0].frames
    sched._advance(lane)
    # The lane failed with an error naming the unit, and left.
    assert lane not in sched._lanes
    (err,) = run.reqs[0].frames
    assert isinstance(err, RuntimeError) and "'bogus'" in str(err)
    assert parse_args(["--checkpoint", "c"]).sched_max_batches == 2
    args = parse_args(["--checkpoint", "c", "--sched-max-batches", "1",
                       "--default-deadline-ms", "500",
                       "--no-admission-control", "--drain-timeout-s", "3"])
    assert (args.sched_max_batches, args.default_deadline_ms,
            args.admission_control, args.drain_timeout_s) == (1, 500.0,
                                                              False, 3.0)
    with pytest.raises(SystemExit):
        parse_args(["--checkpoint", "c", "--sched-max-batches", "0"])
