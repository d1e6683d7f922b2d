"""Score units on the port's unit scheduler, against the JAX package.

A classifier co-resident with a generative engine sends its formed
batches to that engine's ``UnitScheduler`` as typed ``score`` units.
The small GPT of ``tests/test_torch_scheduler.py`` (float32, paged 16)
and a linear Iris classifier, weights from a numpy seed, serve in both
packages:

- one trace (4 greedy prompts and 10 scoring rows queued with no await
  between them): ``sched_units_score``, ``sched_dispatches`` and
  ``device_calls`` equal the JAX engine's, every score unit ran on the
  scheduler, the labels equal the JAX path's, and the greedy streams
  equal the JAX engine's and the port's own without scoring;
- the score-vs-lane policy (``_claim_score``) decides as the JAX
  scheduler does: alternation without deadlines, least weighted slack
  with them, preemptions counted alike;
- no score unit builds an autograd graph, on either backend (the
  scheduler's dispatch thread, or a worker thread);
- a ``score_dispatch`` raise fails that batch only, and the streams
  finish;
- a multi-model app serves ``/models/<id>/predict`` and
  ``/models/<id>/generate``, lists its models in ``/healthz`` as the
  JAX registry describes them, and reads the one-scheduler identity in
  ``/metrics`` (``model.clf.sched_dispatches == model.clf.device_calls
  == model.default.sched_units_score``).
"""

import asyncio
import threading
import time
import types

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models import get_model as jax_model
from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.serving.engine import InferenceEngine as JaxEngine
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxGenEngine
from mlapi_tpu.serving.registry import ModelRegistry as JaxRegistry
from mlapi_tpu.serving.requests import LatencyStats as JaxLatency
from mlapi_tpu.serving.scheduler import UnitScheduler as JaxScheduler
from mlapi_tpu.serving.scheduler import _ScoreUnit as JaxScoreUnit
from mlapi_tpu.serving.scoring import ScorePath as JaxScorePath
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu.utils.vocab import LabelVocab as JaxVocab
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import InferenceEngine
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.registry import ModelRegistry
from mlapi_tpu_torch.serving.requests import LatencyStats
from mlapi_tpu_torch.serving.scheduler import UnitScheduler, _ScoreUnit
from mlapi_tpu_torch.serving.scoring import ScorePath
from mlapi_tpu_torch.text import ByteTokenizer
from mlapi_tpu_torch.utils.vocab import LabelVocab

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
PROMPTS = [("hello world", 12), ("score units", 10), ("x" * 30, 8),
           ("lanes", 12)]
IRIS = ("sepal_length", "sepal_width", "petal_length", "petal_width")
LABELS = ("Iris-setosa", "Iris-versicolor", "Iris-virginica")


@pytest.fixture(scope="module")
def weights():
    """The GPT's N(0, 0.3) matrices from a seed, zero biases, unit
    LayerNorm scales; the classifier's ``w``/``b``; 10 feature rows."""
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        fill = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return np.full(s.shape, fill, np.float32)

    gpt = jax.tree_util.tree_map_with_path(draw, shapes)
    clf = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
           "b": rng.normal(0, 0.5, (3,)).astype(np.float32)}
    rows = rng.normal(0, 2, (10, 4)).astype(np.float32)
    return gpt, clf, rows


def _jax_pair(weights):
    gpt, clf, _ = weights
    gen = JaxGenEngine(JaxGpt(**CFG), jax.tree.map(jnp.asarray, gpt),
                       tokenizer=JaxByteTokenizer(), fused_single=False,
                       max_wait_ms=0.0, kv_page_size=16, chunk=2)
    cls = JaxEngine(jax_model("linear", num_features=4, num_classes=3),
                    jax.tree.map(jnp.asarray, clf), JaxVocab(LABELS), IRIS,
                    buckets=(1, 2, 4))
    return gen, cls, JaxScorePath


def _port_gen(weights):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights[0]))
    model.configure(decode_attn_impl="flash")
    # The plain chunk, as the JAX engine here is pinned.
    return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                max_wait_ms=0.0, kv_page_size=16, chunk=2,
                                fused_single=False)


def _port_clf(weights, trainable=False):
    model = get_model("linear", num_features=4, num_classes=3, device="cpu")
    model.load_state_dict(params_from_jax(weights[1]))
    model.requires_grad_(trainable)
    return InferenceEngine(model, LabelVocab(LABELS), IRIS,
                           buckets=(1, 2, 4))


def _port_pair(weights):
    return _port_gen(weights), _port_clf(weights), ScorePath


async def _collect(req):
    out: list[int] = []
    while True:
        item = await req.queue.get()
        if item is None:
            return out
        if isinstance(item, Exception):
            return item
        out.extend(item["token_ids"])


def _enqueue(eng, specs):
    """Encode and queue every prompt with no await between them."""
    loop = asyncio.get_running_loop()
    reqs = [eng._encode(text, n, 0.0, 0, loop, 0, 1.0, stream=True)
            for text, n in specs]
    for r in reqs:
        eng._queue.put_nowait(r)
    return reqs


async def _trace(gen, clf, path_cls, rows, scoring=True, fault=None):
    """The prompts and (with ``scoring``) the rows, queued at once."""
    await gen.start()
    sp = path_cls(clf, model_id="clf", max_batch=4, max_wait_ms=0.0,
                  sched_source=lambda: gen.sched)
    await sp.start()
    try:
        if fault is not None:
            fault.arm("score_dispatch:raise")
        reqs = _enqueue(gen, PROMPTS)
        scores = ([asyncio.ensure_future(sp.submit(r)) for r in rows]
                  if scoring else [])
        streams = await asyncio.gather(*map(_collect, reqs))
        labels = await asyncio.gather(*scores, return_exceptions=True)
        counts = {"sched_units_score": gen.sched_units_score,
                  "sched_dispatches": sp.sched_dispatches,
                  "device_calls": sp.device_calls,
                  "requests": sp.requests}
        kinds = {k for _, k in gen.sched.trace}
        return streams, labels, counts, kinds
    finally:
        if fault is not None:
            fault.disarm()
        await sp.stop()
        await gen.stop()


def test_score_units_share_the_scheduler_as_in_jax(weights):
    rows = weights[2]
    want_s, want_l, want_c, want_k = asyncio.run(
        _trace(*_jax_pair(weights), rows))
    assert want_c == {"sched_units_score": 3, "sched_dispatches": 3,
                      "device_calls": 3, "requests": 10}
    assert "score" in want_k
    got_s, got_l, got_c, got_k = asyncio.run(
        _trace(*_port_pair(weights), rows))
    assert got_c == want_c
    assert {"score", "prefill", "decode"} <= got_k
    assert got_s == want_s
    assert [lab for lab, _ in got_l] == [lab for lab, _ in want_l]
    assert max(abs(a[1] - b[1]) for a, b in zip(got_l, want_l)) <= 1e-5
    # Scoring co-resident changes no stream.
    alone, _, _, _ = asyncio.run(
        _trace(*_port_pair(weights), rows, scoring=False))
    assert alone == got_s


def test_score_dispatch_fault_fails_one_batch_and_streams_finish(weights):
    streams, labels, counts, _ = asyncio.run(
        _trace(*_port_pair(weights), weights[2], fault=faults))
    assert all(isinstance(s, list) and s for s in streams)
    failed = [isinstance(x, faults.InjectedFault) for x in labels]
    assert failed == [True] * 4 + [False] * 6
    assert counts["sched_units_score"] == counts["device_calls"] == 3


class _Req:
    cancelled = False

    def __init__(self, deadline=None):
        self.deadline = deadline


def _claims(sched_cls, unit_cls, stats_cls):
    """Claim decisions of one scheduler for a fixed sequence of queue
    states, and the preemptions it counted."""
    eng = types.SimpleNamespace(latency=stats_cls(),
                                sched_deadline_preempts=0, tenants=None)
    sched = sched_cls(eng, max_batches=2)
    sched.stop()
    lane = types.SimpleNamespace(run=types.SimpleNamespace(reqs=[_Req()]),
                                 last_pick=0)
    sched._lanes.append(lane)
    big = 1e9      # perf_counter seconds: a deadline far away
    out = []
    for score_dl, lane_dl in ((None, None), (None, None), (None, None),
                              (-big, None), (None, -big), (big, -big),
                              (-big, big)):
        now = time.perf_counter()
        lane.run.reqs = [_Req(None if lane_dl is None else lane_dl + now)]
        deadline = None if score_dl is None else score_dl + now
        sched._score.clear()
        sched._score.append(unit_cls(lambda: None, lambda e: None, 1,
                                     deadline, None, 1.0))
        su = sched._claim_score()
        out.append(su is not None)
        sched._last_was_score = su is not None
    return out, eng.sched_deadline_preempts


def test_claim_policy_decides_as_the_jax_scheduler():
    want = _claims(JaxScheduler, JaxScoreUnit, JaxLatency)
    got = _claims(UnitScheduler, _ScoreUnit, LatencyStats)
    assert want == ([True, False, True, True, False, False, True], 2)
    assert got == want


@pytest.mark.parametrize("backend", ["sched", "pool"])
def test_no_score_unit_builds_a_graph(weights, backend):
    clf = _port_clf(weights, trainable=True)
    seen = []
    apply = clf.model.apply

    def probe(x):
        out = apply(x)
        seen.append((threading.current_thread().name,
                     torch.is_inference_mode_enabled(), out.requires_grad))
        return out

    clf.model.apply = probe

    async def run():
        gen = _port_gen(weights) if backend == "sched" else None
        if gen is not None:
            await gen.start()
        sp = ScorePath(clf, max_wait_ms=0.0, sched_source=(
            (lambda: gen.sched) if gen is not None else None))
        await sp.start()
        try:
            await asyncio.gather(*(sp.submit(r) for r in weights[2][:3]))
            return sp.sched_dispatches
        finally:
            await sp.stop()
            if gen is not None:
                await gen.stop()

    dispatched = asyncio.run(run())
    assert dispatched == (1 if backend == "sched" else 0)
    assert seen and all(mode and not grad for _, mode, grad in seen)
    want = "unitsched" if backend == "sched" else "score-dispatch"
    assert all(name.startswith(want) for name, _, _ in seen), seen


def test_multi_model_app_routes_and_reads_one_scheduler(weights):
    gen, clf = _port_gen(weights), _port_clf(weights)
    models = ModelRegistry({"default": gen, "clf": clf})
    jmodels = JaxRegistry({"default": types.SimpleNamespace(
        kind="generative"), "clf": types.SimpleNamespace(kind="tabular")})
    feats = dict(zip(IRIS, map(float, weights[2][0])))

    async def run():
        app = build_app(models=models, max_wait_ms=0.0)
        await app.startup()
        try:
            async with httpx.AsyncClient(
                transport=httpx.ASGITransport(app=app),
                base_url="http://t") as c:
                preds = await asyncio.gather(*(
                    c.post("/models/clf/predict", json=feats)
                    for _ in range(6)))
                g1 = await c.post("/generate", json={
                    "text": "hello world", "max_new_tokens": 6})
                g2 = await c.post("/models/default/generate", json={
                    "text": "hello world", "max_new_tokens": 6})
                miss = await c.post("/predict", json=feats)
                h = (await c.get("/healthz")).json()
                m = (await c.get("/metrics")).json()
                return preds, g1, g2, miss, h, m
        finally:
            await app.shutdown()

    preds, g1, g2, miss, h, m = asyncio.run(run())
    assert all(r.status_code == 200 for r in preds)
    assert {r.json()["prediction"] for r in preds} <= set(LABELS)
    assert g1.status_code == g2.status_code == 200
    assert g1.json()["token_ids"] == g2.json()["token_ids"]
    assert miss.status_code == 404      # the default model generates
    assert h["models"] == jmodels.describe()
    c = m["counters"]
    assert c["model.clf.requests"] == 6
    assert (c["model.clf.sched_dispatches"] == c["model.clf.device_calls"]
            == c["model.default.sched_units_score"]
            == c["generate.sched_units_score"] >= 1)
    assert models.started() == set()        # stopped in order
