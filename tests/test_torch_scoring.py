"""The port's scoring path on the CPU, against the JAX package.

The same seeded numpy weights and inputs go through both packages:

- the classifiers' logits: ``linear`` within 1e-5; ``mlp`` and
  ``wide_deep`` (bf16 hidden layers) within 2e-2 on probabilities,
  labels equal wherever the JAX top-1 - top-2 probability margin
  exceeds 2e-2 (closer rows are near-ties, reported by the assertion
  message when they differ); Wide&Deep with negative, fractional and
  out-of-vocab ids;
- every dataset the scoring presets read, split for split (labels,
  feature names and provenance included);
- ``InferenceEngine`` (a 513-row call, chunked past the 512 bucket) and
  ``TextClassificationEngine`` over a tiny flash BERT (the JAX kernel in
  interpret mode, the port's plain B5), built through
  ``InferenceEngine.from_checkpoint``, whose refusals carry the JAX
  package's messages;
- ``ScorePath``'s counters against the JAX path's for the same trace:
  coalescing, deadlines, drain and the ``score_dispatch`` fault;
- ``/predict`` bodies and 422 details, and ``/files/`` JSON for the CSV
  cases pandas infers (ints, floats with NaN, quoted commas, header
  only, truncation), against the JAX app over the same weights;
- the CLI: ``--demo-iris`` answers the README's Iris request as the
  JAX demo does, ``--model`` and the refused flags parse as the JAX
  CLI's;
- the presets the slice makes trainable take two steps through the
  train CLI's ``run`` and serve, and ``criteo-widedeep`` stops at its
  sparse optimizer.
"""

import asyncio
import json
import math

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.datasets import get_dataset as jax_dataset
from mlapi_tpu.models import get_model as jax_model
from mlapi_tpu.serving import faults as jfaults
from mlapi_tpu.serving.app import build_app as jax_build_app
from mlapi_tpu.serving.engine import InferenceEngine as JaxEngine
from mlapi_tpu.serving.engine import TextClassificationEngine as JaxTextEngine
from mlapi_tpu.serving.scoring import ScorePath as JaxScorePath
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu.utils.vocab import LabelVocab as JaxVocab
from mlapi_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.__main__ import (
    demo_iris_checkpoint,
    make_parser,
    parse_args,
)
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import (
    InferenceEngine,
    TextClassificationEngine,
    TextGenerationEngine,
)
from mlapi_tpu_torch.serving.requests import DeadlineExceeded
from mlapi_tpu_torch.serving.scoring import OverloadedError, ScorePath
from mlapi_tpu_torch.text import ByteTokenizer
from mlapi_tpu_torch.utils.vocab import LabelVocab

SETOSA = {"sepal_length": 5.1, "sepal_width": 3.5, "petal_length": 1.4,
          "petal_width": 0.2}
IRIS = ("sepal_length", "sepal_width", "petal_length", "petal_width")
LABELS = ("Iris-setosa", "Iris-versicolor", "Iris-virginica")
MLP = dict(num_features=16, num_classes=5, hidden_dims=(32, 16))
WD = dict(num_dense=3, vocab_sizes=(7, 11, 5), embed_dim=4,
          hidden_dims=(16, 8), num_classes=3)
BERT = dict(num_classes=3, vocab_size=260, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, max_positions=32,
            attention_impl="flash")
BF16_TOL = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(name, kwargs, seed):
    """The JAX model's own initial parameters, as numpy."""
    return _np(jax.jit(jax_model(name, **kwargs).init)(jax.random.key(seed)))


def _port(name, kwargs, np_params):
    model = get_model(name, **kwargs, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def _softmax(logits):
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def _margin(probs):
    """Top-1 minus top-2 probability of each row."""
    top2 = np.sort(probs, -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _hold_labels(want_logits, want_ids, got_ids):
    """Labels equal wherever the JAX top-1 - top-2 probability margin
    exceeds 2e-2; the rows that differ are listed, with their margins,
    in the message."""
    margin = _margin(_softmax(np.asarray(want_logits)))
    differ = np.asarray(want_ids) != np.asarray(got_ids)
    ties = [(int(i), float(margin[i])) for i in np.flatnonzero(differ)]
    assert not (differ & (margin > BF16_TOL)).any(), ties


def _hold_bf16(want_logits, got_logits):
    """Probabilities within 2e-2, labels by :func:`_hold_labels`."""
    pw, pg = _softmax(np.asarray(want_logits)), _softmax(np.asarray(got_logits))
    assert np.abs(pw - pg).max() <= BF16_TOL
    _hold_labels(want_logits, pw.argmax(-1), pg.argmax(-1))


def _hold_engine(want_logits, want, got):
    """An engine's (ids, max-prob) against the JAX engine's on the same
    rows: max-prob within 2e-2, labels by :func:`_hold_labels` (the
    margins from the JAX model's logits for those rows)."""
    (want_ids, want_p), (ids, probs) = want, got
    assert np.isfinite(probs).all()
    assert np.abs(probs - want_p).max() <= BF16_TOL
    _hold_labels(want_logits, want_ids, ids)


@pytest.fixture(scope="module")
def linear():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(0, 1.0, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 0.5, (3,)).astype(np.float32)}
    return params


def _wd_rows(rng, n):
    dense = rng.normal(0, 1, (n, WD["num_dense"])).astype(np.float32)
    ids = rng.integers(-20, 40, (n, 3)).astype(np.float32)
    ids[:4] = [[-3.7, 2.9, 1e3], [-1, -7, 5], [6.99, 10.5, -0.5],
               [7, 11, 4]]                   # negative, fractional, OOV
    return np.concatenate([dense, ids], axis=1)


@pytest.mark.parametrize("name", ["linear", "mlp", "wide_deep"])
def test_model_logits_match_jax(name, linear):
    rng = np.random.default_rng(1)
    if name == "linear":
        kwargs, params = dict(num_features=4, num_classes=3), linear
        x = rng.normal(0, 2, (64, 4)).astype(np.float32)
    elif name == "mlp":
        kwargs = MLP
        params = _init("mlp", MLP, 3)
        x = rng.normal(0, 1, (256, 16)).astype(np.float32)
    else:
        kwargs = WD
        params = _init("wide_deep", WD, 4)
        x = _wd_rows(rng, 256)
    jm = jax_model(name, **kwargs)
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(x)))
    model = _port(name, kwargs, params)
    with torch.inference_mode():
        got = model.apply(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name == "linear":
        assert np.abs(got - want).max() <= 1e-5
    else:
        _hold_bf16(want, got)
    if name == "wide_deep":
        ids = model.embedding_ids(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(
            ids, np.asarray(jm.embedding_ids(jnp.asarray(x))))
        assert ids.min() >= 0 and (ids < np.asarray(WD["vocab_sizes"])).all()


def test_models_register_and_refuse_the_unported():
    for name in ("linear", "mlp", "wide_deep"):
        assert get_model(name, **{"linear": dict(num_features=4,
                                                 num_classes=3),
                                  "mlp": MLP, "wide_deep": WD}[name],
                         device="cpu").input_kind == "tabular"
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        get_model("wide_deep", **WD, device="cpu").param_shardings()
    # Flax key paths, so params_from_jax is a copy by key.
    assert set(get_model("mlp", **MLP, device="cpu").state_dict()) == {
        "dense_0.kernel", "dense_0.bias", "dense_1.kernel", "dense_1.bias",
        "out.kernel", "out.bias"}


@pytest.mark.parametrize("name,kwargs", [
    ("iris", {}), ("digits", {}),
    ("mnist", dict(synthetic_train=512, synthetic_test=64)),
    ("fashion_mnist", dict(synthetic_train=512, synthetic_test=64)),
    ("criteo", dict(n_train=512, n_test=64, vocab_size=1000)),
    ("docs_clf", dict(seq_len=128)),
])
def test_dataset_splits_equal_jax(name, kwargs):
    want, got = jax_dataset(name, **kwargs), get_dataset(name, **kwargs)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert want.vocab.labels == got.vocab.labels
    assert want.feature_names == got.feature_names
    assert (want.source, want.extras) == (got.source, got.extras)


def _iris_ckpt(tmp_path, params, name="iris"):
    return save_checkpoint(
        tmp_path / name, {k: torch.as_tensor(v) for k, v in params.items()},
        step=500, vocab=LabelVocab(LABELS),
        config={"model": "linear",
                "model_kwargs": {"num_features": 4, "num_classes": 3},
                "feature_names": list(IRIS)})


def test_tabular_engine_matches_jax_past_the_largest_bucket(tmp_path,
                                                           linear):
    x = np.random.default_rng(2).normal(0, 2, (513, 4)).astype(np.float32)
    jeng = JaxEngine(jax_model("linear", num_features=4, num_classes=3),
                     jax.tree.map(jnp.asarray, linear), JaxVocab(LABELS),
                     IRIS)
    want_ids, want_p = jeng.predict(x)
    eng = InferenceEngine.from_checkpoint(_iris_ckpt(tmp_path, linear),
                                          device="cpu")
    assert (eng.kind, eng.feature_names, eng.num_features) == (
        "tabular", IRIS, 4)
    assert eng.buckets == jeng.buckets and eng.max_batch == 512
    assert [eng.bucket_for(n) for n in (1, 3, 512, 600)] == [
        jeng.bucket_for(n) for n in (1, 3, 512, 600)]
    ids, probs = eng.predict(x)
    assert ids.dtype == np.int32 and probs.dtype == np.float32
    np.testing.assert_array_equal(ids, want_ids)
    assert np.abs(probs - want_p).max() <= 1e-5
    labels, _ = eng.predict_labels(x[:5])
    assert labels == jeng.predict_labels(x[:5])[0]
    assert eng.meta == {"step": 500, "config_hash": eng.meta["config_hash"]}

    # MLP in bf16, the same call shape.
    params = _init("mlp", MLP, 3)
    xm = np.random.default_rng(3).normal(0, 1, (513, 16)).astype(np.float32)
    jm = JaxEngine(jax_model("mlp", **MLP), jax.tree.map(jnp.asarray, params),
                   JaxVocab(tuple("abcde")), ())
    mids, mprobs = jm.predict(xm)
    got = InferenceEngine(_port("mlp", MLP, params), LabelVocab(tuple("abcde")))
    want_logits = jax.jit(jax_model("mlp", **MLP).apply)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(xm))
    _hold_engine(want_logits, (mids, mprobs), got.predict(xm))


def _spread_bert(jbert, seed):
    """Weights for the tiny BERT whose class probabilities spread far
    past the 2e-2 bound. JAX's own init (0.02 N(0, 1) kernels) leaves
    every probability within 5e-3 of 1/3, which any forward would
    match. Here kernels are normal with std 1/sqrt(fan_in) (the
    classifier's 2x that), embeddings std 1, biases std 0.5, layer norms
    as initialised."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "ln" in name:
            return np.ones(leaf.shape, np.float32) if "scale" in name \
                else np.zeros(leaf.shape, np.float32)
        if "kernel" in name:
            gain = 2.0 if "classifier" in name else 1.0
            std = gain / np.sqrt(leaf.shape[0])
        else:
            std = 0.5 if "bias" in name else 1.0
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(jbert.init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_text_engine_matches_jax_flash_bert(tmp_path):
    jbert = jax_model("bert_classifier", **{**BERT,
                                            "compute_dtype": "bfloat16"})
    params = _spread_bert(jbert, 6)
    texts = ["a fine film", "", "dreadful and tedious, truly", "x" * 40,
             "ok", "the plot", "moving", "hollow", "stale", "brilliant!"]
    tok = ByteTokenizer()
    rows = np.stack([tok.encode(t, 16)[0] for t in texts])
    # Centre the classifier bias on these rows, so their labels differ.
    model = _port("bert_classifier", BERT, params)
    with torch.inference_mode():
        params["classifier"]["bias"] -= model.apply(
            torch.as_tensor(rows)).float().numpy().mean(0)
    want = np.asarray(jax.jit(jbert.apply)(jax.tree.map(jnp.asarray, params),
                                           jnp.asarray(rows)))
    pw = _softmax(want)
    assert len(set(pw.argmax(-1))) == 3 and (_margin(pw) > BF16_TOL).sum() >= 8
    model = _port("bert_classifier", BERT, params)
    with torch.inference_mode():
        _hold_bf16(want, model.apply(torch.as_tensor(rows)).float().numpy())

    buckets = (4, 8)
    jeng = JaxTextEngine(jbert, jax.tree.map(jnp.asarray, params),
                         JaxVocab(("x", "y", "z")),
                         tokenizer=JaxByteTokenizer(), max_len=16,
                         buckets=buckets)
    path = save_checkpoint(
        tmp_path / "bert", params, vocab=LabelVocab(("x", "y", "z")),
        config={"model": "bert_classifier", "model_kwargs": BERT,
                "max_len": 16, "tokenizer": tok.fingerprint()})
    eng = InferenceEngine.from_checkpoint(path, device="cpu",
                                          buckets=buckets)
    assert isinstance(eng, TextClassificationEngine) and eng.kind == "text"
    np.testing.assert_array_equal(rows, np.stack([eng.encode(t)
                                                  for t in texts]))
    np.testing.assert_array_equal(rows, np.stack([jeng.encode(t)
                                                  for t in texts]))
    # 10 rows at max_batch 8: a chunk of 8, then 2 padded with two all-pad
    # (dead) rows into bucket 4; a 3-row call pads one dead row.
    for n in (10, 3):
        _hold_engine(want[:n], jeng.predict(rows[:n]), eng.predict(rows[:n]))
    with pytest.raises(ValueError, match="embedding table has 128 rows"):
        TextClassificationEngine(
            get_model("bert_classifier", **{**BERT, "vocab_size": 128},
                      device="cpu"),
            LabelVocab(("x", "y", "z")), tokenizer=ByteTokenizer())


def test_from_checkpoint_refusals_carry_the_jax_messages(tmp_path, linear):
    path = _iris_ckpt(tmp_path, linear)
    name = "LinearClassifier"
    for kw, msg in (
        (dict(kv_quant="int8"), "kv_quant applies to generative "
         f"checkpoints (they hold KV caches); {name} has none"),
        (dict(decode_attn_impl="flash"), "decode_attn_impl applies to "
         f"generative checkpoints (they decode); {name} does not"),
        (dict(kv_page_size=16), "kv_page_size/kv_pages apply to generative "
         f"checkpoints (they hold KV caches); {name} has none"),
        (dict(kv_pages=64), "kv_page_size/kv_pages apply to generative "
         f"checkpoints (they hold KV caches); {name} has none"),
    ):
        with pytest.raises(ValueError) as e:
            InferenceEngine.from_checkpoint(path, device="cpu", **kw)
        assert str(e.value) == msg
    # int8 weights are served since Queue A item 5: the JAX routing (a
    # tabular checkpoint to InferenceEngine, "quantized" in its meta),
    # and the Iris kernel (12 elements) stays float, so the labels are
    # the float engine's.
    q = InferenceEngine.from_checkpoint(path, device="cpu", quantize="int8")
    assert type(q) is InferenceEngine and q.meta["quantized"] == "int8"
    x = np.asarray([[5.1, 3.5, 1.4, 0.2], [6.7, 3.0, 5.2, 2.3]], np.float32)
    plain = InferenceEngine.from_checkpoint(path, device="cpu")
    assert q.predict_labels(x)[0] == plain.predict_labels(x)[0]
    with pytest.raises(ValueError, match="unsupported quantize"):
        InferenceEngine.from_checkpoint(path, device="cpu", quantize="int4")
    novocab = save_checkpoint(
        tmp_path / "novocab", {k: torch.as_tensor(v)
                               for k, v in linear.items()},
        config={"model": "linear",
                "model_kwargs": {"num_features": 4, "num_classes": 3}})
    with pytest.raises(ValueError, match="has no label vocab"):
        InferenceEngine.from_checkpoint(novocab, device="cpu")
    # A generative checkpoint goes to the generation engine.
    gpt = get_model("gpt_lm", vocab_size=260, hidden_size=32, num_layers=1,
                    num_heads=2, max_positions=64, compute_dtype="float32",
                    device="cpu")
    gpath = save_checkpoint(
        tmp_path / "gpt", gpt,
        config={"model": "gpt_lm", "model_kwargs": dict(
            vocab_size=260, hidden_size=32, num_layers=1, num_heads=2,
            max_positions=64, compute_dtype="float32"),
            "tokenizer": ByteTokenizer().fingerprint()})
    geng = InferenceEngine.from_checkpoint(gpath, device="cpu",
                                           sched_max_batches=1)
    assert isinstance(geng, TextGenerationEngine)
    assert geng.kind == "generative" and geng.sched_max_batches == 1
    # Options the port does not have are no keywords at all.
    with pytest.raises(TypeError, match="kv_peer_fetch"):
        InferenceEngine.from_checkpoint(gpath, device="cpu",
                                        kv_peer_fetch=True)


# -- ScorePath against the JAX path -----------------------------------------

def _paths(linear, **kw):
    jeng = JaxEngine(jax_model("linear", num_features=4, num_classes=3),
                     jax.tree.map(jnp.asarray, linear), JaxVocab(LABELS),
                     IRIS)
    model = _port("linear", dict(num_features=4, num_classes=3), linear)
    eng = InferenceEngine(model, LabelVocab(LABELS), IRIS)
    return (JaxScorePath(jeng, max_wait_ms=0.0, **kw), jfaults), \
        (ScorePath(eng, max_wait_ms=0.0, **kw), faults)


_COUNTERS = ("device_calls", "requests", "timeouts", "rejected",
             "shed_draining", "deadline_expired", "sched_dispatches",
             "inflight")


async def _score_trace(sp, fl, rows):
    """Coalescing, a deadline sweep, the score_dispatch fault, then a
    drain: each outcome and the counters after each phase."""
    await sp.start()
    out = []
    try:
        # 20 rows queued with no await between: ceil(20 / 8) batches.
        res = await asyncio.gather(*(sp.submit(r) for r in rows[:20]))
        out.append([(lab, round(p, 5)) for lab, p in res])
        out.append({k: getattr(sp, k) for k in _COUNTERS})
        # A 0.3 s call holds the one slot; rows with a 50 ms budget wait
        # behind it in the queue and expire at the batch boundary.
        fl.arm("score_dispatch:delay=0.3")
        slow = asyncio.ensure_future(sp.submit(rows[0]))
        await asyncio.sleep(0.05)
        late = await asyncio.gather(
            *(sp.submit(r, deadline_ms=50.0) for r in rows[:3]),
            return_exceptions=True)
        await slow
        fl.disarm()
        out.append([type(e).__name__ for e in late])
        out.append({k: getattr(sp, k) for k in _COUNTERS})
        # One injected raise fails that batch's rows only.
        fl.arm("score_dispatch:raise")
        bad = await asyncio.gather(*(sp.submit(r) for r in rows[:4]),
                                   return_exceptions=True)
        fl.disarm()
        good = await asyncio.gather(*(sp.submit(r) for r in rows[4:6]))
        out.append([type(e).__name__ for e in bad] + [len(good)])
        await sp.drain(1.0)
        with pytest.raises(Exception) as e:
            await sp.submit(rows[0])
        out.append((type(e.value).__name__, str(e.value),
                    e.value.retry_after_s))
        out.append({k: getattr(sp, k) for k in _COUNTERS})
    finally:
        fl.disarm()
        await sp.stop()
    return out


def test_score_path_counts_deadlines_drain_and_fault_equal_jax(linear):
    rows = np.random.default_rng(4).normal(0, 2, (20, 4)).astype(np.float32)
    (jsp, jfl), (psp, pfl) = _paths(linear, max_batch=8, max_inflight=1)
    want = asyncio.run(_score_trace(jsp, jfl, rows))
    got = asyncio.run(_score_trace(psp, pfl, rows))
    assert want[1]["device_calls"] == 3 and want[3]["deadline_expired"] == 3
    assert got[0] == want[0]
    # The two packages name their errors alike; the port's fault is its
    # own InjectedFault, the deadline its own DeadlineExceeded.
    assert got[1:] == want[1:]
    assert got[2] == ["DeadlineExceeded"] * 3
    assert isinstance(DeadlineExceeded("queued"), Exception)
    assert got[5][0] == "OverloadedError" and issubclass(
        OverloadedError, RuntimeError)


# -- the HTTP surface against the JAX app -----------------------------------

CSV_CASES = [
    b"sepal_length,species\n5.1,Iris-setosa\n6.2,Iris-virginica\n",
    b"a,b\n1,2.5\n3,\n",                       # ints; floats with NaN
    b'name,val\n"Smith, J",1\nbob,x\n',        # a quoted comma; strings
    b"a,b,c\n",                                # header only
    b"a,b\nTrue,1\nfalse,\n",                  # bools
    b"x,y\n" + b"".join(b"%d,%d.5\n" % (i, i) for i in range(1003)),
]


async def _both(jax_app, port_app, calls):
    out = []
    for app in (jax_app, port_app):
        await app.startup()
        try:
            async with httpx.AsyncClient(
                transport=httpx.ASGITransport(app=app),
                base_url="http://t",
            ) as c:
                out.append([await c.request(m, p, **kw)
                            for m, p, kw in calls])
        finally:
            await app.shutdown()
    return out


def _mnistish(seed):
    """A 6-feature MLP without feature names: the ``features`` schema."""
    kw = dict(num_features=6, num_classes=3, hidden_dims=(8,))
    params = _init("mlp", kw, seed)
    jeng = JaxEngine(jax_model("mlp", **kw), jax.tree.map(jnp.asarray, params),
                     JaxVocab(("a", "b", "c")), (), buckets=(1, 2, 4))
    peng = InferenceEngine(_port("mlp", kw, params), LabelVocab(("a", "b", "c")),
                           buckets=(1, 2, 4))
    return jeng, peng


def test_predict_and_files_answer_as_the_jax_app(tmp_path, linear):
    jeng = JaxEngine(jax_model("linear", num_features=4, num_classes=3),
                     jax.tree.map(jnp.asarray, linear), JaxVocab(LABELS),
                     IRIS)
    peng = InferenceEngine.from_checkpoint(_iris_ckpt(tmp_path, linear),
                                           device="cpu")
    calls = [("POST", "/predict", {"json": SETOSA}),
             ("POST", "/predict", {"json": {k: str(v)
                                            for k, v in SETOSA.items()}}),
             ("POST", "/predict", {"json": {**SETOSA, "deadline_ms": 500}}),
             ("POST", "/predict", {"json": {"sepal_length": 5.1}}),
             ("POST", "/predict", {"json": {**SETOSA,
                                            "sepal_length": "wide"}}),
             ("POST", "/predict", {"json": {**SETOSA, "deadline_ms": 0}}),
             ("POST", "/predict", {"content": b"{not json"}),
             ("GET", "/predict", {}),
             ("POST", "/files/", {"files": {"file": ("a.csv", b"a\n1\n")}}),
             ("POST", "/files/", {"data": {"token": "t"}}),
             ("POST", "/files/", {"files": {"file": ("a.csv", b"\xff\xfe")},
                                  "data": {"token": "t"}}),
             ("POST", "/files/", {"files": {"file": ("a.csv", b"")},
                                  "data": {"token": "t"}})]
    calls += [("POST", "/files/", {"files": {"file": ("f.csv", c,
                                                     "text/csv")},
                                   "data": {"token": "tok"}})
              for c in CSV_CASES]
    want, got = asyncio.run(_both(jax_build_app(jeng, max_wait_ms=0.0),
                                  build_app(peng, max_wait_ms=0.0), calls))
    for (m, p, kw), rj, rp in zip(calls, want, got):
        where = (m, p, str(kw)[:80])
        assert rp.status_code == rj.status_code, where
        if p == "/predict" and rj.status_code == 200:
            bj, bp = rj.json(), rp.json()
            assert list(bp) == ["prediction", "probability"]
            assert bp["prediction"] == bj["prediction"], where
            assert abs(bp["probability"] - bj["probability"]) <= 1e-6
        elif p == "/predict" and rj.status_code == 422:
            assert rp.json() == rj.json(), where
        elif p == "/files/" and rj.status_code == 200:
            # Byte for byte, NaN included.
            assert rp.content == rj.content, where
    assert json.loads(got[-1].content)["file"]["truncated"] is True
    assert math.isnan(json.loads(got[-5].content)["file"]["records"][1]["b"])

    # A model without feature names takes {"features": [...]}.
    jm, pm = _mnistish(6)
    calls = [("POST", "/predict", {"json": {"features": [0.1] * 6}}),
             ("POST", "/predict", {"json": {"features": ["0.2"] * 6}}),
             ("POST", "/predict", {"json": {"features": [0.1] * 5}}),
             ("POST", "/predict", {"json": {"features": [1, "x", None]}}),
             ("POST", "/predict", {"json": {"features": "abc"}})]
    want, got = asyncio.run(_both(jax_build_app(jm, max_wait_ms=0.0),
                                  build_app(pm, max_wait_ms=0.0), calls))
    for (m, p, kw), rj, rp in zip(calls, want, got):
        assert rp.status_code == rj.status_code, kw
        if rj.status_code == 422:
            assert rp.json() == rj.json(), kw
        else:
            assert rp.json()["prediction"] == rj.json()["prediction"]


def test_healthz_metrics_and_openapi_of_a_scoring_app(tmp_path, linear):
    peng = InferenceEngine.from_checkpoint(_iris_ckpt(tmp_path, linear),
                                           device="cpu")
    calls = [("POST", "/predict", {"json": SETOSA}),
             ("GET", "/healthz", {}), ("GET", "/metrics", {}),
             ("GET", "/openapi.json", {})]

    async def run():
        app = build_app(peng, max_wait_ms=0.0)
        await app.startup()
        try:
            async with httpx.AsyncClient(
                transport=httpx.ASGITransport(app=app),
                base_url="http://t") as c:
                return [await c.request(m, p, **kw) for m, p, kw in calls]
        finally:
            await app.shutdown()

    _, h, m, doc = asyncio.run(run())
    h, m, doc = h.json(), m.json(), doc.json()
    assert h["status"] == "ok" and h["classes"] == list(LABELS)
    assert h["model"] == "LinearClassifier" and "models" not in h
    assert m["counters"]["batcher.requests"] == 1
    assert m["counters"]["batcher.device_calls"] == 1
    assert m["gauges"]["batcher.inflight"] == 0
    schema = doc["components"]["schemas"]["Features"]
    assert set(schema["required"]) == set(IRIS)
    assert all(schema["properties"][f]["type"] == "number" for f in IRIS)
    files = doc["paths"]["/files/"]["post"]
    assert "multipart/form-data" in files["requestBody"]["content"]


# -- the CLI -----------------------------------------------------------------

def test_demo_iris_answers_the_readme_request_as_jax_does():
    from mlapi_tpu.datasets import load_iris
    from mlapi_tpu.train import fit as jax_fit

    # What the JAX CLI's --demo-iris trains (its _demo_iris_checkpoint,
    # without the checkpoint round trip), and the body its app writes.
    iris = load_iris()
    res = jax_fit(jax_model("linear", num_features=4, num_classes=3), iris,
                  steps=500, learning_rate=0.1, weight_decay=1e-3)
    jeng = JaxEngine(jax_model("linear", num_features=4, num_classes=3),
                     res.params, iris.vocab, iris.feature_names,
                     buckets=(1,))
    (label,), (prob,) = jeng.predict_labels(
        np.asarray([[SETOSA[f] for f in IRIS]], np.float32))
    want = b'{"prediction":"%s","probability":%.10g}' % (label.encode(), prob)
    peng = InferenceEngine.from_checkpoint(demo_iris_checkpoint("cpu"),
                                           device="cpu")

    async def run():
        app = build_app(peng)
        await app.startup()
        try:
            async with httpx.AsyncClient(
                transport=httpx.ASGITransport(app=app),
                base_url="http://t") as c:
                return await c.post("/predict", json=SETOSA)
        finally:
            await app.shutdown()

    r = asyncio.run(run())
    assert r.status_code == 200
    bj, bp = json.loads(want), r.json()
    assert bp["prediction"] == bj["prediction"] == "Iris-setosa"
    assert abs(bp["probability"] - bj["probability"]) <= 1e-6


def test_cli_parses_models_and_refuses_what_is_not_ported():
    args = parse_args(["--demo-iris", "--model", "clf=/a", "--model",
                       "g.2=/b", "--max-wait-ms", "1.5", "--device", "cpu"])
    assert args.demo_iris and args.checkpoint is None
    assert args.model_specs == [("clf=/a", "clf", "/a"),
                                ("g.2=/b", "g.2", "/b")]
    assert args.max_wait_ms == 1.5
    assert parse_args(["--checkpoint", "c"]).max_wait_ms == 0.2
    for argv, msg in (
        (["--demo-iris", "--checkpoint", "c"], "exactly one"),
        ([], "exactly one"),
        (["--checkpoint", "c", "--model", "noeq"], "expected ID=CHECKPOINT"),
        (["--checkpoint", "c", "--model", "a/b=x"], "URL-path-safe"),
        (["--checkpoint", "c", "--model", "a=x", "--model", "a=y"],
         "duplicate model id"),
        (["--checkpoint", "c", "--model", "default=x"], "duplicate"),
        # --quantize and the tenant flags are served since Queue A item
        # 5; the adapter flags need --adapter-slots, as in the JAX CLI.
        (["--checkpoint", "c", "--quantize", "int4"], "invalid choice"),
        (["--checkpoint", "c", "--workers", "2"], "item 7"),
        (["--checkpoint", "c", "--router"], "item 7"),
        (["--checkpoint", "c", "--adapter", "t1=/p"],
         "require --adapter-slots > 0"),
        (["--checkpoint", "c", "--adapter-store-bytes", "64"],
         "require --adapter-slots > 0"),
    ):
        parser = make_parser()
        seen = []
        parser.error = lambda m, seen=seen: (seen.append(m),
                                             (_ for _ in ()).throw(
                                                 SystemExit(2)))
        with pytest.raises(SystemExit):
            parse_args(argv, parser)
        assert msg in seen[0], (argv, seen)
    args = parse_args(["--checkpoint", "c", "--quantize", "int8",
                       "--adapter-slots", "4", "--adapter", "t1=/p",
                       "--tenant-pages", "a=4", "--tenant-weight", "a=2"])
    assert (args.quantize, args.adapter_slots, args.adapter) == (
        "int8", 4, ["t1=/p"])
    assert (args.tenant_pages, args.tenant_weight) == (["a=4"], ["a=2"])


@pytest.mark.parametrize("preset", [
    "iris-linear", "digits-softmax", "digits-mlp", "mnist-softmax",
    "fashion-mlp", "docsclf-bert"])
def test_scoring_presets_train_and_serve(preset, tmp_path):
    """Two steps of each preset the slice makes trainable, through the
    train CLI's ``run`` on the CPU; its checkpoint serves."""
    import dataclasses

    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.train.__main__ import run

    cfg = dataclasses.replace(get_preset(preset), steps=2, eval_every=0)
    summary = run(cfg, str(tmp_path / preset), device="cpu")
    assert math.isfinite(summary["final_loss"])
    eng = InferenceEngine.from_checkpoint(tmp_path / preset, device="cpu")
    assert eng.kind == ("text" if preset == "docsclf-bert" else "tabular")
    ids, probs = eng.predict(np.zeros((3, eng.num_features),
                                      eng.input_dtype))
    assert ids.shape == (3,) and np.isfinite(probs).all()


def test_criteo_widedeep_stops_at_its_optimizer():
    """The preset's optimizer, ``recsys-sparse-adamw``, was refused until
    the sparse step was ported; now the preset trains through it."""
    import dataclasses

    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.train.__main__ import run

    cfg = dataclasses.replace(get_preset("criteo-widedeep"), steps=2)
    assert cfg.optimizer == "recsys-sparse-adamw"
    summary = run(cfg, None, device="cpu")
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
