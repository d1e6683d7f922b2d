"""The port's weight-only int8 serving on the CPU, against the JAX package.

Tiny float32 models (the GPT and GQA Llama of the serving tests: vocab
260, hidden 32, 2 layers, 4 heads; a 2-layer BERT; a tabular MLP), their
weights drawn from a numpy seed wide enough that greedy streams differ
per prompt.

- ``quantize_tree``: ``q`` and ``scale`` exactly JAX's, and
  ``quantized_bytes``, ``is_quantized`` and the tree signature equal.
- ``QuantizedModel`` logits within 1e-5 of JAX's ``QuantizedModel``, the
  int8 leaves held as ``QuantLeaf`` buffers in the JAX key paths.
- Greedy streams of a GPT batch through ``from_checkpoint(quantize=
  "int8")`` equal the JAX engine's, contiguous and paged 8, with a
  full-precision and an int8 cache; the engine's meta says
  ``quantized``.
- A quantized tabular checkpoint routes to ``InferenceEngine``, its
  labels equal to the JAX quantized engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.checkpoint.io import tree_signature as jax_tree_signature
from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.models.quantized import QuantizedModel as JaxQuantized
from mlapi_tpu.ops import quant as jq
from mlapi_tpu.serving.engine import InferenceEngine as JaxInference
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.requests import _SyncSink as JaxSink
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu.utils.vocab import LabelVocab as JaxVocab
from mlapi_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from mlapi_tpu_torch.checkpoint.io import tree_signature
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.models.quantized import QuantizedModel
from mlapi_tpu_torch.ops import quant as tq
from mlapi_tpu_torch.serving.engine import (
    InferenceEngine,
    TextGenerationEngine,
)
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.utils.vocab import LabelVocab

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
MODELS = {
    "gpt_lm": CFG,
    "llama_lm": {**CFG, "num_kv_heads": 2},
    "bert_classifier": dict(num_classes=3, vocab_size=260, hidden_size=32,
                            num_layers=2, num_heads=2, intermediate_size=64,
                            max_positions=32, compute_dtype="float32"),
}
MLP = dict(num_features=64, num_classes=5, hidden_dims=(128,),
           compute_dtype="float32")
BUCKETS = (16, 32)
PROMPTS = (" hello world", "zq", "fox jumps")
TOL = 1e-5


def _draw(name, kwargs, seed=0):
    """The JAX tree's shapes, values from a numpy seed."""
    jm = jax_get_model(name, **kwargs)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    return {name: _draw(name, kw) for name, kw in MODELS.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_tree_and_model_match_jax(weights, name):
    np_params = weights[name]
    want = jax.tree.map(np.asarray, jq.quantize_tree(np_params))
    got = tq.quantize_tree(np_params)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert want_leaves.keys() == got_leaves.keys()
    for path, w in want_leaves.items():
        g = np.asarray(got_leaves[path])
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert any(p.endswith("/q") for p in want_leaves)
    assert tq.quantized_bytes(got) == jq.quantized_bytes(want)
    assert tq.is_quantized(got) and not tq.is_quantized(np_params)
    deq = tq.dequantize_tree(jax.tree.map(torch.as_tensor, got))
    want_deq = jq.dequantize_tree(jax.tree.map(jnp.asarray, want))
    for path, w in _leaves(jax.tree.map(np.asarray, want_deq)):
        np.testing.assert_array_equal(dict(_leaves(deq))[path].numpy(), w)

    # The model: QuantLeaf buffers at the JAX key paths, the same bytes
    # and signature, logits within 1e-5 of JAX's QuantizedModel.
    model = get_model(name, **MODELS[name], seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    qm = QuantizedModel(model)
    state = qm.state_dict()
    wq = params_from_jax(want)
    assert state.keys() == wq.keys()
    for key, t in state.items():
        assert torch.equal(t, wq[key]), key
    assert tq.quantized_bytes(qm) == jq.quantized_bytes(want)
    assert tree_signature(qm) == jax_tree_signature(want)
    fresh = QuantizedModel(get_model(name, **MODELS[name], seed=None,
                                     device="cpu"))
    fresh.load_state_dict(params_from_jax(want))   # a JAX quantized tree
    ids = np.random.default_rng(1).integers(1, 260, (2, 12)).astype(np.int32)
    want_logits = np.asarray(JaxQuantized(
        jax_get_model(name, **MODELS[name])).apply(
        jax.tree.map(jnp.asarray, want), jnp.asarray(ids)))
    with torch.no_grad():
        for m in (qm, fresh):
            got_logits = m.apply(torch.as_tensor(ids)).numpy()
            np.testing.assert_allclose(got_logits, want_logits, atol=TOL,
                                       rtol=0)


def _batch(eng, sink_cls):
    """``PROMPTS`` as one formed batch through ``_run_batch``."""
    outs = [[] for _ in PROMPTS]
    sinks = [sink_cls(eng._encode(p, 10, 0.0, 0, None), out)
             for p, out in zip(PROMPTS, outs)]
    eng._run_batch(sinks)
    assert all(s.error is None for s in sinks)
    return outs


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_int8_weight_engine_streams_equal_jax(weights, kv_quant, tmp_path):
    name = "gpt_lm"
    np_params = weights[name]
    path = save_checkpoint(tmp_path / "ck", params_from_jax(np_params),
                           config={"model": name,
                                   "model_kwargs": MODELS[name]})
    jm = JaxQuantized(jax_get_model(name, **MODELS[name], kv_quant=kv_quant))
    jeng = JaxEngine(jm, jax.tree.map(jnp.asarray, jq.quantize_tree(
        np_params)), tokenizer=JaxByteTokenizer(), prompt_buckets=BUCKETS,
        chunk=8, fused_single=False, kv_page_size=8)
    want = _batch(jeng, JaxSink)
    assert len({tuple(w) for w in want}) == len(PROMPTS)
    for page in (None, 8):
        eng = InferenceEngine.from_checkpoint(
            path, device="cpu", quantize="int8", kv_quant=kv_quant,
            decode_attn_impl="flash", kv_page_size=page,
            prompt_buckets=BUCKETS, fused_single=False)
        assert isinstance(eng, TextGenerationEngine)
        assert eng.meta["quantized"] == "int8"
        assert isinstance(eng.model, QuantizedModel)
        assert _batch(eng, _SyncSink) == want, page


def test_quantized_tabular_checkpoint_routes_to_inference_engine(tmp_path):
    params = _draw("mlp", MLP, seed=2)
    vocab = tuple("abcde")
    path = save_checkpoint(tmp_path / "mlp", params_from_jax(params),
                           vocab=LabelVocab(vocab),
                           config={"model": "mlp", "model_kwargs": MLP})
    eng = InferenceEngine.from_checkpoint(path, device="cpu",
                                          quantize="int8")
    assert type(eng) is InferenceEngine and eng.kind == "tabular"
    assert eng.meta["quantized"] == "int8"
    assert isinstance(eng.model.inner.dense_0.kernel, tq.QuantLeaf)
    jeng = JaxInference(JaxQuantized(jax_get_model("mlp", **MLP)),
                        jax.tree.map(jnp.asarray, jq.quantize_tree(params)),
                        JaxVocab(vocab), ())
    x = np.random.default_rng(3).normal(0, 1, (40, 64)).astype(np.float32)
    want_ids, want_p = jeng.predict(x)
    ids, probs = eng.predict(x)
    np.testing.assert_array_equal(ids, want_ids)
    assert np.abs(probs - want_p).max() <= TOL
    assert eng.predict_labels(x)[0] == jeng.predict_labels(x)[0]
    assert len(set(ids.tolist())) > 1
