"""Parity of the port's training slice with the JAX package: BERT
(full and flash attention), GPT's flash ``apply``, the train loop and
its optimizers, the sst2 data and its tokenizers, and the train CLI's
checkpoint.

Weights cross by ``params_from_jax``; inputs are made with numpy from
a seed and handed to both. Flash attention runs the Pallas kernels in
interpret mode on the JAX side and the plain versions of B5-B7 on the
port's (CPU tensors). Bounds: logits and every gradient within 1e-4 at
f32; three AdamW steps within 1e-5; ids, splits and manifest configs
exact.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlapi_tpu.config import TrainConfig as JaxTrainConfig
from mlapi_tpu.datasets.sst2 import load_sst2 as jax_load_sst2
from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.text import tokenizer as jax_tok
from mlapi_tpu.train import fit as jax_fit
from mlapi_tpu.train.__main__ import run as jax_run
from mlapi_tpu_torch.checkpoint import load_checkpoint, params_from_jax
from mlapi_tpu_torch.config import TrainConfig, get_preset, preset_names
from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.text import tokenizer as port_tok
from mlapi_tpu_torch.train import fit
from mlapi_tpu_torch.train.__main__ import main, run
from mlapi_tpu_torch.train.loop import _make_optimizer

BERT = dict(num_classes=2, vocab_size=128, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, max_positions=32,
            compute_dtype="float32")
GPT = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4,
           max_positions=64, compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(name, cfg, jax_params):
    model = get_model(name, **cfg, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jax_params)))
    return model


def _ids(seed, b=3, l=32, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, l)).astype(np.int32)
    ids[0, 20:] = 0
    ids[1, 7:] = 0
    return ids


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_bert_logits_and_gradients_match_jax(impl):
    jm = jax_get_model("bert_classifier", **BERT, attention_impl=impl)
    params = jm.init(jax.random.key(0))
    ids = _ids(0)
    g = np.random.default_rng(1).standard_normal((3, 2)).astype(np.float32)

    def loss(p):
        logits = jm.apply(p, jnp.asarray(ids))
        return jnp.sum(logits * g), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params
    )
    model = _port_model("bert_classifier", dict(BERT, attention_impl=impl),
                        params)
    out = model.apply(torch.as_tensor(ids).long())
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=1e-4, rtol=0)
    want = params_from_jax(_np_tree(grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_gpt_flash_apply_matches_jax():
    jm = jax_get_model("gpt_lm", **GPT, attention_impl="flash")
    params = jm.init(jax.random.key(1))
    ids = np.random.default_rng(2).integers(4, 260, (2, 64)).astype(np.int32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))
    model = _port_model("gpt_lm", dict(GPT, attention_impl="flash"), params)
    with torch.no_grad():
        got = model.apply(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _tiny_sst2():
    return dict(n_train=64, n_test=32, max_len=32, vocab_size=128)


def test_three_adamw_fit_steps_match_jax():
    """At the sst2-bert preset's rate (2e-5). Adam divides by the root of
    its second moment, so a parameter whose gradient is near zero moves
    by about the learning rate whatever the gradient's rounding; at a
    rate of 1e-3 one such element of 4096 lands 1.3e-5 apart. The
    update arithmetic itself is pinned at O(1) gradients below."""
    jm = jax_get_model("bert_classifier", **BERT)
    params = jm.init(jax.random.key(2))
    kw = dict(steps=3, batch_size=8, learning_rate=2e-5, optimizer="adamw",
              seed=5, eval_every=1)
    model = _port_model("bert_classifier", BERT, params)
    # jax fit donates init_params: the port model was loaded first.
    want = jax_fit(jm, jax_load_sst2(**_tiny_sst2()), init_params=params,
                   **kw)
    got = fit(model, get_dataset("sst2", **_tiny_sst2()), **kw)
    for g, w in zip(got.history, want.history, strict=True):
        assert g["step"] == w["step"]
        assert g["loss"] == pytest.approx(w["loss"], abs=1e-5)
        assert g["test_accuracy"] == w["test_accuracy"]
    assert got.test_accuracy == want.test_accuracy
    final = params_from_jax(_np_tree(want.params))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax(name):
    """torch.optim at optax's defaults: the same parameters after three
    updates from the same gradients (AdamW's decay is applied in
    another order, which changes rounding only)."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    tx = getattr(optax, name)(1e-2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for gr in grads:
        upd, state = tx.update(jnp.asarray(gr), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.nn.Parameter(torch.as_tensor(p0))
    opt = _make_optimizer(name, 1e-2, [tp])
    for gr in grads:
        tp.grad = torch.as_tensor(gr)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=0)


def test_sst2_splits_and_tokenizers_match_jax():
    want, got = jax_load_sst2(), get_dataset("sst2")
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.vocab.labels == want.vocab.labels
    assert got.extras == want.extras and got.source == want.source
    texts = ["Héllo, WORLD!  it's a café's $5 résumé...", "unaffable 12x",
             "naïve — über-cool;;", ""]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", ",", "world", "!",
             "it", "'", "s", "a", "cafe", "$", "5", "res", "##ume", ".",
             "un", "##aff", "##able", "12", "##x", "naive", "uber", "-",
             "cool", ";"]
    for jt, pt in ((jax_tok.HashTokenizer(1000), port_tok.HashTokenizer(1000)),
                   (jax_tok.WordPieceTokenizer(vocab),
                    port_tok.WordPieceTokenizer(vocab))):
        assert pt.fingerprint() == jt.fingerprint()
        for t in texts:
            assert pt.token_ids(t) == jt.token_ids(t)
            for a, b in zip(pt.encode(t, 12), jt.encode(t, 12)):
                assert np.array_equal(a, b)


def test_run_writes_the_checkpoint_jax_writes(tmp_path, monkeypatch):
    """The JAX run's checkpoint is caught at its save call (what its
    manifest would hold), so the test needs no orbax."""
    import mlapi_tpu.checkpoint as jax_ckpt
    from mlapi_tpu.checkpoint.io import tree_signature as jax_signature

    want = {}

    def capture(path, params, *, step, config, vocab):
        want.update(config=json.loads(json.dumps(config)), step=step,
                    vocab=vocab.to_json(),
                    tree_signature=jax_signature(params))

    monkeypatch.setattr(jax_ckpt, "save_checkpoint", capture)
    fields = dict(name="tiny-bert", model="bert_classifier",
                  model_kwargs=dict(BERT), dataset="sst2",
                  dataset_kwargs=_tiny_sst2(), steps=1, batch_size=8,
                  optimizer="adamw", learning_rate=1e-3, mesh_shape=(2, 4))
    jax_run(JaxTrainConfig(**fields), str(tmp_path / "jax"))
    summary = run(TrainConfig(**fields), str(tmp_path / "port"),
                  device="cpu")
    assert np.isfinite(summary["final_loss"]) and len(summary["step_ms"]) == 1
    got = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    assert got["config"] == want["config"]
    assert got["step"] == want["step"] == 1
    assert got["vocab"] == want["vocab"] == {"labels": ["negative",
                                                        "positive"]}
    assert got["tree_signature"] == want["tree_signature"]
    model = get_model("bert_classifier", **BERT, seed=None, device="cpu")
    state, meta = load_checkpoint(tmp_path / "port", model)
    assert meta.vocab.labels == ("negative", "positive")
    model.load_state_dict(state)


def test_yaml_config_without_pyyaml_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="needs PyYAML"):
        TrainConfig.from_yaml(tmp_path / "run.yaml")


def test_presets_are_the_jax_table_filtered_to_what_is_ported():
    # Every model and dataset of the JAX table is ported now; a preset
    # whose model is not registered still refuses by name.
    assert preset_names() == preset_names(only_available=False) == [
        "criteo-widedeep", "digits-mlp", "digits-softmax", "docs-gpt",
        "docs-gpt-draft", "docs-gpt-draft-distilled", "docs-llama",
        "docsclf-bert", "fashion-mlp", "iris-linear", "mnist-softmax",
        "sst2-bert"]
    assert get_preset("docsclf-bert").dataset == "docs_clf"
    from mlapi_tpu_torch.config import TrainConfig, register_preset
    from mlapi_tpu_torch.config import _PRESETS
    cfg = TrainConfig(name="test-unported", model="no_such_model")
    register_preset(cfg)
    try:
        with pytest.raises(ValueError, match="not both ported"):
            get_preset("test-unported")
    finally:
        del _PRESETS["test-unported"]
    cfg = get_preset("sst2-bert")
    assert cfg.model_kwargs["attention_impl"] == "flash"
    assert (cfg.batch_size, cfg.optimizer, cfg.learning_rate) == (
        32, "adamw", 2e-5)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(mesh=object()), NotImplementedError, "Queue A item 8"),
    (dict(optimizer="recsys-adamw"), ValueError,
     "BertClassifier has none"),
    (dict(optimizer="recsys-sparse-adamw"), ValueError,
     "sparse-embedding protocol"),
    (dict(optimizer="recsys-sparse-adamw", weight_decay=1e-3), ValueError,
     "requires weight_decay=0"),
    (dict(optimizer="recsys-sparse-adamw", debug_checks=True), ValueError,
     "does not support --debug-checks"),
    (dict(distill_from="no/such/teacher"), FileNotFoundError,
     "not a committed checkpoint"),
    (dict(optimizer="lion"), ValueError, "unknown optimizer"),
])
def test_unported_training_features_refuse(kwargs, error, match):
    """What still refuses: a mesh (its ROADMAP item), and the training
    features' own guards where the combination makes no sense."""
    model = get_model("bert_classifier", **BERT, seed=0, device="cpu")
    splits = get_dataset("sst2", **_tiny_sst2())
    with pytest.raises(error, match=match):
        fit(model, splits, steps=1, **kwargs)


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is runnable")
    monkeypatch.delenv("MLAPI_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "sst2-bert", "--steps", "1"])


def test_vocab_range_is_checked_before_training(tmp_path):
    cfg = TrainConfig(name="small-vocab", model="bert_classifier",
                      model_kwargs=dict(BERT, vocab_size=64),
                      dataset="sst2", dataset_kwargs=_tiny_sst2(), steps=1)
    with pytest.raises(ValueError, match="vocab_size disagree"):
        run(cfg, None, device="cpu")
