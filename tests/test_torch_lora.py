"""The port's LoRA fine-tuning on the CPU, against the JAX package.

A tiny float32 GPT (vocab 260, hidden 32, 2 layers, 4 heads), its base
weights drawn by the JAX package's init, rank-4 adapters, on windows of
the port's ``docs_text`` corpus. The JAX side runs its own LoraModel and
an ``optax.masked`` AdamW step (what its ``fit`` builds for a LoRA
model); one JAX trajectory of four steps serves every test.

- A JAX LoRA tree (its adapters drawn by JAX) loads into the port's
  ``LoraModel``: the same tree signature, logits within 1e-5 once ``b``
  is nonzero, and at ``b = 0`` (step 0) the base model's logits exactly.
- Three masked-AdamW ``fit`` steps equal JAX's within 1e-5; the base is
  bit-frozen and the optimizer holds moments for the adapters alone.
- A LoRA train state written from JAX (its params and its masked optax
  state) resumes in the port and ends where JAX ends.
- ``--lora-rank`` through the train CLI's ``run`` with ``--init-from``
  writes a merged checkpoint equal to JAX's ``merge_params`` of the
  same trajectory (the port's own adapter draw carried into JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlapi_tpu.checkpoint.io import tree_signature as jax_tree_signature
from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.lora import LoraModel as JaxLoraModel
from mlapi_tpu.train.loop import _make_optimizer as jax_make_optimizer
from mlapi_tpu.train.loop import make_train_step as jax_make_train_step
from mlapi_tpu_torch.checkpoint import (
    load_checkpoint,
    load_opt_state,
    opt_state_from_jax,
    params_from_jax,
    save_checkpoint,
)
from mlapi_tpu_torch.checkpoint.io import step_dir, tree_signature
from mlapi_tpu_torch.config import TrainConfig
from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.models.lora import LoraModel
from mlapi_tpu_torch.train.__main__ import run
from mlapi_tpu_torch.train.loop import fit

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
RANK, LR, SEED, BS, SEQ = 4, 1e-3, 1, 8, 32
TOL = 1e-5


class _Splits:
    def __init__(self, x):
        self.x_train = self.y_train = x
        self.x_test = self.y_test = x[:4]
        self.extras = {"task": "lm"}


@pytest.fixture(scope="module")
def corpus():
    return get_dataset("docs_text", seq_len=SEQ)


@pytest.fixture(scope="module")
def splits(corpus):
    return _Splits(np.asarray(corpus.x_train[:64]))


@pytest.fixture(scope="module")
def base():
    return jax.tree.map(np.asarray, JaxGpt(**CFG).init(jax.random.key(0)))


def _gpt(np_base):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_base))
    return model


def _jax_tree(lora: LoraModel) -> dict:
    """A port LoraModel's weights as the JAX package's LoRA tree."""
    tree: dict = {"base": {}, "lora": {}}
    for key, t in lora.state_dict().items():
        arr = t.detach().numpy().copy()
        if key.startswith("lora."):
            joined, ab = key[len("lora."):].rsplit(".", 1)
            tree["lora"].setdefault(joined, {})[ab] = arr
        else:
            *path, leaf = key[len("base."):].split(".")
            node = tree["base"]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def _jax_steps(tree, x_all, steps, *, seed=SEED, bs=BS, lr=LR):
    """``steps`` masked-AdamW steps of the JAX package from ``tree``,
    with the port's minibatch schedule. Returns ``[(params, opt_state)]``
    after each step (numpy trees)."""
    jl = JaxLoraModel(JaxGpt(**CFG), rank=RANK)
    params = jax.tree.map(jnp.asarray, tree)
    tx = optax.masked(jax_make_optimizer("adamw", lr),
                      jl.trainable_mask(params))
    step = jax_make_train_step(jl.apply, tx, task="lm")
    opt_state = tx.init(params)
    out = []
    for i in range(steps):
        idx = np.random.default_rng((seed, i)).choice(
            len(x_all), size=bs, replace=False)
        x = jnp.asarray(x_all[idx])
        params, opt_state, _ = step(params, opt_state, x, x)
        out.append((jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, opt_state)))
    return out


@pytest.fixture(scope="module")
def jax_init(base):
    jl = JaxLoraModel(JaxGpt(**CFG), rank=RANK)
    return jax.tree.map(np.asarray, jl.init(
        jax.random.key(3), base_params=jax.tree.map(jnp.asarray, base)))


@pytest.fixture(scope="module")
def trajectory(jax_init, splits):
    return _jax_steps(jax_init, splits.x_train, 4)


def _port_lora(tree) -> LoraModel:
    lora = LoraModel(GptLM(**CFG, seed=None, device="cpu"), rank=RANK)
    lora.load_state_dict(params_from_jax(tree))
    return lora


def _assert_state(model, tree, tol=TOL):
    want = params_from_jax(tree)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   atol=tol, rtol=0, err_msg=key)


def test_init_carried_logits_and_step0_is_the_base(base, jax_init, corpus):
    ids = np.asarray(corpus.x_train[:2, :12])
    lora = _port_lora(jax_init)
    assert tree_signature(lora) == jax_tree_signature(jax_init)
    assert sorted(k for k in lora.state_dict() if k.startswith("lora.")) == \
        sorted(f"lora.{j}.{ab}" for j in jax_init["lora"] for ab in "ab")
    # b = 0: the adapted model IS the base model.
    with torch.no_grad():
        got = lora.apply(torch.as_tensor(ids))
        want = _gpt(base).apply(torch.as_tensor(ids))
    assert torch.equal(got, want)
    # Nonzero b: JAX's LoRA logits within 1e-5.
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda a: a, jax_init)
    for ab in tree["lora"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(
            np.float32)
    jl = JaxLoraModel(JaxGpt(**CFG), rank=RANK)
    with torch.no_grad():
        got = _port_lora(tree).apply(torch.as_tensor(ids)).numpy()
    want = np.asarray(jl.apply(jax.tree.map(jnp.asarray, tree), ids))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # merge_params is JAX's merge_params.
    merged = _port_lora(tree).merge_params()
    want = params_from_jax(jax.tree.map(np.asarray, jl.merge_params(
        jax.tree.map(jnp.asarray, tree))))
    assert set(merged) == set(want)
    for key, t in merged.items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), atol=TOL,
                                   rtol=0, err_msg=key)


def test_masked_adamw_fit_matches_jax(jax_init, trajectory, splits):
    lora = _port_lora(jax_init)
    base_before = {k: v.clone() for k, v in lora.state_dict().items()
                   if k.startswith("base.")}
    result = fit(lora, splits, steps=3, batch_size=BS, learning_rate=LR,
                 optimizer="adamw", seed=SEED, task="lm")
    assert result.steps == 3
    _assert_state(lora, trajectory[2][0])
    for key, before in base_before.items():
        assert torch.equal(lora.state_dict()[key], before), key
    # Only the adapters train: requires_grad, and (below) moments.
    assert {n for n, p in lora.named_parameters() if p.requires_grad} == {
        n for n in lora.state_dict() if n.startswith("lora.")}


def test_lora_train_state_resumes_from_jax(jax_init, trajectory, splits,
                                           tmp_path):
    params2, opt2 = trajectory[1]
    flat = opt_state_from_jax(opt2)
    # optax.masked holds no moments for the frozen base.
    assert flat["count"] == 2
    moments = {k for k in flat if k != "count"}
    assert moments == {f"{m}/lora/{j}/{ab}" for m in ("mu", "nu")
                       for j in jax_init["lora"] for ab in "ab"}
    run_config = {"optimizer": "adamw", "learning_rate": LR,
                  "weight_decay": 0.0, "batch_size": BS, "seed": SEED,
                  "task": "lm"}
    root = tmp_path / "state"
    save_checkpoint(step_dir(root, 2), params_from_jax(params2), step=2,
                    config={"kind": "train_state", **run_config},
                    opt_state=flat)
    lora = _port_lora(jax_init)
    got = fit(lora, splits, steps=4, batch_size=BS, learning_rate=LR,
              optimizer="adamw", seed=SEED, task="lm",
              checkpoint_dir=str(root), save_every=1, async_save=False)
    assert got.start_step == 2
    _assert_state(lora, trajectory[3][0])
    # The port's own save (step 3): adapter moments only, JAX's names.
    saved = load_opt_state(step_dir(root, 3))
    assert set(saved) == moments | {"count"}
    assert int(saved["count"]) == 3


def test_lora_rank_cli_writes_the_merged_checkpoint(base, corpus, tmp_path):
    cfg = TrainConfig(name="tiny-gpt", model="gpt_lm", model_kwargs=CFG,
                      dataset="docs_text", dataset_kwargs={"seq_len": SEQ},
                      steps=2, batch_size=BS, optimizer="adamw",
                      learning_rate=LR, seed=SEED)
    base_dir = tmp_path / "base"
    save_checkpoint(base_dir, _gpt(base), config={
        "model": "gpt_lm", "model_kwargs": CFG})
    out = tmp_path / "lora"
    summary = run(cfg, str(out), init_from=str(base_dir), lora_rank=RANK,
                  device="cpu")
    assert summary["steps"] == 2
    state, meta = load_checkpoint(out, _gpt(base))
    # The checkpoint is a plain GPT tree: it loads and serves as one.
    assert set(state) == set(_gpt(base).state_dict())
    # JAX from the port's own initial adapters, same batches, merged.
    init = LoraModel(_gpt(base), rank=RANK, seed=SEED)
    params, _ = _jax_steps(_jax_tree(init), np.asarray(corpus.x_train),
                           2)[-1]
    jl = JaxLoraModel(JaxGpt(**CFG), rank=RANK)
    want = params_from_jax(jax.tree.map(np.asarray, jl.merge_params(
        jax.tree.map(jnp.asarray, params))))
    for key, t in state.items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), atol=TOL,
                                   rtol=0, err_msg=key)
    assert not torch.equal(state["layer_0.qkv.kernel"],
                           _gpt(base).state_dict()["layer_0.qkv.kernel"])
