"""The port's recsys optimizers and sparse Wide&Deep step, held to the
JAX package (``train/optimizers.py``, ``train/sparse_embed.py``), and
the train bench's rows.

Weights cross by ``params_from_jax``; inputs are made with numpy from a
seed and handed to both. Bounds: rowwise AdaGrad's update and
accumulator within 1e-6 with untouched rows bit-equal; a partitioned
``recsys-adamw`` fit within 1e-5 after 10 steps; the sparse step within
1e-6 of the port's dense ``recsys-adamw`` (untouched rows bit-equal) and
within 1e-5 of JAX's sparse step on a batch that repeats ids; the
sparse step's guards raise JAX's messages word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.train import fit as jax_fit
from mlapi_tpu.train.bench import bench_train as jax_bench_train
from mlapi_tpu.train.loop import _make_optimizer as jax_make_optimizer
from mlapi_tpu.train.optimizers import rowwise_adagrad
from mlapi_tpu.train.sparse_embed import make_sparse_recsys_step as jax_sparse
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.train import fit
from mlapi_tpu_torch.train.__main__ import main
from mlapi_tpu_torch.train.bench import bench_train
from mlapi_tpu_torch.train.loop import _make_optimizer
from mlapi_tpu_torch.train.optimizers import RowwiseAdagrad
from mlapi_tpu_torch.train.sparse_embed import make_sparse_recsys_step

WIDE = dict(num_dense=3, vocab_sizes=[50, 50, 50], embed_dim=4,
            hidden_dims=[8], num_classes=2, compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class _Splits:
    """Tiny criteo-style rows: 3 dense features, 3 ids per row drawn
    from the first ``used`` ids of each table (the rest are never
    touched)."""

    def __init__(self, n=256, used=30, seed=0):
        rng = np.random.default_rng(seed)
        self.x_train = np.concatenate(
            [rng.normal(size=(n, 3)).astype(np.float32),
             rng.integers(0, used, (n, 3)).astype(np.float32)], axis=1)
        self.y_train = rng.integers(0, 2, n).astype(np.int32)
        self.x_test = self.x_train[:64]
        self.y_test = self.y_train[:64]
        self.extras = {}


@pytest.fixture(scope="module")
def jax_wide():
    jm = jax_get_model("wide_deep", **WIDE)
    return jm, _np_tree(jm.init(jax.random.key(0)))


def _port_wide(np_params):
    model = get_model("wide_deep", **WIDE, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def test_rowwise_adagrad_matches_jax():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((3, 50, 4)).astype(np.float32)
    grads = []
    for _ in range(3):
        g = rng.standard_normal((3, 50, 4)).astype(np.float32)
        g[:, 40:] = 0.0                      # rows no batch touches
        grads.append(g)
    tx = rowwise_adagrad(1e-1)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state)
        jp = jp + upd
    tp = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = RowwiseAdagrad([tp], 1e-1)
    for g in grads:
        tp.grad = torch.as_tensor(g)
        opt.step()
    got = tp.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(opt.state[tp]["acc"].numpy(),
                               np.asarray(state), atol=1e-6, rtol=0)
    assert np.array_equal(got[:, 40:], p0[:, 40:])


def test_partitioned_recsys_fit_matches_jax(jax_wide):
    jm, params = jax_wide
    kw = dict(steps=10, batch_size=64, learning_rate=1e-2,
              optimizer="recsys-adamw", seed=2)
    model = _port_wide(params)
    want = jax_fit(jm, _Splits(), init_params=jax.tree.map(jnp.asarray,
                                                            params), **kw)
    got = fit(model, _Splits(), **kw)
    assert got.final_loss == pytest.approx(want.final_loss, abs=1e-5)
    final = params_from_jax(_np_tree(want.params))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


def test_sparse_step_matches_dense_recsys(jax_wide):
    _, params = jax_wide
    kw = dict(steps=10, batch_size=128, learning_rate=1e-2, seed=4)
    dense = _port_wide(params)
    sparse = _port_wide(params)
    a = fit(dense, _Splits(), optimizer="recsys-adamw", **kw)
    b = fit(sparse, _Splits(), optimizer="recsys-sparse-adamw", **kw)
    assert b.final_loss == pytest.approx(a.final_loss, abs=1e-6)
    init = params_from_jax(params)
    for key, p in sparse.state_dict().items():
        np.testing.assert_allclose(p.numpy(), dense.state_dict()[key].numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)
        if key.endswith("_tables"):
            # Ids 30.. are never drawn: those rows are bit-frozen on
            # both paths.
            assert torch.equal(p[:, 30:], init[key][:, 30:]), key
            assert torch.equal(dense.state_dict()[key][:, 30:],
                               init[key][:, 30:]), key


def test_sparse_step_matches_jax_on_repeated_ids(jax_wide):
    jm, params = jax_wide
    rng = np.random.default_rng(5)
    b = 64
    x = np.concatenate([rng.normal(size=(b, 3)).astype(np.float32),
                        rng.integers(0, 6, (b, 3)).astype(np.float32)], 1)
    x[:, 3:][x[:, 3:] == 5] = -7.0      # ids past the vocab wrap as in JAX
    y = rng.integers(0, 2, b).astype(np.int32)
    lr = 1e-2
    init, step = jax_sparse(jm, jax_make_optimizer("adamw", lr), lr)
    jp = jax.tree.map(jnp.asarray, params)
    state = init(jp)
    model = _port_wide(params)
    opt, port_step = make_sparse_recsys_step(
        model, lambda ps: _make_optimizer("adamw", lr, ps), lr)
    for _ in range(3):
        jp, state, jloss = step(jp, state, jnp.asarray(x), jnp.asarray(y))
        ploss = port_step(torch.as_tensor(x), torch.as_tensor(y))
        assert float(ploss) == pytest.approx(float(jloss), abs=1e-5)
    want = params_from_jax(_np_tree(jp))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
    rowwise = opt.parts["embedding"]
    for name in ("wide_tables", "deep_tables"):
        np.testing.assert_allclose(
            rowwise.state[getattr(model, name)]["acc"].numpy(),
            np.asarray(state["acc"][name]), atol=1e-5, rtol=0)


class _Lora:
    """A stand-in for a LoRA wrapper: only ``trainable_mask`` matters."""

    def trainable_mask(self, params):
        return params


@pytest.mark.parametrize("case", ["lm", "weight_decay", "protocol",
                                  "distill", "debug_checks", "lora"])
def test_sparse_guards_raise_jax_messages(case, jax_wide):
    jm, params = jax_wide
    splits = _Splits(n=16)
    jax_model, port_model = jm, _port_wide(params)
    kw = dict(steps=1, optimizer="recsys-sparse-adamw")
    if case == "lm":
        kw["task"] = "lm"
    elif case == "weight_decay":
        kw["weight_decay"] = 1e-3
    elif case == "protocol":
        jax_model = jax_get_model("linear", num_features=6, num_classes=2)
        port_model = get_model("linear", num_features=6, num_classes=2,
                               device="cpu")
    elif case == "distill":
        kw["distill_from"] = "teacher"
    elif case == "debug_checks":
        kw["debug_checks"] = True
    else:
        jax_model = type("JaxLora", (_Lora, type(jm)), {})(**WIDE)
        port_model.trainable_mask = _Lora().trainable_mask
    with pytest.raises(ValueError) as want:
        jax_fit(jax_model, splits, **kw)
    with pytest.raises(ValueError) as got:
        fit(port_model, splits, **kw)
    assert str(got.value) == str(want.value)


def test_criteo_widedeep_trains_through_the_cli(monkeypatch, capsys):
    """The preset at its published widths (26 tables of 100,000 rows ×
    16) on ``recsys-sparse-adamw``: two steps, no refusal."""
    import json

    monkeypatch.setenv("MLAPI_TPU_PLATFORM", "cpu")
    main(["--preset", "criteo-widedeep", "--steps", "2"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])


def test_bench_rows_have_the_jax_keys():
    want = jax_bench_train("iris-linear", bench_steps=2, warmup_steps=1)
    got = bench_train("iris-linear", bench_steps=2, warmup_steps=1,
                      device="cpu")
    assert set(got) == set(want) | {"flops_source"}
    assert got["mfu"] is None and got["roofline"] is None
    assert got["backend"] == "cpu" and got["batch_size"] == want["batch_size"]
    assert got["flops_per_step"] > 0 and got["bytes_per_step"] > 0
    row = bench_train("criteo-widedeep", bench_steps=1, warmup_steps=1,
                      batch_size=64, device="cpu")
    assert set(row) == set(got)
    # Sparse: the step moves touched rows, not the 187 MB of tables.
    assert row["bytes_per_step"] < row["param_bytes_per_device"] / 4
