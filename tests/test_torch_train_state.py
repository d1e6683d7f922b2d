"""The port's train-state checkpoints, resume, ``debug_checks``,
``--init-from`` and ``--profile-dir``, held to the JAX package.

A JAX trajectory is carried into the port mid-run: the JAX package's
step (``make_train_step``, or the sparse recsys step) runs N steps on
the same (seed, step)-keyed minibatches ``fit`` draws, its params and
optax state cross by ``params_from_jax`` and ``opt_state_from_jax``
into a port train-state directory, the port's ``fit`` resumes there,
and both take M more steps. Bounds: the JAX→port continuation within
1e-5; the port's own resume against an uninterrupted run bit-equal on
this CPU (the bound stated is 1e-6); ``debug_checks`` raises at step 1.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.train.loop import _make_optimizer as jax_make_optimizer
from mlapi_tpu.train.loop import make_train_step as jax_make_train_step
from mlapi_tpu.train.sparse_embed import make_sparse_recsys_step as jax_sparse
from mlapi_tpu_torch.checkpoint import (
    gc_checkpoints,
    latest_step,
    opt_state_from_jax,
    params_from_jax,
    save_checkpoint,
    step_dir,
)
from mlapi_tpu_torch.config import TrainConfig
from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.train import fit
from mlapi_tpu_torch.train.__main__ import main, parse_args, run

MLP = dict(num_features=784, num_classes=10, hidden_dims=[16])
WIDE = dict(num_dense=3, vocab_sizes=[50, 40, 50], embed_dim=4,
            hidden_dims=[8], num_classes=2, compute_dtype="float32")
KW = dict(batch_size=64, learning_rate=1e-2, seed=3)


@pytest.fixture(scope="module")
def mnist():
    return get_dataset("mnist", synthetic_train=512, synthetic_test=64)


def _mlp(seed=0):
    return get_model("mlp", **MLP, seed=seed, device="cpu")


def _state(result):
    return {k: v.clone() for k, v in result.params.items()}


def _steps(root):
    return sorted(p.name for p in root.iterdir() if p.name.startswith("step_"))


def test_resume_matches_uninterrupted_run(mnist, tmp_path):
    full = _state(fit(_mlp(), mnist, steps=60, optimizer="adamw", **KW))
    ck = tmp_path / "state"
    fit(_mlp(), mnist, steps=30, optimizer="adamw", checkpoint_dir=str(ck),
        save_every=10, **KW)
    # save_every skips the last step: the newest committed state is 20.
    assert _steps(ck) == ["step_00000010", "step_00000020"]
    resumed = fit(_mlp(), mnist, steps=60, optimizer="adamw",
                  checkpoint_dir=str(ck), save_every=10, **KW)
    assert resumed.start_step == 20 and len(resumed.step_losses) == 40
    for key, want in full.items():
        got = resumed.params[key]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=key)
        assert torch.equal(got, want), key   # exact on this CPU


def test_resume_guards(mnist, tmp_path):
    ck = tmp_path / "state"
    fit(_mlp(), mnist, steps=20, optimizer="adam", checkpoint_dir=str(ck),
        save_every=10, **KW)
    with pytest.raises(ValueError, match="different hyperparameters"):
        fit(_mlp(), mnist, steps=40, optimizer="adam", checkpoint_dir=str(ck),
            save_every=10, **{**KW, "learning_rate": 1e-3})
    with pytest.raises(ValueError, match="already at step 10"):
        fit(_mlp(), mnist, steps=10, optimizer="adam", checkpoint_dir=str(ck),
            save_every=10, **KW)
    # resume=False starts fresh: the same as a run with no state at all.
    fresh = fit(_mlp(), mnist, steps=5, optimizer="adam",
                checkpoint_dir=str(ck), resume=False, **KW)
    plain = fit(_mlp(), mnist, steps=5, optimizer="adam", **KW)
    assert fresh.start_step == 0 and fresh.step_losses == plain.step_losses


def test_keep_last_and_uncommitted_dirs(mnist, tmp_path):
    ck = tmp_path / "state"
    fit(_mlp(), mnist, steps=50, optimizer="sgd", checkpoint_dir=str(ck),
        save_every=10, keep_last=2, **KW)
    assert _steps(ck) == ["step_00000030", "step_00000040"]
    # An uncommitted dir (a save in progress) is neither a resume point
    # nor the collector's to delete.
    (ck / "step_00000099").mkdir()
    (ck / "notes").mkdir()
    assert latest_step(ck).name == "step_00000040"
    assert [p.name for p in gc_checkpoints(ck, 1)] == ["step_00000030"]
    assert sorted(p.name for p in ck.iterdir()) == [
        "notes", "step_00000040", "step_00000099"]
    manifest = json.loads((ck / "step_00000040" / "MANIFEST.json").read_text())
    assert manifest["config"]["kind"] == "train_state"
    assert manifest["step"] == 40


def test_async_save_writes_what_sync_writes(mnist, tmp_path):
    kw = dict(steps=30, optimizer="adamw", save_every=10, **KW)
    a = fit(_mlp(), mnist, checkpoint_dir=str(tmp_path / "sync"),
            async_save=False, **kw)
    b = fit(_mlp(), mnist, checkpoint_dir=str(tmp_path / "async"),
            async_save=True, **kw)
    assert a.step_losses == b.step_losses
    assert _steps(tmp_path / "sync") == _steps(tmp_path / "async") == [
        "step_00000010", "step_00000020"]
    for step in _steps(tmp_path / "sync"):
        for name in ("params.npz", "opt_state.npz"):
            with np.load(tmp_path / "sync" / step / name) as x, \
                    np.load(tmp_path / "async" / step / name) as y:
                assert x.files == y.files
                for k in x.files:
                    assert np.array_equal(x[k], y[k]), (step, name, k)


def _tiny_criteo(n=256, seed=0):
    rng = np.random.default_rng(seed)

    class Splits:
        x_train = np.concatenate(
            [rng.normal(size=(n, 3)).astype(np.float32),
             rng.integers(0, 40, (n, 3)).astype(np.float32)], axis=1)
        y_train = rng.integers(0, 2, n).astype(np.int32)
        x_test = x_train[:32]
        y_test = y_train[:32]
        extras = {}

    return Splits()


@pytest.mark.parametrize("optimizer", ["adamw", "recsys-adamw",
                                       "recsys-sparse-adamw"])
def test_jax_train_state_continues_in_port(optimizer, tmp_path):
    """JAX steps to N = 4, its params and optax state cross into a port
    train-state directory, then both take M = 4 more steps. At a rate of
    1e-3: Adam moves an element whose gradient is near zero by about the
    rate whatever the gradient's rounding (``test_torch_bert_train``)."""
    n_steps, m_steps, lr, seed, bs = 4, 4, 1e-3, 1, 32
    if optimizer == "adamw":
        splits = get_dataset("mnist", synthetic_train=256, synthetic_test=32)
        name, cfg = "mlp", MLP
    else:
        splits = _tiny_criteo()
        name, cfg = "wide_deep", WIDE
    jm = jax_get_model(name, **cfg)
    params = jm.init(jax.random.key(seed))
    if optimizer == "recsys-sparse-adamw":
        init, step = jax_sparse(jm, jax_make_optimizer("adamw", lr), lr)
    else:
        tx = jax_make_optimizer(optimizer, lr, model=jm, params=params)
        init, step = tx.init, jax_make_train_step(jm.apply, tx)
    opt_state = init(params)
    x_all, y_all = splits.x_train, np.asarray(splits.y_train, np.int32)

    def batch(i):
        idx = np.random.default_rng((seed, i)).choice(len(x_all), size=bs,
                                                      replace=False)
        return jnp.asarray(x_all[idx]), jnp.asarray(y_all[idx])

    for i in range(n_steps):
        params, opt_state, _ = step(params, opt_state, *batch(i))
    np_params = jax.tree.map(np.asarray, params)
    flat = opt_state_from_jax(jax.tree.map(np.asarray, opt_state))
    assert flat["count"] == n_steps
    assert any(k.startswith("acc/") for k in flat) == (optimizer != "adamw")
    root = tmp_path / "state"
    run_config = {"optimizer": optimizer, "learning_rate": lr,
                  "weight_decay": 0.0, "batch_size": bs, "seed": seed,
                  "task": "classify"}
    save_checkpoint(step_dir(root, n_steps), params_from_jax(np_params),
                    step=n_steps, config={"kind": "train_state", **run_config},
                    opt_state=flat)
    for i in range(n_steps, n_steps + m_steps):
        params, opt_state, _ = step(params, opt_state, *batch(i))

    model = get_model(name, **cfg, seed=0, device="cpu")
    got = fit(model, splits, steps=n_steps + m_steps, batch_size=bs,
              learning_rate=lr, optimizer=optimizer, seed=seed,
              checkpoint_dir=str(root))
    assert got.start_step == n_steps
    want = params_from_jax(jax.tree.map(np.asarray, params))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


def test_debug_checks_raise_at_step_one():
    class Poisoned:
        x_train = np.zeros((32, 4), np.float32)
        y_train = np.zeros((32,), np.int64)
        x_test = np.zeros((0, 4), np.float32)
        y_test = np.zeros((0,), np.int64)

    Poisoned.x_train[3, 2] = np.nan          # one bad feature row
    model = get_model("linear", num_features=4, num_classes=3, device="cpu")
    with pytest.raises(FloatingPointError, match=r"(?i)nan.*at step 1$"):
        fit(model, Poisoned(), steps=5, debug_checks=True)
    # A NaN produced inside the step (inf - inf in the forward) names
    # the op that produced it.
    Poisoned.x_train[3, 2] = 0.0
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["w"][0, 0] = float("inf")
    state["w"][1, 0] = float("-inf")
    Poisoned.x_train[:, :2] = 1.0
    with pytest.raises(FloatingPointError,
                       match=r"op aten\.\S+ produced a NaN at step 1$"):
        fit(model, Poisoned(), steps=5, debug_checks=True, init_params=state)


def _tiny_gpt_cfg(**kw):
    model_kwargs = dict(vocab_size=260, hidden_size=32, num_layers=1,
                        num_heads=2, max_positions=64,
                        compute_dtype="float32")
    model_kwargs.update(kw)
    return TrainConfig(name="tiny-gpt", model="gpt_lm",
                       model_kwargs=model_kwargs, dataset="docs_text",
                       dataset_kwargs={"seq_len": 32}, steps=2,
                       batch_size=8, optimizer="adamw", learning_rate=1e-3)


def test_init_from_loads_and_a_mismatch_raises(tmp_path):
    base = tmp_path / "base"
    run(_tiny_gpt_cfg(), str(base), device="cpu")
    summary = run(_tiny_gpt_cfg(), str(tmp_path / "tuned"),
                  init_from=str(base), device="cpu")
    # Starting from the trained weights, not the seeded init: the first
    # loss is below the fresh run's.
    fresh = run(_tiny_gpt_cfg(), None, device="cpu")
    assert summary["first_loss"] < fresh["first_loss"]
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        run(_tiny_gpt_cfg(hidden_size=16), None, init_from=str(base),
            device="cpu")


def test_cli_profile_dir_writes_a_trace_and_resume_flags(tmp_path, monkeypatch,
                                                         capsys):
    monkeypatch.setenv("MLAPI_TPU_PLATFORM", "cpu")
    out = tmp_path / "gpt"
    main(["--preset", "docs-gpt", "--steps", "3", "--out", str(out),
          "--save-every", "1", "--keep-last", "1", "--profile-dir",
          str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("aten::mm" in e.get("name", "")
               for e in trace["traceEvents"])
    state = tmp_path / "gpt_train_state"
    assert _steps(state) == ["step_00000002"]
    capsys.readouterr()
    # The same command again resumes from step 2 and runs one step.
    main(["--preset", "docs-gpt", "--steps", "3", "--out", str(out),
          "--save-every", "1"])
    assert json.loads(capsys.readouterr().out)["start_step"] == 2
    shutil.rmtree(out)
    main(["--preset", "docs-gpt", "--steps", "1", "--out", str(out),
          "--save-every", "1", "--no-resume"])
    assert json.loads(capsys.readouterr().out)["start_step"] == 0


@pytest.mark.parametrize("argv,why", [
    (["--mesh-shape", "2,4"], "Queue A item 8"),
    (["--bench", "--bench-attn", "ring"], "Queue A item 8"),
    # Served since Queue A item 5: the flag parses as the JAX CLI's.
    (["--lora-rank", "4"], "Queue A item 5"),
    (["--from-hf", "bert-dir"], "not in the repository"),
])
def test_cli_refusals_name_why(argv, why, capsys):
    if why == "Queue A item 5":
        cfg, kwargs = parse_args(["--preset", "docs-gpt", *argv])
        assert cfg.name == "docs-gpt" and kwargs["lora_rank"] == 4
        assert capsys.readouterr().err == ""
        return
    with pytest.raises(SystemExit):
        main(["--preset", "docs-gpt", *argv])
    assert why in capsys.readouterr().err
