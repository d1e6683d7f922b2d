"""Knowledge distillation in the port, held to the JAX package's
``make_train_step(teacher=...)`` (``mlapi_tpu/train/loop.py:98-112``).

The same teacher and student weights (``params_from_jax``) and the same
seeded numpy batch go through JAX's distilled step and the port's: the
loss (``alpha * hard + (1 - alpha) * T^2 * KL``, LM positions masked by
pad) and the student's parameters after one AdamW step agree within
1e-5, for ``task="lm"`` (GPT teacher and draft) and ``"classify"`` (an
MLP teacher, a linear student). Then the train CLI: a distilled run's
train state records the teacher's hash, its temperature and alpha, and
``docs-gpt-draft-distilled`` without ``--distill-from`` is refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.train.loop import _make_optimizer as jax_make_optimizer
from mlapi_tpu.train.loop import make_train_step as jax_make_train_step
from mlapi_tpu_torch.checkpoint import params_from_jax, read_manifest
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.train.__main__ import main
from mlapi_tpu_torch.train.loop import _make_optimizer, make_train_step

GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_positions=32, compute_dtype="float32")
DRAFT = dict(GPT, hidden_size=16, num_layers=1)
TEACHERS = {"lm": ("gpt_lm", GPT, "gpt_lm", DRAFT),
            "classify": ("mlp", dict(num_features=8, num_classes=4,
                                     hidden_dims=[16]),
                         "linear", dict(num_features=8, num_classes=4))}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(name, cfg, np_params):
    model = get_model(name, **cfg, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def _batch(task):
    rng = np.random.default_rng(7)
    if task == "lm":
        x = rng.integers(1, 64, (4, 24)).astype(np.int32)
        x[1, 15:] = 0                     # pad positions leave the mean
        return x, x
    return (rng.standard_normal((16, 8)).astype(np.float32),
            rng.integers(0, 4, 16).astype(np.int32))


@pytest.mark.parametrize("task", ["lm", "classify"])
def test_distilled_loss_and_step_match_jax(task):
    t_name, t_cfg, s_name, s_cfg = TEACHERS[task]
    jt, js = jax_get_model(t_name, **t_cfg), jax_get_model(s_name, **s_cfg)
    tp = _np_tree(jt.init(jax.random.key(1)))
    sp = _np_tree(js.init(jax.random.key(2)))
    if task == "classify":
        # JAX's linear init is all zeros: draw a student that disagrees
        # with the teacher, so the KL term is not trivial.
        rng = np.random.default_rng(3)
        sp = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), sp)
    x, y = _batch(task)
    kw = dict(task=task, distill_temperature=2.0, distill_alpha=0.3)
    teacher, student = _port(t_name, t_cfg, tp), _port(s_name, s_cfg, sp)
    teacher.eval().requires_grad_(False)
    named = dict(student.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    opt = _make_optimizer("adamw", 1e-3, named.values())
    step = make_train_step(student.apply, named, opt, teacher=teacher.apply,
                           **kw)
    got_loss = float(step(torch.as_tensor(x).long() if task == "lm"
                          else torch.as_tensor(x), torch.as_tensor(y)))

    tx = jax_make_optimizer("adamw", 1e-3)
    jstep = jax_make_train_step(js.apply, tx, teacher=(jt.apply, tp), **kw)
    new_p, _, want_loss = jstep(jax.tree.map(jnp.asarray, sp),
                                tx.init(sp), jnp.asarray(x), jnp.asarray(y))
    assert got_loss == pytest.approx(float(want_loss), abs=1e-5)
    # The hard loss alone differs: the KL term is live.
    hard = _port(s_name, s_cfg, sp).requires_grad_(True)
    named = dict(hard.named_parameters())
    plain = float(make_train_step(
        hard.apply, named, _make_optimizer("sgd", 0.0, named.values()),
        task=task)(torch.as_tensor(x).long() if task == "lm"
                   else torch.as_tensor(x), torch.as_tensor(y)))
    assert abs(plain - got_loss) > 1e-3
    want = params_from_jax(_np_tree(new_p))
    for key, p in student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
    # The teacher's forward kept no autograd graph.
    assert teacher.apply(torch.as_tensor(x[:1]).long() if task == "lm"
                         else torch.as_tensor(x[:1])).requires_grad is False


def test_distilled_run_through_the_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MLAPI_TPU_PLATFORM", "cpu")
    teacher = tmp_path / "teacher"
    main(["--preset", "docs-gpt", "--steps", "2", "--out", str(teacher)])
    with pytest.raises(SystemExit):
        main(["--preset", "docs-gpt-draft-distilled", "--steps", "2"])
    assert "DISTILLATION config" in capsys.readouterr().err
    draft = tmp_path / "draft"
    main(["--preset", "docs-gpt-draft-distilled", "--steps", "3",
          "--out", str(draft), "--distill-from", str(teacher),
          "--save-every", "2"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    config = read_manifest(tmp_path / "draft_train_state" /
                           "step_00000002").config
    assert config["distill_from_hash"] == read_manifest(teacher).config_hash
    assert (config["distill_temperature"], config["distill_alpha"]) == (
        2.0, 0.1)
    # The finished draft is a plain gpt_lm checkpoint of the draft's width.
    assert read_manifest(draft).config["model_kwargs"]["hidden_size"] == 48
