"""Training loop (counterpart of ``mlapi_tpu/train/loop.py``).

The JAX package jit-compiles one pure step (forward, loss, grad, optax
update) and donates the state. Here the model module holds the
parameters and a ``torch.optim`` optimizer its moments; a step runs
eagerly and updates both in place. The loss arithmetic, the optimizer
defaults and the minibatch schedule are the JAX package's, so the same
weights and the same seed follow the same trajectory (to rounding).

Beyond plain fitting: knowledge distillation from a teacher checkpoint,
``debug_checks`` (the counterpart of checkify's float checks), the
``recsys-<base>`` and ``recsys-sparse-<base>`` optimizers, train-state
checkpoints with resume (``save_every``, ``keep_last``, ``async_save``),
``profile_dir`` (a ``torch.profiler`` trace) and LoRA fine-tuning (a
``models/lora.LoraModel``: the optimizer holds its adapters alone, so
the frozen base gets no update and no moments, optax's ``masked``).
Refused, with the ROADMAP item that will bring it: a device mesh (Queue
A item 8).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from mlapi_tpu_torch.train.optimizers import (
    partitioned,
    state_from_flat,
    state_tensors,
    state_to_flat,
)


@dataclass
class TrainResult:
    params: Any               # the trained model's state dict
    final_loss: float
    test_accuracy: float | None
    steps: int
    wall_seconds: float
    history: list[dict] = field(default_factory=list)
    # Per step this process ran (from ``start_step``, past a resumed
    # train state): the loss and the wall time from the end of the
    # previous step (batch draw and upload, forward, backward, update,
    # device sync), in ms.
    step_losses: list[float] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)
    start_step: int = 0
    # Bytes of the optimizer's moments at the end (a LoRA run's: the
    # adapters' alone).
    opt_state_bytes: int = 0


# Ops whose output is uninitialised memory: a NaN there is not produced.
_UNINITIALISED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                  torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                  torch.ops.aten.new_empty_strided}


class _NanWatch(TorchDispatchMode):
    """Every op's floating outputs get a device-side "holds a NaN" flag,
    read once after the step (one host sync a step), so the first op
    that produced a NaN is named without waiting on the device per op.
    Forward, backward (the autograd engine carries the mode) and the
    optimizer update all run under it."""

    def __init__(self):
        super().__init__()
        self.flags: list[tuple[Any, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel()):
                    self.flags.append((func, torch.isnan(t).any()))
        return out


def _first_bad(checks: list[tuple[str, torch.Tensor]],
               device) -> str | None:
    """The name of the first check whose flag is set (one host sync; a
    flag of a host tensor, such as an optimizer's step count, moves to
    ``device`` first)."""
    if not checks:
        return None
    flags = torch.stack([f.to(device) for _, f in checks])
    hit = torch.nonzero(flags.cpu())
    return checks[int(hit[0, 0])][0] if len(hit) else None


def make_train_step(
    apply_fn: Callable,
    params,
    optimizer,
    *,
    weight_decay: float = 0.0,
    debug_checks: bool = False,
    task: str = "classify",
    teacher: Callable | None = None,
    distill_temperature: float = 2.0,
    distill_alpha: float = 0.5,
) -> Callable:
    """A step ``(x, y) -> loss`` that updates ``params`` (``{name:
    parameter}``, the names for errors) in place through ``optimizer``.

    ``task="classify"``: softmax cross-entropy against class ids ``y``.
    ``task="lm"``: next-token cross-entropy, ``y`` the ``[B, L]`` ids,
    targets shifted one left, pad positions (id 0) out of the mean.
    ``weight_decay`` adds ``0.5 * weight_decay * sum(p**2)`` over
    weight matrices (``ndim >= 2``), never biases — sklearn's L2
    convention, on top of any decay the optimizer does itself.

    ``teacher`` (the teacher's ``apply``) distills: the loss becomes
    ``alpha * hard + (1 - alpha) * T^2 * KL(teacher_T || student_T)``,
    both distributions softened by ``distill_temperature``, over the
    same positions as the hard loss. The teacher runs under
    ``torch.no_grad()``, so its forward keeps no autograd residuals.

    ``debug_checks=True``: a NaN produced by any op of the step (the
    forward, the backward, the optimizer update), or a non-finite loss,
    gradient or optimizer moment, raises ``FloatingPointError`` naming
    the first bad op or tensor, at that step. Costs a host sync and a
    flag per op, so it is a debug mode.
    """
    if task not in ("classify", "lm"):
        raise ValueError(f"unknown task {task!r}")
    matrices = [p for p in params.values() if p.ndim >= 2]
    temp = distill_temperature

    def soft_kl(t_logits, s_logits):
        """Per-position KL(teacher_T || student_T)."""
        t_logp = F.log_softmax(t_logits / temp, dim=-1)
        return torch.sum(t_logp.exp()
                         * (t_logp - F.log_softmax(s_logits / temp, dim=-1)),
                         dim=-1)

    def blend(hard, soft):
        return (distill_alpha * hard
                + (1.0 - distill_alpha) * (temp * temp) * soft)

    def teacher_logits(x):
        with torch.no_grad():
            return teacher(x).to(torch.float32)

    def loss_fn(x, y):
        logits = apply_fn(x).to(torch.float32)
        if task == "lm":
            targets = y[:, 1:].long()
            keep = (targets != 0).to(torch.float32)
            denom = torch.clamp(keep.sum(), min=1.0)
            s = logits[:, :-1]
            ce = F.cross_entropy(s.transpose(1, 2), targets,
                                 reduction="none")
            loss = (ce * keep).sum() / denom
            if teacher is not None:
                t = teacher_logits(x)[:, :-1]
                loss = blend(loss, (soft_kl(t, s) * keep).sum() / denom)
        else:
            loss = F.cross_entropy(logits, y.long())
            if teacher is not None:
                loss = blend(loss, soft_kl(teacher_logits(x), logits).mean())
        if weight_decay:
            l2 = sum(torch.sum(p * p) for p in matrices)
            loss = loss + 0.5 * weight_decay * l2
        return loss

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    if not debug_checks:
        return step
    names = {p: n for n, p in params.items()}

    def checked_step(x, y):
        watch = _NanWatch()
        with watch:
            loss = step(x, y)
        checks = ([("the batch's features hold a NaN", torch.isnan(x).any())]
                  if x.is_floating_point() else [])
        checks += [(f"op {func} produced a NaN", flag)
                   for func, flag in watch.flags]
        checks.append(("the loss is non-finite (nan or inf)",
                       ~torch.isfinite(loss)))
        checks += [(f"the gradient of {n} is non-finite (nan or inf)",
                    ~torch.isfinite(p.grad).all())
                   for n, p in params.items() if p.grad is not None]
        checks += [(f"the optimizer moment {key} is non-finite (nan or inf)",
                    ~torch.isfinite(t).all())
                   for key, t in state_tensors(optimizer, names)]
        bad = _first_bad(checks, loss.device)
        if bad is not None:
            raise FloatingPointError(f"debug_checks: {bad}")
        return loss

    return checked_step


def _make_optimizer(name: str, learning_rate: float, params, *,
                    model=None):
    """The optax optimizer ``name`` as its ``torch.optim`` equal, at
    optax's defaults: ``adam`` (b1 0.9, b2 0.999, eps 1e-8), ``adamw``
    (the same, decoupled weight decay 1e-4 on every parameter, biases
    too, as optax's ``adamw``) and ``sgd`` (no momentum); or
    ``recsys-<base>``: the tables ``model.optimizer_partitions()`` labels
    take rowwise AdaGrad, the rest ``<base>`` (``train/optimizers.py``).
    ``recsys-sparse-<base>`` is built at the step level
    (``train/sparse_embed.py``), not here."""
    if name.startswith("recsys-sparse-"):
        raise ValueError(
            f"{name!r} is a step-level optimizer (sparse embedding "
            "updates), not an optimizer over dense gradients; use "
            "train.fit / the train CLI, or make_sparse_recsys_step directly"
        )
    if name.startswith("recsys-"):
        if model is None or not hasattr(model, "optimizer_partitions"):
            raise ValueError(
                f"optimizer {name!r} needs a model with "
                "optimizer_partitions(); "
                f"{type(model).__name__ if model else 'no model'} has none"
            )
        base = name[len("recsys-"):]
        return partitioned(
            model, lambda ps: _make_optimizer(base, learning_rate, ps),
            learning_rate)
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    raise ValueError(
        f"unknown optimizer {name!r} (ported: adam, adamw, sgd, "
        "recsys-<base>, recsys-sparse-<base>)"
    )


def _make_sparse_step(name: str, learning_rate: float, model, *,
                      task: str = "classify", weight_decay: float = 0.0):
    """``(optimizer, step)`` of ``recsys-sparse-<base>`` for ``model``
    (``train/sparse_embed.py``)."""
    from mlapi_tpu_torch.train.sparse_embed import make_sparse_recsys_step

    base = name[len("recsys-sparse-"):]
    return make_sparse_recsys_step(
        model, lambda ps: _make_optimizer(base, learning_rate, ps),
        learning_rate, task=task, weight_decay=weight_decay)


def _as_input(x: np.ndarray, device) -> torch.Tensor:
    t = torch.as_tensor(x)
    return (t if t.is_floating_point() else t.long()).to(device)


@torch.no_grad()
def evaluate(apply_fn: Callable, x, y, *, device,
             batch_size: int = 4096) -> float:
    """Held-out accuracy, in ``batch_size`` chunks."""
    x, y = np.asarray(x), np.asarray(y)
    n = len(x)
    if n == 0:
        return float("nan")
    correct = 0
    for s in range(0, n, batch_size):
        pred = apply_fn(_as_input(x[s:s + batch_size], device)).argmax(-1)
        correct += int((pred == _as_input(y[s:s + batch_size], device))
                       .sum())
    return correct / n


@torch.no_grad()
def evaluate_lm(apply_fn: Callable, x, *, device,
                batch_size: int = 256) -> float:
    """Held-out next-token top-1 accuracy over ``[N, L]`` sequences,
    pad (id 0) positions excluded."""
    x = np.asarray(x)
    n = len(x)
    if n == 0:
        return float("nan")
    correct = total = 0
    for s in range(0, n, batch_size):
        chunk = _as_input(x[s:s + batch_size], device)
        pred = apply_fn(chunk).argmax(-1)[:, :-1]
        targets = chunk[:, 1:]
        keep = targets != 0
        correct += int(((pred == targets) & keep).sum())
        total += int(keep.sum())
    return correct / max(total, 1)


def _host_params(model) -> dict[str, torch.Tensor]:
    """A host copy of the model's state dict (the training that goes on
    updates the live tensors in place)."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def _save_train_state(root, params, opt_state: dict, step: int,
                      run_config: dict, keep_last: int = 0) -> None:
    """Write the full train state (params and optimizer moments) as
    ``root/step_%08d``; with ``keep_last``, older committed steps are
    collected after the new one commits."""
    from mlapi_tpu_torch.checkpoint import gc_checkpoints, save_checkpoint
    from mlapi_tpu_torch.checkpoint.io import step_dir

    save_checkpoint(step_dir(root, step), params, step=step,
                    config={"kind": "train_state", **run_config},
                    opt_state=opt_state)
    if keep_last:
        gc_checkpoints(root, keep_last)


def _maybe_resume(root, model, optimizer, names: dict,
                  run_config: dict) -> int:
    """Restore the newest committed train state under ``root`` into
    ``model`` and ``optimizer``, if there is one; returns the step to
    start from. The checkpoint's recorded hyperparameters must match
    this run's (read from the manifest, before the tensors)."""
    from mlapi_tpu_torch.checkpoint import (
        latest_step,
        load_checkpoint,
        load_opt_state,
        read_manifest,
    )
    from mlapi_tpu_torch.utils.logging import get_logger

    log = get_logger("train.loop")
    newest = latest_step(root)
    if newest is None:
        return 0
    meta = read_manifest(newest)
    diff = {
        k: (meta.config[k], run_config[k])
        for k in run_config
        if k in meta.config and meta.config[k] != run_config[k]
    }
    if diff:
        raise ValueError(
            f"refusing to resume from {newest}: checkpoint was written "
            f"with different hyperparameters (checkpoint vs requested: "
            f"{diff}). Match the original config, or pass resume=False "
            "/ --no-resume to start fresh."
        )
    unchecked = [k for k in run_config if k not in meta.config]
    if unchecked:
        log.warning(
            "resuming from %s: checkpoint predates hyperparameter "
            "recording; cannot verify %s match the original run",
            newest, unchecked,
        )
    log.info("resuming from %s", newest)
    state, meta = load_checkpoint(newest, model)   # checks the signature
    model.load_state_dict(state)
    state_from_flat(optimizer, names, load_opt_state(newest))
    return meta.step


def _load_teacher(path, device):
    """The teacher of a distillation run: the checkpoint's own model
    config, its weights, eval mode, frozen, on ``device``. Returns
    ``(model, config_hash)``."""
    from mlapi_tpu_torch.checkpoint import load_checkpoint, read_manifest
    from mlapi_tpu_torch.models import get_model

    meta = read_manifest(path)
    model = get_model(meta.config["model"],
                      **meta.config.get("model_kwargs", {}), seed=None,
                      device=device)
    state, meta = load_checkpoint(path, model)
    model.load_state_dict(state)
    model.eval()
    model.requires_grad_(False)
    return model, meta.config_hash


def fit(
    model,
    splits,
    *,
    steps: int = 500,
    batch_size: int | None = None,
    learning_rate: float = 0.1,
    weight_decay: float = 0.0,
    optimizer: str = "adam",
    seed: int = 0,
    mesh=None,
    eval_every: int = 0,
    checkpoint_dir: str | None = None,
    save_every: int = 0,
    keep_last: int = 0,
    async_save: bool = True,
    resume: bool = True,
    profile_dir: str | None = None,
    debug_checks: bool = False,
    task: str = "auto",
    init_params=None,
    distill_from: str | None = None,
    distill_temperature: float = 2.0,
    distill_alpha: float = 0.5,
) -> TrainResult:
    """Train ``model`` (an ``nn.Module`` with ``apply``) on ``splits``,
    in place, on the model's device.

    ``task="auto"`` takes the dataset's ``extras["task"]``, else
    ``"lm"`` for ``[N, L]`` labels and ``"classify"`` for ``[N]``.
    ``batch_size=None`` runs full-batch steps. The minibatch of step
    ``i`` is a pure function of ``(seed, i)`` — the same numpy indices
    as the JAX package — so a resumed run replays the batches an
    uninterrupted one would have seen. ``init_params`` (a state dict)
    replaces the model's weights first. A non-finite loss raises at each
    ``eval_every`` point, before a save and at the end.

    ``checkpoint_dir`` + ``save_every``: every ``save_every`` steps (not
    the last) the full train state is written to
    ``checkpoint_dir/step_%08d``; a rerun resumes from the newest
    committed one (``resume=False`` starts fresh; a state already at or
    past ``steps`` raises). ``keep_last=N`` keeps the newest N committed
    steps. ``async_save`` copies the state to the host at the save point
    and writes it on one background thread, one save in flight; a
    failed save raises at the next save point or at the end.

    ``distill_from``: a checkpoint whose model teaches (see
    :func:`make_train_step`). ``profile_dir``: the loop runs under
    ``torch.profiler`` and its Chrome trace is written to
    ``profile_dir/trace.json``. ``optimizer="recsys-sparse-<base>"``
    trains embedding tables with sparse rowwise-AdaGrad row updates
    (``train/sparse_embed.py``).
    """
    if mesh is not None:
        raise NotImplementedError(
            "training on a device mesh is not ported (ROADMAP Queue A item 8)"
        )
    if task == "auto":
        task = getattr(splits, "extras", {}).get(
            "task",
            "lm" if np.asarray(splits.y_train).ndim == 2 else "classify",
        )
    sparse_embed = optimizer.startswith("recsys-sparse-")
    if sparse_embed:
        if distill_from is not None:
            raise ValueError(
                "recsys-sparse-* cannot distill: the teacher loss "
                "needs the full forward's dense gradient path"
            )
        if debug_checks:
            raise ValueError(
                "recsys-sparse-* does not support --debug-checks; "
                "use the dense recsys-<base> path to checkify"
            )
        if hasattr(model, "trainable_mask"):
            raise ValueError(
                "recsys-sparse-* cannot train a parameter-efficient "
                "(LoRA) wrapper: the sparse step bypasses "
                "trainable_mask; fine-tune with the dense "
                "recsys-<base> path instead"
            )
    if init_params is not None:
        model.load_state_dict(init_params)
    device = model.device
    every = dict(model.named_parameters())
    # A LoRA wrapper trains its adapters alone: the optimizer never sees
    # the frozen base, which keeps requires_grad off.
    mask = (model.trainable_mask() if hasattr(model, "trainable_mask")
            else dict.fromkeys(every, True))
    named = {n: p for n, p in every.items() if mask[n]}
    names = {p: n for n, p in named.items()}
    for p in named.values():
        p.requires_grad_(True)

    if sparse_embed:
        opt, step_fn = _make_sparse_step(optimizer, learning_rate, model,
                                         task=task, weight_decay=weight_decay)
    else:
        opt = _make_optimizer(optimizer, learning_rate, named.values(),
                              model=model)

    teacher = teacher_hash = None
    if distill_from is not None:
        teacher, teacher_hash = _load_teacher(distill_from, device)
    # The hyperparameters that define the trajectory; a resumed run must
    # match them (steps may grow).
    run_config = {
        "optimizer": optimizer,
        "learning_rate": learning_rate,
        "weight_decay": weight_decay,
        "batch_size": batch_size,
        "seed": seed,
        "task": task,
        **({"distill_from_hash": teacher_hash,
            "distill_temperature": distill_temperature,
            "distill_alpha": distill_alpha} if teacher is not None else {}),
    }
    start_step = 0
    if checkpoint_dir and resume:
        start_step = _maybe_resume(checkpoint_dir, model, opt, names,
                                   run_config)
        if start_step >= steps:
            raise ValueError(
                f"resumed train state is already at step {start_step}, past "
                f"the requested {steps} steps — raise --steps or pass "
                "resume=False / --no-resume"
            )
    if not sparse_embed:
        # ``every``: the L2 term sums all weight matrices, a frozen
        # base's too, as the JAX loss does (it adds no gradient).
        step_fn = make_train_step(
            model.apply, every, opt, weight_decay=weight_decay,
            debug_checks=debug_checks, task=task,
            teacher=teacher.apply if teacher is not None else None,
            distill_temperature=distill_temperature,
            distill_alpha=distill_alpha,
        )

    def eval_fn():
        if task == "lm":
            return evaluate_lm(model.apply, splits.x_test, device=device)
        return evaluate(model.apply, splits.x_test, splits.y_test,
                        device=device)

    x_all = np.asarray(splits.x_train)
    y_all = np.asarray(splits.y_train, dtype=np.int32)
    n = len(x_all)

    def batch_at(i: int):
        """Minibatch for step ``i``: a pure function of (seed, i)."""
        if batch_size is None or batch_size >= n:
            return x_all, y_all
        idx = np.random.default_rng((seed, i)).choice(
            n, size=batch_size, replace=False
        )
        return x_all[idx], y_all[idx]

    saving = bool(checkpoint_dir and save_every)
    save_pool = (concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="ckpt-save")
        if saving and async_save else None)
    pending_save = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler_cm = profile(activities=acts)
    else:
        profiler_cm = contextlib.nullcontext()

    history: list[dict] = []
    losses: list[float] = []
    step_ms: list[float] = []
    loss = float("nan")
    t0 = last = time.perf_counter()
    try:
        with profiler_cm as prof:
            for i in range(start_step, steps):
                x, y = batch_at(i)
                try:
                    # float() waits for the step to finish on the device.
                    loss = float(step_fn(_as_input(x, device),
                                         _as_input(y, device)))
                except FloatingPointError as e:
                    raise FloatingPointError(f"{e} at step {i + 1}") from None
                now = time.perf_counter()
                losses.append(loss)
                step_ms.append((now - last) * 1e3)
                last = now
                if eval_every and (i + 1) % eval_every == 0:
                    if not np.isfinite(loss):
                        raise FloatingPointError(
                            f"non-finite loss {loss} at step {i + 1}"
                        )
                    history.append({"step": i + 1, "loss": loss,
                                    "test_accuracy": eval_fn()})
                    last = time.perf_counter()
                if saving and (i + 1) % save_every == 0 and i + 1 < steps:
                    if not np.isfinite(loss):
                        raise FloatingPointError(
                            f"refusing to checkpoint non-finite loss {loss} "
                            f"at step {i + 1}"
                        )
                    args = (checkpoint_dir, _host_params(model),
                            state_to_flat(opt, names), i + 1, run_config,
                            keep_last)
                    if save_pool is not None:
                        if pending_save is not None:
                            pending_save.result()   # one in flight
                        pending_save = save_pool.submit(_save_train_state,
                                                        *args)
                    else:
                        _save_train_state(*args)
                    last = time.perf_counter()
        if profile_dir:
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    finally:
        # A failed background save is never dropped, even when the loop
        # raised (the loop's exception then stays chained).
        if save_pool is not None:
            try:
                if pending_save is not None:
                    pending_save.result()
            finally:
                save_pool.shutdown(wait=True)
    wall = time.perf_counter() - t0
    if steps > start_step and not np.isfinite(loss):
        raise FloatingPointError(
            f"training ended with non-finite loss {loss}"
        )
    test_acc = eval_fn() if len(splits.x_test) else None
    return TrainResult(
        params=model.state_dict(),
        final_loss=loss,
        test_accuracy=test_acc,
        steps=steps,
        wall_seconds=wall,
        history=history,
        step_losses=losses,
        step_ms=step_ms,
        start_step=start_step,
        opt_state_bytes=sum(t.numel() * t.element_size()
                            for _, t in state_tensors(opt, names)),
    )
