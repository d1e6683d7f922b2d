"""Training loop (counterpart of ``mlapi_tpu/train/loop.py``).

The JAX package jit-compiles one pure step (forward, loss, grad, optax
update) and donates the state. Here the model module holds the
parameters and a ``torch.optim`` optimizer its moments; a step runs
eagerly and updates both in place. The loss arithmetic, the optimizer
defaults and the minibatch schedule are the JAX package's, so the same
weights and the same seed follow the same trajectory (to rounding).

Not in this slice, each refused with the ROADMAP item that will bring
it: a device mesh (Queue A item 8), train-state checkpoints and resume,
profiling, ``debug_checks``, distillation and the recsys optimizers
(Queue A item 4), LoRA (Queue A item 5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class TrainResult:
    params: Any               # the trained model's state dict
    final_loss: float
    test_accuracy: float | None
    steps: int
    wall_seconds: float
    history: list[dict] = field(default_factory=list)
    # Per step: the loss and the wall time from the end of the previous
    # step (batch draw and upload, forward, backward, update, device
    # sync), in ms.
    step_losses: list[float] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)


def make_train_step(
    apply_fn: Callable,
    params,
    optimizer: torch.optim.Optimizer,
    *,
    weight_decay: float = 0.0,
    debug_checks: bool = False,
    task: str = "classify",
    teacher: tuple | None = None,
) -> Callable:
    """A step ``(x, y) -> loss`` that updates ``params`` in place through
    ``optimizer``.

    ``task="classify"``: softmax cross-entropy against class ids ``y``.
    ``task="lm"``: next-token cross-entropy, ``y`` the ``[B, L]`` ids,
    targets shifted one left, pad positions (id 0) out of the mean.
    ``weight_decay`` adds ``0.5 * weight_decay * sum(p**2)`` over
    weight matrices (``ndim >= 2``), never biases — sklearn's L2
    convention, on top of any decay the optimizer does itself.
    """
    if task not in ("classify", "lm"):
        raise ValueError(f"unknown task {task!r}")
    if debug_checks:
        raise NotImplementedError(
            "debug_checks (checkify) is not ported (ROADMAP Queue A item 4)"
        )
    if teacher is not None:
        raise NotImplementedError(
            "distillation is not ported (ROADMAP Queue A item 4)"
        )
    matrices = [p for p in params if p.ndim >= 2]

    def loss_fn(x, y):
        logits = apply_fn(x).to(torch.float32)
        if task == "lm":
            targets = y[:, 1:].long()
            keep = (targets != 0).to(torch.float32)
            denom = torch.clamp(keep.sum(), min=1.0)
            ce = F.cross_entropy(
                logits[:, :-1].transpose(1, 2), targets, reduction="none"
            )
            loss = (ce * keep).sum() / denom
        else:
            loss = F.cross_entropy(logits, y.long())
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

    return step


def _make_optimizer(name: str, learning_rate: float,
                    params) -> torch.optim.Optimizer:
    """The optax optimizer ``name`` as its ``torch.optim`` equal, at
    optax's defaults: ``adam`` (b1 0.9, b2 0.999, eps 1e-8), ``adamw``
    (the same, decoupled weight decay 1e-4 on every parameter, biases
    too, as optax's ``adamw``) and ``sgd`` (no momentum)."""
    params = list(params)
    if name.startswith("recsys-"):
        raise NotImplementedError(
            f"optimizer {name!r} (rowwise AdaGrad tables, sparse embedding "
            "updates) is not ported (ROADMAP Queue A item 4)"
        )
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
        f"unknown optimizer {name!r} (ported: adam, adamw, sgd)"
    )


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
    profile_dir: str | None = None,
    debug_checks: bool = False,
    task: str = "auto",
    init_params=None,
    distill_from: str | None = None,
) -> TrainResult:
    """Train ``model`` (an ``nn.Module`` with ``apply``) on ``splits``,
    in place, on the model's device.

    ``task="auto"`` takes the dataset's ``extras["task"]``, else
    ``"lm"`` for ``[N, L]`` labels and ``"classify"`` for ``[N]``.
    ``batch_size=None`` runs full-batch steps. The minibatch of step
    ``i`` is a pure function of ``(seed, i)`` — the same numpy indices
    as the JAX package. ``init_params`` (a state dict) replaces the
    model's weights first. A non-finite loss raises at each
    ``eval_every`` point and at the end.
    """
    if mesh is not None:
        raise NotImplementedError(
            "training on a device mesh is not ported (ROADMAP Queue A item 8)"
        )
    if checkpoint_dir or save_every or keep_last:
        raise NotImplementedError(
            "train-state checkpoints and resume (checkpoint_dir, "
            "save_every, keep_last) are not ported (ROADMAP Queue A item 4)"
        )
    if profile_dir:
        raise NotImplementedError(
            "profile_dir is not ported (ROADMAP Queue A item 4); "
            "chip_smoke.py profiles a train step with torch.profiler"
        )
    if distill_from is not None:
        raise NotImplementedError(
            "distillation is not ported (ROADMAP Queue A item 4)"
        )
    if hasattr(model, "trainable_mask"):
        raise NotImplementedError(
            "LoRA fine-tuning is not ported (ROADMAP Queue A item 5)"
        )
    if task == "auto":
        task = getattr(splits, "extras", {}).get(
            "task",
            "lm" if np.asarray(splits.y_train).ndim == 2 else "classify",
        )
    if init_params is not None:
        model.load_state_dict(init_params)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    opt = _make_optimizer(optimizer, learning_rate, params)
    step_fn = make_train_step(model.apply, params, opt,
                              weight_decay=weight_decay,
                              debug_checks=debug_checks, task=task)
    device = model.device

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

    history: list[dict] = []
    losses: list[float] = []
    step_ms: list[float] = []
    loss = float("nan")
    t0 = last = time.perf_counter()
    for i in range(steps):
        x, y = batch_at(i)
        # float() waits for the step to finish on the device.
        loss = float(step_fn(_as_input(x, device), _as_input(y, device)))
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
    wall = time.perf_counter() - t0
    if steps > 0 and not np.isfinite(loss):
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
    )
