"""Optimizer partitioning for recommender-style models (counterpart of
``mlapi_tpu/train/optimizers.py``), and the optimizers' state in the
train-state checkpoint's flat form.

- :class:`RowwiseAdagrad`: AdaGrad whose accumulator is one scalar per
  embedding row (the mean of the row gradient's squares), ``[F, V]`` for
  a ``[F, V, D]`` table: the Wide&Deep paper's embedding optimizer.
- :func:`partitioned`: parameters the model labels ``"embedding"``
  (``optimizer_partitions``) take rowwise AdaGrad, the rest the base
  optimizer; spelled ``"recsys-<base>"`` in configs.

The JAX package wires these as optax transforms (``multi_transform``);
here each partition is a ``torch.optim.Optimizer`` and
:class:`Partitioned` steps them together.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# torch.optim state key -> the moment's name in the flat train state
# (optax's ScaleByAdamState fields; ``acc`` for rowwise AdaGrad).
_MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu", "acc": "acc"}


class RowwiseAdagrad(torch.optim.Optimizer):
    """AdaGrad with one accumulator per embedding row (the last axis is
    the embedding dim; everything before it indexes rows).

    ``acc += mean(g_row**2)``; ``p -= lr * g / sqrt(acc + eps)``. A row
    whose gradient is zero is bit-frozen: zero adds nothing to its
    accumulator and its update is zero. The accumulators start at
    ``initial_accumulator_value`` (float32) when the optimizer is made.
    """

    def __init__(self, params, lr: float, *, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(
            lr=lr, eps=eps,
            initial_accumulator_value=initial_accumulator_value))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["acc"] = torch.full(
                    p.shape[:-1], float(initial_accumulator_value),
                    dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RowwiseAdagrad takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                acc = self.state[p]["acc"]
                g = p.grad.to(torch.float32)
                acc.add_(g.square().mean(dim=-1))
                update = -group["lr"] * g / (acc + group["eps"]).sqrt()[
                    ..., None]
                p.add_(update.to(p.dtype))


class Partitioned:
    """Several optimizers stepped as one, by partition label (the
    counterpart of optax's ``multi_transform``)."""

    def __init__(self, parts: dict[str, torch.optim.Optimizer]):
        self.parts = parts

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.parts.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.parts.values():
            opt.step()


def partitioned(model, base: Callable[[list], torch.optim.Optimizer],
                learning_rate: float) -> Partitioned:
    """Route each parameter of ``model`` by its
    ``optimizer_partitions()`` label: ``"embedding"`` to
    :class:`RowwiseAdagrad`, ``"default"`` to ``base(params)``."""
    labels = model.optimizer_partitions()
    groups: dict[str, list] = {"embedding": [], "default": []}
    for name, p in model.named_parameters():
        groups[labels[name]].append(p)
    return Partitioned({
        "embedding": RowwiseAdagrad(groups["embedding"], learning_rate),
        "default": base(groups["default"]),
    })


def _leaf_optimizers(optimizer) -> list[torch.optim.Optimizer]:
    if isinstance(optimizer, Partitioned):
        return list(optimizer.parts.values())
    return [optimizer]


def _params(optimizer):
    for opt in _leaf_optimizers(optimizer):
        for group in opt.param_groups:
            for p in group["params"]:
                yield opt, p


def state_tensors(optimizer, names: dict) -> list[tuple[str, torch.Tensor]]:
    """``(moment/path, tensor)`` of every moment ``optimizer`` holds;
    ``names`` maps each parameter to its dotted state-dict name."""
    out = []
    for opt, p in _params(optimizer):
        for key, moment in _MOMENTS.items():
            if key in opt.state.get(p, {}):
                path = names[p].replace(".", "/")
                out.append((f"{moment}/{path}", opt.state[p][key]))
    return out


def state_to_flat(optimizer, names: dict) -> dict[str, np.ndarray]:
    """The optimizer's state as the train state's flat dict
    (``mu/<path>``, ``nu/<path>``, ``acc/<path>``, ``count``): numpy
    copies on the host, so the training that goes on cannot change what
    a background save writes."""
    flat = {key: t.detach().to("cpu", torch.float32, copy=True).numpy()
            for key, t in state_tensors(optimizer, names)}
    counts = {int(opt.state[p]["step"]) for opt, p in _params(optimizer)
              if "step" in opt.state.get(p, {})}
    if len(counts) > 1:
        raise ValueError(f"parameters disagree on the step count: {counts}")
    if counts:
        flat["count"] = np.asarray(counts.pop(), np.int32)
    return flat


def state_from_flat(optimizer, names: dict, flat: dict) -> None:
    """Load the flat train state (:func:`state_to_flat`, or
    ``checkpoint.opt_state_from_jax``) into ``optimizer``. Every key must
    find its parameter and every moment the optimizer keeps must be
    given."""
    used = set()
    for opt in _leaf_optimizers(optimizer):
        state = {}
        index = 0
        keeps = ("acc",) if isinstance(opt, RowwiseAdagrad) else (
            ("exp_avg", "exp_avg_sq")
            if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
            else ())
        for group in opt.param_groups:
            for p in group["params"]:
                path = names[p].replace(".", "/")
                entry = {}
                for key in keeps:
                    name = f"{_MOMENTS[key]}/{path}"
                    if name not in flat:
                        raise ValueError(f"optimizer state lacks {name!r}")
                    entry[key] = torch.as_tensor(np.asarray(flat[name]))
                    used.add(name)
                if "exp_avg" in entry:
                    entry["step"] = torch.tensor(float(flat["count"]),
                                                 dtype=torch.float32)
                    used.add("count")
                if entry:
                    state[index] = entry
                index += 1
        opt.load_state_dict({"state": state,
                             "param_groups": opt.state_dict()["param_groups"]})
    extra = set(flat) - used
    if extra:
        raise ValueError(
            f"optimizer state has entries no parameter takes: {sorted(extra)}"
        )
