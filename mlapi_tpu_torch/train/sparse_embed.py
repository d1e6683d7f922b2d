"""Sparse embedding updates: touch only the rows a batch read
(counterpart of ``mlapi_tpu/train/sparse_embed.py``).

Rowwise AdaGrad through the dense path (``recsys-<base>``) already
leaves untouched rows bit-frozen, but it pays for it densely: the
gather's backward writes a full ``[F, V, D]`` table gradient and the
optimizer reads and rewrites every table and its ``[F, V]``
accumulator each step. Here the step takes the gradient with respect
to the gathered rows ``[B, F, D]`` (a leaf tensor fed to the model's
``apply_from_rows``), sums the gradients of duplicate ids, and updates
exactly the touched rows of each table and its accumulator in place.

Duplicate ids are summed as the JAX package sums them: sort the flat
row keys, segment-sum equal keys, and scatter the update and the
accumulator increment at the first occurrence only (the other
occurrences add exact zeros). All shapes are static, so the step never
waits for the host. On a CUDA card ``index_add_`` sums with atomics, so
sums over duplicate ids are not bitwise reproducible from run to run;
untouched rows are bit-frozen all the same.

Constraints, checked when the step is built: classification, no weight
decay (it would touch every row), a model with the sparse-embedding
protocol. Spelled ``optimizer: recsys-sparse-<base>`` in configs.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from mlapi_tpu_torch.train.optimizers import Partitioned, RowwiseAdagrad


@torch.no_grad()
def sparse_rowwise_adagrad_update(table: torch.Tensor, acc: torch.Tensor,
                                  ids: torch.Tensor, occ_grads: torch.Tensor,
                                  *, learning_rate: float,
                                  eps: float = 1e-10) -> None:
    """One rowwise-AdaGrad step on the rows in ``ids``, in place.

    ``table`` ``[F, V, D]`` and ``acc`` ``[F, V]`` (contiguous);
    ``ids`` ``[B, F]``; ``occ_grads`` ``[B, F, D]``, one gradient per
    occurrence (duplicates are summed here, as the dense gather's
    backward sums them)."""
    f, v, d = table.shape
    n = ids.shape[0] * ids.shape[1]
    keys = (ids.long()
            + torch.arange(f, device=ids.device)[None, :] * v).reshape(n)
    g = occ_grads.to(torch.float32).reshape(n, d)
    sk, order = torch.sort(keys)
    g = g[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1
    g_agg = torch.zeros_like(g).index_add_(0, seg, g)[seg]      # [N, D]
    inc = torch.where(first, g_agg.square().mean(dim=-1), 0.0)
    acc_rows = acc.view(f * v)
    acc_rows.index_add_(0, sk, inc)
    denom = (acc_rows[sk] + eps).sqrt()[:, None]
    upd = torch.where(first[:, None], -learning_rate * g_agg / denom, 0.0)
    table.view(f * v, d).index_add_(0, sk, upd.to(table.dtype))


def make_sparse_recsys_step(
    model,
    base: Callable[[list], torch.optim.Optimizer],
    learning_rate: float,
    *,
    task: str = "classify",
    weight_decay: float = 0.0,
    eps: float = 1e-10,
    initial_accumulator_value: float = 0.1,
):
    """``(optimizer, step)`` for a model with the sparse-embedding
    protocol (``split_embeddings`` / ``embedding_ids`` / ``gather_rows``
    / ``apply_from_rows`` / ``merge_embeddings``).

    ``optimizer`` is a :class:`Partitioned`: ``base(dense params)`` and
    a :class:`RowwiseAdagrad` over the tables, whose accumulators the
    step updates sparsely (and which the train state saves like the
    dense path's). ``step(x, y) -> loss`` updates the model in place,
    as ``loop.make_train_step``'s step does."""
    if task != "classify":
        raise ValueError(
            "recsys-sparse-* supports classification steps only "
            f"(got task={task!r})"
        )
    if weight_decay:
        raise ValueError(
            "recsys-sparse-* requires weight_decay=0: decay touches "
            "every table row, which defeats the sparse update (and "
            "decaying unseen embedding rows is the failure mode "
            "rowwise AdaGrad exists to avoid)"
        )
    for proto in ("split_embeddings", "embedding_ids", "gather_rows",
                  "apply_from_rows", "merge_embeddings"):
        if not hasattr(model, proto):
            raise ValueError(
                f"model {type(model).__name__} does not implement the "
                f"sparse-embedding protocol (missing {proto})"
            )
    _, tables = model.split_embeddings(model.params_tree())
    table_ids = {id(t) for t in tables.values()}
    rowwise = RowwiseAdagrad(
        list(tables.values()), learning_rate, eps=eps,
        initial_accumulator_value=initial_accumulator_value)
    dense_opt = base([p for p in model.parameters()
                      if id(p) not in table_ids])
    optimizer = Partitioned({"embedding": rowwise, "default": dense_opt})

    def step(x, y):
        dense, tables = model.split_embeddings(model.params_tree())
        ids = model.embedding_ids(x)
        with torch.no_grad():
            rows = model.gather_rows(tables, ids)
        for r in rows.values():
            r.requires_grad_(True)
        logits = model.apply_from_rows(dense, rows, x)
        loss = F.cross_entropy(logits.to(torch.float32), y.long())
        dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        dense_opt.step()
        for name, table in tables.items():
            sparse_rowwise_adagrad_update(
                table, rowwise.state[table]["acc"], ids, rows[name].grad,
                learning_rate=learning_rate, eps=eps)
        return loss.detach()

    return optimizer, step
