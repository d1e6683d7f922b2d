"""Training throughput bench: step time, examples/s and MFU (counterpart
of ``mlapi_tpu/train/bench.py``, the same row keys).

For one preset it times the step ``fit`` runs (the same
``make_train_step`` or sparse recsys step): warm-up steps, then
``bench_steps`` steps back to back and one device sync (the loss read)
at the end. The row:

- ``step_ms``, ``examples_per_s``: per optimizer step;
- ``flops_per_step``, ``bytes_per_step``: counted over the first
  warm-up step (forward, backward, optimizer update). The JAX package
  reads XLA's ``cost_analysis()``; the port counts the aten ops it
  dispatches: FLOPs with ``torch.utils.flop_counter.FlopCounterMode``,
  bytes as every op's tensor inputs read once and outputs written once.
  The flash kernels (B5-B7) launch through ``ctypes`` and are invisible
  to both, so their FLOPs are added from the attention shapes: forward
  ``4·B·H·Lq·Lk·D``, backward 2.5× the forward, half of each when
  causal. ``flops_source`` says which counts a row holds;
- ``mfu``: FLOPs / step time / the card's bf16 dense peak, and the
  ``roofline`` (FLOP time at peak against byte time at the memory
  rate), only on a CUDA card.

Off the card a flash-attention preset is benched with full attention,
as the JAX package does off the TPU (the plain flash versions are no
throughput canary); the row's ``note`` says so.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# Peaks by CUDA device name prefix: dense bf16 tensor-core FLOP/s and HBM
# bytes/s (NVIDIA's H100 SXM data sheet, at its 700 W limit).
_PEAK_FLOPS = {"NVIDIA H100": 989e12}
_PEAK_BW = {"NVIDIA H100": 3.35e12}


def _peak_for(kind: str, table: dict) -> float | None:
    for name, peak in table.items():
        if kind.startswith(name):
            return peak
    return None


_aten = torch.ops.aten
# Gathers and scatters touch the rows they index, not the whole tensor.
_INDEXED = {_aten.index, _aten.index_select, _aten.index_add, _aten.index_add_,
            _aten.index_put, _aten.index_put_}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Bytes of every dispatched op's tensor inputs and outputs (XLA's
    "bytes accessed" before fusion); a gather or scatter counts its
    indices and the rows it moves (read and written), not the indexed
    tensor."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:                # metadata only: no bytes move
            return out
        if func.overloadpacket in _INDEXED:
            rest = _nbytes((args[1:], kwargs))
            moved = rest if func.overloadpacket in (
                _aten.index_add, _aten.index_add_, _aten.index_put,
                _aten.index_put_) else _nbytes(out)
            self.bytes += rest + 2 * moved
        else:
            self.bytes += _nbytes((args, kwargs, out))
        return out


def flash_flops(model, x, *, causal: bool) -> int:
    """FLOPs of one training step's B5-B7 launches for ``model`` on the
    batch ``x`` ``[B, L]`` ids: per layer, forward ``4·B·H·L·L·D`` and
    backward 2.5× that, each halved when ``causal``."""
    b, length = x.shape[:2]
    fwd = 4 * b * model.num_heads * length * length * model.head_dim
    return int(model.num_layers * fwd * 3.5 / (2 if causal else 1))


def bench_train(
    preset,
    *,
    bench_steps: int = 50,
    warmup_steps: int = 3,
    batch_size: int | None = None,
    device=None,
) -> dict[str, Any]:
    """Measure the training step of one preset (by name) or an explicit
    ``TrainConfig`` on ``device`` (default: CUDA, ``utils/platform``).
    Returns a flat dict of numbers (JSON-ready) with the JAX package's
    keys and ``flops_source``. The preset's mesh is not ported (ROADMAP
    Queue A item 8): the bench runs unsharded, ``mesh`` None."""
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.loop import (
        _as_input,
        _make_optimizer,
        _make_sparse_step,
        make_train_step,
    )
    from mlapi_tpu_torch.train.optimizers import state_tensors
    from mlapi_tpu_torch.utils.logging import get_logger
    from mlapi_tpu_torch.utils.platform import resolve_device

    cfg = get_preset(preset) if isinstance(preset, str) else preset
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    model_kwargs = dict(cfg.model_kwargs)
    attn_fallback = (model_kwargs.get("attention_impl") == "flash"
                     and not on_card)
    if attn_fallback:
        model_kwargs["attention_impl"] = "full"
    if cfg.mesh_shape is not None:
        get_logger("train.bench").warning(
            "bench wants mesh %s: sharded training is not ported (ROADMAP "
            "Queue A item 8); benching unsharded", cfg.mesh_shape)
    model = get_model(cfg.model, **model_kwargs, seed=cfg.seed, device=dev)
    bs = batch_size or cfg.batch_size or min(256, len(splits.x_train))
    task = splits.extras.get(
        "task", "lm" if np.asarray(splits.y_train).ndim == 2 else "classify"
    )
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    if cfg.optimizer.startswith("recsys-sparse-"):
        opt, step_fn = _make_sparse_step(cfg.optimizer, cfg.learning_rate,
                                         model, task=task,
                                         weight_decay=cfg.weight_decay)
    else:
        opt = _make_optimizer(cfg.optimizer, cfg.learning_rate,
                              named.values(), model=model)
        step_fn = make_train_step(model.apply, named, opt,
                                  weight_decay=cfg.weight_decay, task=task)

    # One fixed batch, reused: this measures the step, not the host's
    # batch draw.
    x = np.asarray(splits.x_train[:bs])
    y = np.asarray(splits.y_train[:bs], np.int32)
    if len(x) < bs:
        reps = -(-bs // len(x))
        x = np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:bs]
        y = np.tile(y, (reps,) + (1,) * (y.ndim - 1))[:bs]
    xt, yt = _as_input(x, dev), _as_input(y, dev)

    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteCounter()
    with flop_mode, byte_mode:
        loss = step_fn(xt, yt)
    flops = float(flop_mode.get_total_flops())
    source = "FlopCounterMode over the aten ops"
    if model_kwargs.get("attention_impl") == "flash":
        flops += flash_flops(model, x, causal=task == "lm")
        source += (" + flash B5-B7 from shapes (forward 4·B·H·L·L·D, "
                   "backward 2.5×, causal ½)")
    flops = flops or None
    bytes_accessed = float(byte_mode.bytes) or None
    param_bytes = sum(p.numel() * p.element_size() for p in named.values())
    opt_bytes = sum(t.numel() * t.element_size()
                    for _, t in state_tensors(opt, {p: n for n, p in
                                                    named.items()}))

    for _ in range(warmup_steps - 1):
        loss = step_fn(xt, yt)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(bench_steps):
        loss = step_fn(xt, yt)
    final_loss = float(loss)          # waits for the last step
    step_s = (time.perf_counter() - t0) / bench_steps

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak = _peak_for(kind, _PEAK_FLOPS) if on_card else None
    bw = _peak_for(kind, _PEAK_BW) if on_card else None
    mfu = round(flops / step_s / peak, 4) if (flops and peak) else None
    roofline = None
    if flops and bytes_accessed and peak and bw:
        t_flops, t_bytes = flops / peak, bytes_accessed / bw
        roofline = {
            "t_flops_ms": round(t_flops * 1e3, 3),
            "t_bytes_ms": round(t_bytes * 1e3, 3),
            "bound": "memory" if t_bytes > t_flops else "compute",
            "attained_bw_gb_s": round(bytes_accessed / step_s / 1e9, 1),
            "peak_bw_gb_s": round(bw / 1e9, 1),
        }
    return {
        "preset": cfg.name,
        "backend": dev.type,
        "device_kind": kind,
        "devices": 1,
        "mesh": None,
        "batch_size": int(bs),
        "param_bytes_per_device": int(param_bytes),
        "opt_bytes_per_device": int(opt_bytes),
        "step_ms": round(step_s * 1e3, 3),
        "examples_per_s": round(bs / step_s, 1),
        "flops_per_step": flops,
        "bytes_per_step": bytes_accessed,
        "tflops_per_s": round(flops / step_s / 1e12, 2) if flops else None,
        "mfu": mfu,
        "roofline": roofline,
        "final_loss": final_loss,
        "flops_source": source,
        **({"note": "flash attention benched as 'full' off the card (the "
                    "plain versions are not a throughput canary)"}
           if attn_fallback else {}),
    }


# docs-gpt rides along so the LM objective is covered too.
DEFAULT_BENCH_PRESETS = (
    "fashion-mlp", "criteo-widedeep", "sst2-bert", "docs-gpt",
)
