"""Batched gathered matrix-vector products for mixed-tenant LoRA
(counterpart of ``mlapi_tpu/ops/bgmv.py``).

The serving slot pool (``serving/adapter_store.py``) stacks every
resident tenant's ``(a, b)`` pair along a leading slot axis. A batch
whose rows share one tenant applies its adapter as a plain ``x @ a @ b``
(``models/lora.lora_apply``, the grouped path); a MIXED batch gathers
each row's pair by slot index, the BGMV formulation of the multi-tenant
LoRA serving line (S-LoRA / Punica). The JAX package computes it as an
XLA einsum pair, outside any Pallas kernel; here it is two batched
matmuls. A fused Hopper kernel (gather and both contractions in one
launch) is a held item of ROADMAP Queue B.
"""

from __future__ import annotations

import torch


def bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         rows: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta ``x[i] @ a[rows[i]] @ b[rows[i]]``.

    ``x`` is ``[B, L, d_in]``, ``a`` the slot pool ``[S, d_in, r]``,
    ``b`` ``[S, r, d_out]`` and ``rows`` an int ``[B]`` tensor. Slot 0
    is all-zero, so base rows of a mixed batch pay the same two
    products and get an exactly-zero delta."""
    a_g = a[rows].to(x.dtype)      # [B, d_in, r]
    b_g = b[rows].to(x.dtype)      # [B, r, d_out]
    return (x @ a_g) @ b_g
