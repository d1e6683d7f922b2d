"""Stable softmax attention — the fresh-prefill attention of the port.

Counterpart of ``mlapi_tpu/ops/attention.py::full_attention`` with its
conventions kept: ``q, k, v`` are ``[B, L, H, D]``, ``mask`` is a
binary ``[B, L]`` key mask, products take the input dtype with float32
accumulation (inputs are upcast, which is exact for bf16), the softmax
runs in float32, probabilities are cast to the input dtype before the
value product, and the output comes back in ``q.dtype``. Masked
scores use the finite ``NEG`` rather than ``-inf``, and a query row
whose keys are all masked returns zeros.
"""

from __future__ import annotations

import torch

# Finite large-negative instead of -inf: exp(NEG - NEG) == 1 is zeroed
# by the explicit mask multiply, so fully masked rows stay NaN-free.
NEG = -1e30


def full_attention(q, k, v, mask=None, *, causal: bool = False, scale=None):
    """Softmax attention over the full sequence: ``[B, L, H, D]`` in,
    ``[B, L, H, D]`` out in ``q.dtype``."""
    d = q.shape[-1]
    scale = (1.0 / d**0.5) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        maskf = mask.to(torch.float32)
        scores = scores + (1.0 - maskf)[:, None, None, :] * NEG
    if causal:
        l = q.shape[1]
        keep = torch.tril(
            torch.ones((l, l), dtype=torch.bool, device=q.device)
        )
        scores = torch.where(keep[None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        # Softmax is shift-invariant, so a row whose keys are ALL
        # masked would otherwise attend uniformly; zero it instead.
        probs = probs * maskf[:, None, None, :]
    probs = probs.to(q.dtype)
    return torch.einsum(
        "bhqk,bkhd->bqhd", probs.float(), v.float()
    ).to(q.dtype)
