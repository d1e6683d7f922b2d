"""The KV-cache formats: full precision and int8 payload + f32 scales.

Counterpart of the KV subset of ``mlapi_tpu/ops/quant.py``. A cache
layer is a dict of tensors: ``{"k", "v"}`` in the compute dtype, or
``{"k_q", "k_scale", "v_q", "v_scale"}`` for ``kv_quant="int8"``
(symmetric per-token-per-head int8, ``scale f32[B, L, H, 1]``).

Unlike the JAX package, whose jitted programs donate the cache and get
a new one back, :func:`kv_cache_append` writes into the layer's
tensors IN PLACE and returns the same dict: the cache is allocated once
per batch and every prefill, decode step and extend chunk writes into
it.

The int8 arithmetic matches the JAX package bit for bit: amax over the
head dim, ``scale = amax / 127`` (1 where amax is 0), round half to
even, clip to ±127.
"""

from __future__ import annotations

import torch

KV_FORMATS = ("none", "int8")


def _is_quant_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def kv_is_quantized_layer(layer: dict) -> bool:
    return "k_q" in layer


def kv_tree_bytes(tree) -> int:
    """Exact bytes of a cache (nested dicts of tensors) from dtype and
    shape arithmetic alone."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(kv_tree_bytes(v) for v in tree.values())


def kv_quantize(x):
    """``[..., D]`` float K or V block → ``(q int8[..., D], scale
    f32[..., 1])``, symmetric per token and head."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q, scale, dtype):
    """int8 payload x broadcast scale → ``dtype``; both operands are
    converted to ``dtype`` first and multiplied there, as in the JAX
    package and in the CUDA kernels' tile loads."""
    return q.to(dtype) * scale.to(dtype)


def _write(buf, upd, pos) -> None:
    """``buf[b, pos:pos+U] = upd[b]`` with ``pos`` a scalar or a per-row
    ``[B]`` vector. The start is clamped so the block fits, the same
    clamp ``lax.dynamic_update_slice`` applies."""
    u, length = upd.shape[1], buf.shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = pos.to(torch.long).clamp(0, length - u)
        cols = start[:, None] + torch.arange(u, device=buf.device)[None]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, cols] = upd.to(buf.dtype)
        return
    start = min(max(int(pos), 0), length - u)
    buf[:, start:start + u] = upd.to(buf.dtype)


def kv_cache_append(layer: dict, k_new, v_new, pos, cdt) -> dict:
    """Write a ``[B, U, H, D]`` K/V block into ``layer`` at slot ``pos``
    (scalar, or per-row ``[B]``), IN PLACE; returns ``layer``. An int8
    layer quantizes the block first and writes payload and scales."""
    if kv_is_quantized_layer(layer):
        kq, ks = kv_quantize(k_new)
        vq, vs = kv_quantize(v_new)
        updates = {"k_q": kq, "k_scale": ks, "v_q": vq, "v_scale": vs}
    else:
        updates = {"k": k_new.to(cdt), "v": v_new.to(cdt)}
    for name, upd in updates.items():
        _write(layer[name], upd, pos)
    return layer


def kv_cache_kv(layer: dict, cdt):
    """The einsum read seam: a cache layer → ``(k, v)`` in the compute
    dtype (an int8 layer dequantizes here)."""
    if kv_is_quantized_layer(layer):
        return (
            kv_dequantize(layer["k_q"], layer["k_scale"], cdt),
            kv_dequantize(layer["v_q"], layer["v_scale"], cdt),
        )
    return layer["k"], layer["v"]


def kv_cache_seq_len(cache: dict) -> int:
    """Sequence capacity of a cache (the contiguous buffer length)."""
    layer = cache["layer_0"]
    leaf = layer["k_q"] if kv_is_quantized_layer(layer) else layer["k"]
    return leaf.shape[1]


def init_kv_cache(batch: int, max_len: int, heads: int, head_dim: int,
                  cdt, kv_quant: str = "none", device=None) -> dict:
    """One layer's zeroed KV buffers in the requested format."""
    shape = (batch, max_len, heads, head_dim)
    if kv_quant == "int8":
        sshape = (batch, max_len, heads, 1)
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
        }
    if kv_quant != "none":
        raise ValueError(
            f"unknown kv_quant {kv_quant!r}; expected one of {KV_FORMATS}"
        )
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
    }


@torch.inference_mode()
def _forced_argmax(model, prompt_ids, forced, n_pad):
    """Teacher-forced decode: prefill, then feed the FIXED ``forced``
    stream through ``decode_step`` and take each step's argmax."""
    p, n = prompt_ids.shape[1], forced.shape[1]
    cache, _ = model.prefill_core(prompt_ids, n_pad, p + n + 1)
    outs = []
    for t in range(n):
        logits, cache = model.decode_step(
            cache, forced[:, t:t + 1], p + t, n_pad
        )
        outs.append(torch.argmax(logits, dim=-1))
    return torch.stack(outs, dim=1)


def kv_greedy_agreement(model, prompt_ids, max_new_tokens: int,
                        pad_lens=None, quant_overrides=None) -> float:
    """Teacher-forced greedy top-1 agreement of a quantized-cache decode
    with the full-precision cache (``mlapi_tpu/ops/quant.py``'s guard).
    The reference is the model's greedy stream with ``kv_quant="none"``
    (its ``decode_attn_impl`` as set); the compared side replays that
    stream with ``kv_quant="int8"`` and ``quant_overrides`` (e.g.
    ``{"decode_attn_impl": "flash"}``, or ``{"kv_quant": "none",
    "decode_attn_impl": "flash"}`` to hold the flash kernels alone
    against the einsum oracle). The first token comes from the prefill
    and is excluded. The model's configuration is restored after."""
    if max_new_tokens < 2:
        raise ValueError("kv_greedy_agreement needs max_new_tokens >= 2")
    saved = {"kv_quant": model.kv_quant,
             "decode_attn_impl": model.decode_attn_impl}
    b = prompt_ids.shape[0]
    n_pad = torch.as_tensor(
        [0] * b if pad_lens is None else list(pad_lens),
        dtype=torch.long, device=prompt_ids.device,
    )
    try:
        model.configure(kv_quant="none")
        with torch.inference_mode():
            ref = model.generate(
                prompt_ids, max_new_tokens=max_new_tokens, pad_lens=pad_lens
            )
        model.configure(**{"kv_quant": "int8", **(quant_overrides or {})})
        got = _forced_argmax(model, prompt_ids, ref[:, :-1], n_pad)
    finally:
        model.configure(**saved)
    return float((got == ref[:, 1:]).to(torch.float32).mean())


def maybe_dequant_kv(x, dtype=None):
    """A K/V operand that is either a tensor or an int8 ``{"q",
    "scale"}`` pair → a tensor (pairs dequantize to ``dtype``, default
    the scale's dtype). Anything else is rejected."""
    if isinstance(x, dict):
        if _is_quant_leaf(x):
            return kv_dequantize(
                x["q"], x["scale"], dtype or x["scale"].dtype
            )
        raise TypeError(
            "attention kernels take tensors or {'q', 'scale'} quantized "
            f"pairs, got dict with keys {sorted(x)}"
        )
    return x
