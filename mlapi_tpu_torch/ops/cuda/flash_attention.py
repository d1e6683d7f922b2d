"""Flash attention for training: the forward (B5) and both backward
kernels (B6: dq, B7: dk/dv) behind one ``torch.autograd.Function``.

Counterpart of ``mlapi_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` / ``flash_attention_with_lse`` and the ``_flash``
custom VJP). The kernels are ``csrc/flash_attention.cu``; its source
note says what bounds them on an H100 and what the design does about
that. The public functions keep the JAX layouts and contract:

- ``q`` ``[B, Lq, H, D]``; ``k``/``v`` ``[B, Lk, KVH, D]`` with ``H`` a
  multiple of ``KVH`` (grouped-query attention: head ``h`` reads KV
  head ``h // (H // KVH)``), or int8 ``{"q", "scale"}`` pairs, which
  dequantize at entry (``ops/quant.maybe_dequant_kv``);
- ``mask``: optional binary ``[B, Lk]`` over keys (default all ones);
- ``causal`` (needs ``Lq == Lk``) and, with it only, a sliding
  ``window`` (keep ``q_pos - k_pos < window``);
- ``scale`` defaults to ``1 / sqrt(D)``;
- out ``[B, Lq, H, D]`` in ``q.dtype``; lse ``[B, H, Lq]`` f32. A query
  row with no valid key gives zeros, and zero gradients.

The Pallas tiling knobs (``block_q``, ``block_k``, ``interpret``) have
no counterpart: the CUDA kernels fix their own tiles.

Head dims: every ``D >= 1``. The kernels are compiled for 16, 32, 64,
128 and 256; for another ``D`` each wrapper zero-pads q, k, v and dO
along the last dim to the next of them, or past 256 to the next
multiple of 256 (zero columns leave q·k unchanged and give zero output
and gradient columns, so the result is exact), runs the kernel with the
scale of the original ``D`` (the wrappers always receive it explicitly)
and slices the result back. A padded ``D = 256 · nd`` runs the D = 256
bodies in ``nd`` column chunks (the C source's note).

Two bodies (the C source's ``flash_body`` picks one and reports it;
:func:`_body` mirrors that choice for the CPU tests): ``"mma"``, tensor
cores, for B5, B6 and B7 in bf16 at a compiled ``D`` up to 128;
``"fma"``, CUDA-core f32, for f32 (exact, no TF32) and ``D >= 256``.

For CUDA tensors each wrapper (:func:`flash_forward`,
:func:`flash_backward_dq`, :func:`flash_backward_dkv`) launches its
kernel or raises; for CPU tensors it runs the plain version
(:func:`flash_forward_plain`, :func:`flash_backward_plain`: the same
function in whole-tensor PyTorch ops, as the JAX package's
``_jnp_flash``, with the kernels' rounding points). Each wrapper counts
its launches in ``<wrapper>.launches``, and by body in
``<wrapper>.bodies``. ``delta = rowsum(dO * O)`` minus any lse
cotangent is one PyTorch op outside the kernels, as in JAX
(``flash_attention.py:512-521``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlapi_tpu_torch.ops.attention import NEG
from mlapi_tpu_torch.ops.cuda.decode_attention import _count
from mlapi_tpu_torch.ops.quant import maybe_dequant_kv

_COMPILED_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_NAMES = ("fma", "mma")   # the C source's enum Body, by value


def _prepare(q, k, v, mask, causal, scale, window):
    """The JAX ``_prepare`` contract (``flash_attention.py:681-715``):
    validation, the default scale and the default mask. Returns
    ``(mask, scale)``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if causal and lq != lk:
        raise ValueError(
            f"causal attention needs aligned q/k lengths, got {lq} vs {lk}"
        )
    if window is not None and (not causal or window < 1):
        raise ValueError(
            "window requires causal=True and window >= 1 "
            f"(got causal={causal}, window={window})"
        )
    if k.shape[2] != v.shape[2]:
        raise ValueError(
            f"k and v head counts disagree: {k.shape[2]} vs {v.shape[2]}"
        )
    if h % k.shape[2]:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads "
            f"({k.shape[2]}) for grouped-query attention"
        )
    scale = (1.0 / d**0.5) if scale is None else scale
    if mask is None:
        mask = torch.ones((b, lk), dtype=torch.float32, device=q.device)
    return mask, scale


def _keep(mask, causal, window, lq, lk):
    """``[B, 1, Lq, Lk]`` f32 keep-mask: the key mask, then the causal
    and window terms."""
    keep = mask.to(torch.float32)[:, None, None, :]
    if causal:
        dist = (torch.arange(lq, device=mask.device)[:, None]
                - torch.arange(lk, device=mask.device)[None, :])
        tri = dist >= 0
        if window is not None:
            tri = tri & (dist < window)
        keep = keep * tri[None, None]
    return keep


def _repeat_kv(x, group):
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def flash_forward_plain(q, k, v, mask, *, causal=False, scale, window=None):
    """B5's plain version (the JAX package's ``_jnp_flash``): ``(out
    [B, Lq, H, D] in q.dtype, lse [B, H, Lq] f32)``."""
    group = q.shape[2] // k.shape[2]
    kf = _repeat_kv(k, group).float()
    vf = _repeat_kv(v, group).float()
    keep = _keep(mask, causal, window, q.shape[1], k.shape[1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    s = s + (1.0 - keep) * NEG
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * keep
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    denom = torch.clamp(l, min=1e-30)
    out = (o / denom.transpose(1, 2)[..., None]).to(q.dtype)
    return out, m + torch.log(denom)


def flash_backward_plain(q, k, v, mask, dout, lse, delta, *, causal=False,
                         scale, window=None):
    """B6's and B7's plain version: ``(dq, dk, dv)`` from the saved
    ``lse`` and ``delta = rowsum(dO * O) - g_lse`` (both ``[B, H, Lq]``
    f32), with the Pallas kernels' rounding: ds to k's dtype before
    ds·K, to q's before dsᵀ·Q, p to dO's before pᵀ·dO."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    kf = _repeat_kv(k, group).float()
    vf = _repeat_kv(v, group).float()
    keep = _keep(mask, causal, window, lq, lk)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    s = s + (1.0 - keep) * NEG
    p = torch.exp(s - lse[..., None]) * keep
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    # Each KV head sums its query group, in f32, before the cast.
    dk = dk.reshape(b, lk, kvh, group, d).sum(dim=3)
    dv = dv.reshape(b, lk, kvh, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ENTRIES = {
    # q, k, v, mask, out, lse | strides | dtype, B, Lq, Lk, H, KVH, D,
    # causal, window | scale | stream, body (out)
    "mlapi_flash_forward": 6,
    # q, k, v, mask, dout, lse, delta, dq
    "mlapi_flash_backward_dq": 8,
    # q, k, v, mask, dout, lse, delta, dk, dv
    "mlapi_flash_backward_dkv": 9,
}


@functools.cache
def _entries():
    """The three entry points of the kernel library, argtypes set once:
    pointers, the stride array and the stream as ``c_void_p`` (none cut
    to 32 bits), the sizes ``c_int``, the scale ``c_float``, and the
    ``int*`` that receives the body the call ran."""
    from mlapi_tpu_torch.ops.cuda import build

    lib = build.load("flash_attention")
    out = {}
    for name, n_ptrs in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * (n_ptrs + 1) + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _row_aligned(t):
    """``t`` itself when the kernel can read it in place (on the card,
    last dim contiguous, 16-byte aligned rows), else a contiguous
    copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % vec for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _compiled_d(entry, d):
    """The head dim the kernels run ``d`` at: the next compiled one up to
    256, past it the next multiple of 256 (``d // 256`` column chunks of
    the D = 256 bodies)."""
    if d < 1:
        raise ValueError(f"{entry}: head_dim {d} must be at least 1")
    return next((c for c in _COMPILED_DIMS if c >= d), -(-d // 256) * 256)


def _body(dtype, dc):
    """The body a call of padded head dim ``dc`` runs, at every entry
    point (a mirror of the C source's ``flash_body``, which decides on
    the card): tensor cores in bf16 at ``dc <= 128``, the CUDA cores
    otherwise (f32, ``dc >= 256``)."""
    return "mma" if dtype == torch.bfloat16 and dc <= 128 else "fma"


def _pad(t, dc):
    """``t`` zero-padded along its last dim to ``dc`` columns."""
    if t is None or t.shape[-1] == dc:
        return t
    return torch.nn.functional.pad(t, (0, dc - t.shape[-1]))


def _mask_bytes(mask):
    """The key mask as the kernels read it, bytes ``[B, Lk]`` with nonzero
    = attend: a bool mask viewed as it is, any other compared with 0."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    return mask.view(torch.uint8).contiguous()


def _launch(entry, q, k, v, mask, causal, scale, window, ptrs, dout=None):
    """Validate, then one C call of ``entry`` (head dims compiled only:
    the wrappers pad the others); ``ptrs`` are the output (and
    lse/delta) pointers that follow dO in its argument list. Returns the
    body that ran, as the C entry point reports it."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if d not in _COMPILED_DIMS[:-1] and (d < 256 or d % 256):
        raise ValueError(
            f"{entry}: head_dim {d} not compiled (one of "
            f"{_COMPILED_DIMS[:-1]} or a multiple of 256; the wrappers pad "
            "every other D to one)"
        )
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{entry}: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v), ("dO", dout)):
        if t is not None and t.dtype != q.dtype:
            raise ValueError(f"{entry}: {name} is {t.dtype}, q is {q.dtype}")
    if k.shape != v.shape or tuple(mask.shape) != (b, lk):
        raise ValueError(
            f"{entry}: k {tuple(k.shape)}, v {tuple(v.shape)} and mask "
            f"{tuple(mask.shape)} must be [B, Lk, KVH, D] and [B, Lk]"
        )
    for t in (q, k, v, mask, dout):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{entry}: every operand must be on the card")
    tensors = [_row_aligned(t) for t in (q, k, v)]
    if dout is not None:
        tensors.append(_row_aligned(dout))
    strides = [s for t in tensors for s in t.stride()[:3]]
    strides += [0] * (12 - len(strides))
    stride_arr = (ctypes.c_longlong * 12)(*strides)
    keep = _mask_bytes(mask)
    body = ctypes.c_int(-1)
    rc = _entries()[entry](
        *(t.data_ptr() for t in tensors[:3]), keep.data_ptr(),
        *(t.data_ptr() for t in tensors[3:]), *ptrs,
        ctypes.addressof(stride_arr), _DTYPE_CODES[q.dtype], b, lq, lk, h,
        kvh, d, int(causal), int(window or 0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(body),
    )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return _BODY_NAMES[body.value]


def flash_forward(q, k, v, mask, *, causal=False, scale, window=None):
    """B5: ``(out, lse)``. CUDA tensors launch the kernel; CPU tensors
    run :func:`flash_forward_plain`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, causal=causal, scale=scale,
                                   window=window)
    b, lq, h, d = q.shape
    dc = _compiled_d("mlapi_flash_forward", d)
    out = torch.empty((b, lq, h, dc), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    body = _launch("mlapi_flash_forward", _pad(q, dc), _pad(k, dc),
                   _pad(v, dc), mask, causal, scale, window,
                   [out.data_ptr(), lse.data_ptr()])
    _count(flash_forward, body)
    return (out if dc == d else out[..., :d].contiguous()), lse


def _rows_f32(t, like):
    b, lq, h, _ = like.shape
    if t.shape != (b, h, lq):
        raise ValueError(f"lse/delta {tuple(t.shape)} must be [B, H, Lq]")
    return t.to(torch.float32).contiguous()


def flash_backward_dq(q, k, v, mask, dout, lse, delta, *, causal=False,
                      scale, window=None):
    """B6: dq ``[B, Lq, H, D]``. CUDA tensors launch the kernel; CPU
    tensors run :func:`flash_backward_plain`."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, mask, dout, lse, delta,
                                    causal=causal, scale=scale,
                                    window=window)[0]
    lse, delta = _rows_f32(lse, q), _rows_f32(delta, q)
    d = q.shape[-1]
    dc = _compiled_d("mlapi_flash_backward_dq", d)
    dq = torch.empty(q.shape[:-1] + (dc,), dtype=q.dtype, device=q.device)
    body = _launch("mlapi_flash_backward_dq", _pad(q, dc), _pad(k, dc),
                   _pad(v, dc), mask, causal, scale, window,
                   [lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
                   _pad(dout, dc))
    _count(flash_backward_dq, body)
    return dq if dc == d else dq[..., :d].contiguous()


def flash_backward_dkv(q, k, v, mask, dout, lse, delta, *, causal=False,
                       scale, window=None):
    """B7: ``(dk, dv)``, each ``[B, Lk, KVH, D]``. CUDA tensors launch
    the kernel; CPU tensors run :func:`flash_backward_plain`."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, mask, dout, lse, delta,
                                    causal=causal, scale=scale,
                                    window=window)[1:]
    lse, delta = _rows_f32(lse, q), _rows_f32(delta, q)
    d = q.shape[-1]
    dc = _compiled_d("mlapi_flash_backward_dkv", d)
    dk = torch.empty(k.shape[:-1] + (dc,), dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape[:-1] + (dc,), dtype=v.dtype, device=v.device)
    body = _launch("mlapi_flash_backward_dkv", _pad(q, dc), _pad(k, dc),
                   _pad(v, dc), mask, causal, scale, window,
                   [lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr()],
                   _pad(dout, dc))
    _count(flash_backward_dkv, body)
    if dc != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


for _fn in (flash_forward, flash_backward_dq, flash_backward_dkv):
    _fn.launches = 0
    _fn.bodies = {"mma": 0, "fma": 0}
del _fn


class _Flash(torch.autograd.Function):
    """(out, lse) with a joint backward (the JAX package's ``_flash``
    custom VJP): B5 forward, B6 + B7 backward. An lse cotangent folds
    into delta (``∂lse_i/∂s_ij = p_ij``), so the kernels need no
    change; that is what lets ring attention train through the lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, window):
        out, lse = flash_forward(q, k, v, mask, causal=causal, scale=scale,
                                 window=window)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.cfg = dict(causal=causal, scale=scale, window=window)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dq = flash_backward_dq(q, k, v, mask, g_out, lse, delta, **ctx.cfg)
        dk, dv = flash_backward_dkv(q, k, v, mask, g_out, lse, delta,
                                    **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, mask=None, *, causal: bool = False,
                             scale=None, window: int | None = None):
    """Fused softmax attention that also returns the per-row log-sum-exp
    ``[B, H, Lq]`` — what lets independently computed attention blocks
    merge exactly (ring attention). Differentiable through both
    outputs."""
    k = maybe_dequant_kv(k, q.dtype)
    v = maybe_dequant_kv(v, q.dtype)
    mask, scale = _prepare(q, k, v, mask, causal, scale, window)
    if q.device.type == "cuda" and mask.dtype != torch.bool:
        # The kernels read nonzero as attend: one comparison here, not one
        # in each of B5, B6 and B7.
        mask = mask != 0
    return _Flash.apply(q, k, v, mask, causal, scale, window)


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    scale=None, window: int | None = None):
    """Fused softmax attention: ``q, k, v`` ``[B, L, H, D]`` (k/v may
    carry fewer heads), optional binary key ``mask [B, L]`` → ``[B, L,
    H, D]`` in ``q.dtype``, differentiable (B5 forward, B6 + B7
    backward on the card)."""
    out, _ = flash_attention_with_lse(q, k, v, mask, causal=causal,
                                      scale=scale, window=window)
    return out
