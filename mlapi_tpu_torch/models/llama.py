"""Llama-style decoder (RMSNorm, rotary positions, SwiGLU, grouped-query
attention) with the KV-cache decode path.

Counterpart of ``mlapi_tpu/models/llama.py``. Against :class:`GptLM`:

- **Rotary positions** instead of a learned table: q and k are rotated
  per row and position, so the KV cache stores ROTATED keys and the
  cached paths need no position lookup. A left-padded row's positions
  are ``slot - n_pad`` clamped at 0, the GPT shift.
- **Grouped-query attention** (``num_kv_heads < num_heads``): the cache
  holds ``num_kv_heads`` heads. Query head ``h`` reads KV head ``h //
  group`` (``repeat_interleave`` on the einsum and full-attention
  paths); the CUDA kernels take the KV heads as they are and group the
  query heads themselves.
- **RMSNorm (eps 1e-6) and SwiGLU, no biases, an untied ``lm_head``.**

Numerics follow the JAX package: float32 residual stream, norms and
softmax; matmuls in ``compute_dtype``; the rotary angle in float32 and
its cos/sin cast to the operand's dtype before ``x * cos +
rotate_half(x) * sin``; logits in float32.

The parameters keep the JAX pytree's names and ``[d_in, d_out]``
orientation as raw tensors (``wte``, ``lm_head``, ``rms_f_scale``,
``layer_{n}.{wq, wk, wv, wo, w_gate, w_up, w_down, rms1_scale,
rms2_scale}``), so ``params_from_jax`` copies by key path.

The serving and generation programs are the GPT family's
(``models/gpt.py``): this class plugs in through ``init_cache``,
``prefill_core``, ``decode_step`` and ``extend_core``, and the cache
read goes through the shared ``cached_attend`` with the GQA broadcast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.gpt import (
    _DTYPES,
    DecoderLM,
    _param,
    cached_attend,
    decode_valid_and_shift,
    extend_positions_and_mask,
)
from mlapi_tpu_torch.models.lora import layer_lora, lora_apply
from mlapi_tpu_torch.ops.attention import full_attention
from mlapi_tpu_torch.ops.cuda.flash_attention import flash_attention
from mlapi_tpu_torch.ops.quant import (
    kv_cache_append,
    kv_cache_coords,
    kv_cache_seq_len,
    take,
    weight,
)
from mlapi_tpu_torch.utils.platform import resolve_device

_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * scale.to(torch.float32)).to(x.dtype)


def _rope_tables(positions, d: int, theta: float, dtype):
    """The rotation of ``positions [B, L]`` at head dim ``d``, as the JAX
    ``_rope`` computes it: the angle in f32 (lane ``j`` turns at
    ``theta ** (-(j % half) / half)``), cos/sin cast to ``dtype``, and
    the rotate-half gather (pairs ``(j, j + d/2)``) with its sign. A
    forward computes it once and rotates every layer's q and k with it
    (:func:`_rotate`)."""
    half = d // 2
    dev = positions.device
    lane = torch.arange(d, device=dev)
    inv_freq = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    )
    ang = positions.to(torch.float32)[..., None] * inv_freq[lane % half]
    cos = torch.cos(ang)[:, :, None, :].to(dtype)   # [B, L, 1, D]
    sin = torch.sin(ang)[:, :, None, :].to(dtype)
    # rotate_half(x)[j] = -x[j + half] (j < half), else x[j - half].
    perm = torch.cat([lane[half:], lane[:half]])
    sign = torch.where(lane < half, -1.0, 1.0).to(dtype)
    return cos, sin, perm, sign


def _rotate(x, tables):
    """``x * cos + rotate_half(x) * sin`` over the full lane dim, in
    ``x``'s dtype (the JAX function's order of operations)."""
    cos, sin, perm, sign = tables
    return x * cos + x[..., perm] * sign * sin


def _rope(x, positions, theta: float):
    """Rotate ``x [B, L, H, D]`` by ``positions [B, L]`` (the JAX
    package's ``_rope``)."""
    return _rotate(x, _rope_tables(positions, x.shape[-1], theta, x.dtype))


def _unit(n: int) -> nn.Parameter:
    return nn.Parameter(torch.ones(n), requires_grad=False)


class _Block(nn.Module):
    def __init__(self, h: int, kv: int, f: int):
        super().__init__()
        self.wq = _param(h, h)
        self.wk, self.wv = _param(h, kv), _param(h, kv)
        self.wo = _param(h, h)
        self.rms1_scale = _unit(h)
        self.w_gate, self.w_up = _param(h, f), _param(h, f)
        self.w_down = _param(f, h)
        self.rms2_scale = _unit(h)


@register_model("llama_lm")
class LlamaLM(DecoderLM):
    """Decoder-only causal LM, Llama-family architecture.

    The constructor takes the JAX dataclass's fields (``num_kv_heads``
    None is MHA; ``intermediate_size`` None is ``8/3 * hidden`` rounded
    up to 128). Weights are drawn from ``seed`` with the JAX package's
    distributions (normal 0.02 for ``wte``, ``lm_head`` and the dense
    kernels, unit RMSNorm scales) on the CPU, then moved to ``device``
    (CUDA unless ``device="cpu"`` or ``MLAPI_TPU_PLATFORM=cpu``);
    ``seed=None`` skips the draw for weights about to be loaded.
    ``attention_impl`` is ``"full"`` or ``"flash"`` (``apply`` through
    B5-B7 with the KV heads as they are); ``"ring"`` waits for the
    parallel slice (ROADMAP Queue A item 8).
    """

    def __init__(
        self,
        vocab_size: int = 512,
        hidden_size: int = 256,
        num_layers: int = 4,
        num_heads: int = 4,
        num_kv_heads: int | None = None,
        intermediate_size: int | None = None,
        max_positions: int = 256,
        rope_theta: float = 10_000.0,
        compute_dtype: str = "bfloat16",
        attention_impl: str = "full",
        kv_quant: str = "none",
        decode_attn_impl: str = "einsum",
        *,
        seed: int | None = 0,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if attention_impl == "ring":
            raise NotImplementedError(
                'attention_impl="ring" is not ported (sequence-parallel '
                "ring attention waits for ROADMAP Queue A item 8)"
            )
        if attention_impl not in ("full", "flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        if num_kv_heads is not None and num_kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got {num_kv_heads}")
        if hidden_size % num_heads:
            raise ValueError("hidden_size must divide evenly into heads")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.intermediate_size = intermediate_size
        self.max_positions = max_positions
        self.rope_theta = float(rope_theta)
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        if num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads ({num_heads}) must be a multiple of "
                f"num_kv_heads ({self.kv_heads})"
            )
        if self.head_dim % 2:
            raise ValueError("rotary embeddings need an even head_dim")
        self.configure(kv_quant=kv_quant, decode_attn_impl=decode_attn_impl)

        h, v = hidden_size, vocab_size
        self.wte = _param(v, h)
        self.lm_head = _param(h, v)
        self.rms_f_scale = _unit(h)
        for n in range(num_layers):
            self.add_module(
                f"layer_{n}",
                _Block(h, self.kv_heads * self.head_dim, self.ffn_size),
            )
        if seed is not None:
            self._init_weights(int(seed))
        self.to(dev)

    @property
    def kv_heads(self) -> int:
        if self.num_kv_heads is None:
            return self.num_heads
        return self.num_kv_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        return max(128, (8 * self.hidden_size // 3 + 127) // 128 * 128)

    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=gen)
            self.lm_head.normal_(0.0, 0.02, generator=gen)
            for n in range(self.num_layers):
                for name in _DENSE:
                    getattr(self.layer(n), name).normal_(0.0, 0.02,
                                                         generator=gen)

    def cast_dense_(self) -> "LlamaLM":
        """Store the seven dense kernels of every layer in the compute
        dtype, IN PLACE (``wte``, ``lm_head`` and the scales stay f32).
        The forward casts them at each use anyway, so outputs are
        unchanged; serving calls this once."""
        for n in range(self.num_layers):
            for name in _DENSE:
                w = getattr(self.layer(n), name)
                if isinstance(w, nn.Parameter):  # not int8
                    w.data = w.data.to(self.cdt)
        return self

    # ------------------------------------------------------------------
    def _qkv(self, layer: _Block, xn, rope, lora=None):
        """Project and rotate one block's q/k/v; ``rope`` is the
        forward's :func:`_rope_tables` of the rows' effective
        positions, ``lora`` the layer's serving adapters
        (``models/lora.lora_apply``; ``None``: none)."""
        cdt = self.cdt
        b, l, _ = xn.shape
        nh, kvh, hd = self.num_heads, self.kv_heads, self.head_dim
        q = lora_apply(lora, "wq", xn, xn @ weight(layer.wq, cdt))
        k = lora_apply(lora, "wk", xn, xn @ weight(layer.wk, cdt))
        v = lora_apply(lora, "wv", xn, xn @ weight(layer.wv, cdt))
        q = q.reshape(b, l, nh, hd)
        k = k.reshape(b, l, kvh, hd)
        v = v.reshape(b, l, kvh, hd)
        return _rotate(q, rope), _rotate(k, rope), v

    def _rope_for(self, positions):
        return _rope_tables(positions, self.head_dim, self.rope_theta,
                            self.cdt)

    def _block(self, layer: _Block, x, rope, attend, lora=None):
        """One pre-norm block; ``attend(q, k, v)`` gets the rotated q/k
        and the raw KV heads. ``lora``: the layer's serving adapters,
        added to each projection by ``lora_apply`` (``None``: no op)."""
        cdt = self.cdt
        xn = _rms_norm(x, layer.rms1_scale).to(cdt)
        q, k, v = self._qkv(layer, xn, rope, lora)
        ctx = attend(q, k, v).reshape(x.shape[0], x.shape[1], -1)
        wo = lora_apply(lora, "wo", ctx, ctx @ weight(layer.wo, cdt))
        x = x + wo.to(torch.float32)
        xn = _rms_norm(x, layer.rms2_scale).to(cdt)
        gate = lora_apply(lora, "w_gate", xn,
                          xn @ weight(layer.w_gate, cdt))
        gate = F.silu(gate.to(torch.float32)).to(cdt)
        gu = gate * lora_apply(lora, "w_up", xn, xn @ weight(layer.w_up, cdt))
        down = lora_apply(lora, "w_down", gu, gu @ weight(layer.w_down, cdt))
        return x + down.to(torch.float32)

    def _repeat_kv(self, k):
        group = self.num_heads // self.kv_heads
        return k if group == 1 else k.repeat_interleave(group, dim=2)

    def _logits(self, x):
        x = _rms_norm(x, self.rms_f_scale)
        return x.to(torch.float32) @ weight(self.lm_head, torch.float32)

    def apply(self, token_ids):
        """``[B, L]`` ids → ``[B, L, V]`` next-token logits (causal)."""
        b, l = token_ids.shape
        x = take(self.wte, token_ids)
        rope = self._rope_for(
            torch.arange(l, device=token_ids.device).expand(b, l))

        def attend(q, k, v):
            if self.attention_impl == "flash":
                # GQA-native: the KV heads go in as they are.
                return flash_attention(q, k, v, causal=True)
            return full_attention(q, self._repeat_kv(k), self._repeat_kv(v),
                                  causal=True)

        for n in range(self.num_layers):
            x = self._block(self.layer(n), x, rope, attend)
        return self._logits(x)

    forward = apply

    # -- incremental decoding (the GPT family's programs and, from
    # ``DecoderLM``, its ``init_cache``: ``[B, max_len, KVH, D]``) -------
    def prefill_core(self, prompt_ids, n_pad, total_len: int,
                     cache=None, pos0=0, lora=None):
        """Full causal forward over a left-padded ``[B, P]`` prompt,
        writing the ROTATED K (and V) into a fresh ``[B, total_len]``
        cache, or into ``cache`` at slot ``pos0`` (the page-native
        prefill: rotary phases key on the local positions ``arange(P) -
        n_pad``, wherever the block lands). The prompt attends in full
        precision through ``full_attention``. Returns ``(cache,
        last_logits [B, V])``."""
        b, p = prompt_ids.shape
        cache = self.init_cache(b, total_len) if cache is None else cache
        ar = torch.arange(p, device=prompt_ids.device)[None, :]
        rope = self._rope_for(torch.clamp(ar - n_pad[:, None], min=0))
        mask = (ar >= n_pad[:, None]).to(torch.float32)
        x = take(self.wte, prompt_ids)
        coords = kv_cache_coords(cache, pos0, p)
        for n in range(self.num_layers):
            seen = {}

            def attend(q, k, v, _seen=seen):
                _seen["k"], _seen["v"] = k, v
                return full_attention(q, self._repeat_kv(k),
                                      self._repeat_kv(v), mask=mask,
                                      causal=True)

            x = self._block(self.layer(n), x, rope, attend,
                            layer_lora(lora, n))
            kv_cache_append(cache[f"layer_{n}"], seen["k"], seen["v"],
                            pos0, self.cdt, coords)
        return cache, self._logits(x[:, -1])

    def decode_step(self, cache, token_ids, pos, n_pad=None,
                    prefix_len=None, prefix_lo=None, lora=None):
        """One decode step, the contract of ``GptLM.decode_step``: the
        new token's rotated K/V is written in place before the read."""
        b = token_ids.shape[0]
        max_len = kv_cache_seq_len(cache)
        if n_pad is None:
            n_pad = torch.zeros((b,), dtype=torch.long,
                                device=token_ids.device)
        valid, shift = decode_valid_and_shift(
            max_len, pos, n_pad, prefix_len, prefix_lo
        )
        rope = self._rope_for(torch.clamp(pos - shift, min=0)[:, None])
        x = take(self.wte, token_ids)
        coords = kv_cache_coords(cache, pos, 1)
        for n in range(self.num_layers):
            def attend(q, k_new, v_new, _n=n):
                ctx, _ = cached_attend(
                    cache[f"layer_{_n}"], q, k_new, v_new, pos, valid,
                    self.cdt, self.head_dim, impl=self.decode_attn_impl,
                    coords=coords, expand=self._repeat_kv,
                )
                return ctx

            x = self._block(self.layer(n), x, rope, attend,
                            layer_lora(lora, n))
        return self._logits(x[:, 0]), cache

    def extend_core(self, cache, token_ids, pos0, n_pad, prefix_len=None,
                    prefix_lo=None, all_logits: bool = False, lora=None):
        """Block forward of ``[B, U]`` tokens at slots ``[pos0, pos0+U)``
        against the cache, the contract of ``GptLM.extend_core``, with
        rotary positions per row."""
        _, u = token_ids.shape
        max_len = kv_cache_seq_len(cache)
        posq, mask = extend_positions_and_mask(
            max_len, u, pos0, n_pad, prefix_len, prefix_lo
        )
        rope = self._rope_for(posq)
        x = take(self.wte, token_ids)
        coords = kv_cache_coords(cache, pos0, u)
        for n in range(self.num_layers):
            def attend(q, k_new, v_new, _n=n):
                ctx, _ = cached_attend(
                    cache[f"layer_{_n}"], q, k_new, v_new, pos0, mask,
                    self.cdt, self.head_dim, impl=self.decode_attn_impl,
                    coords=coords, expand=self._repeat_kv,
                )
                return ctx

            x = self._block(self.layer(n), x, rope, attend,
                            layer_lora(lora, n))
        if not all_logits:
            x = x[:, -1]
        return cache, self._logits(x)

    # ------------------------------------------------------------------
    def param_shardings(self, layout=None):
        raise NotImplementedError(
            "tensor-parallel parameter layouts are not ported (ROADMAP "
            "Queue A item 8)"
        )
