"""Decoder-only (GPT-2 style) causal LM with a KV-cache decode path.

Counterpart of ``mlapi_tpu/models/gpt.py``: pre-norm blocks (ln ->
attn -> residual, ln -> mlp -> residual, final ln), learned positions,
a weight-tied LM head, tanh GELU, a 4h MLP and LayerNorm eps 1e-5 —
the GPT-2 architecture. Numerics follow the JAX package: float32
residual stream, LayerNorm and softmax; matmuls in ``compute_dtype``
with float32 accumulation; logits in float32.

The parameters mirror the JAX pytree: ``wte``, ``wpe``, ``ln_f_*`` and
one submodule per layer, ``layer_{n}``, holding ``qkv``, ``attn_out``,
``ffn_up``, ``ffn_down`` (each ``kernel [d_in, d_out]`` + ``bias``) and
``ln1_*``/``ln2_*`` — so ``state_dict()`` keys are the JAX key paths
with ``.`` for ``/`` (``layer_0.qkv.kernel``).

Decoding: the JAX package compiles ``lax.scan`` programs that donate
the cache; here the decode and extend functions (``decode_step``,
``extend_core``, :func:`decode_chunk_fn`, :func:`extend_chunk_fn`)
write into the cache tensors IN PLACE and hand the same dict back. With
``decode_attn_impl="flash"`` every cache read goes through the CUDA
split-K kernels (``ops/cuda/decode_attention``): single-token steps
through flash-decode, multi-token spans through flash-extend, each in
its contiguous or paged form after the cache's layout. The paged
serving lifecycle uses :func:`paged_prefill_fn` and
:func:`paged_extend_fn`, which write through the page table into the
pool tensors in place. Shared-prefix serving adds
:func:`prefix_prefill_fn` (a cached prefix's KV under a suffix block),
and for the pool :func:`paged_scatter_fn` (a contiguous cache copied
into pages) and :func:`paged_cow_fn` (copy-on-write of whole pages).
The batched-speculation handoff adds :func:`realign_fn` (a per-row roll
of the cache) and :func:`paged_realign_fn` (the same through the page
tables).

Weights are read through ``ops/quant.weight`` / ``take``, so a model
quantized in place (``models/quantized``) serves through the same code.
Many-tenant serving passes a batch's adapter context as ``lora=`` to
``prefill_core`` / ``decode_step`` / ``extend_core`` (and the functions
below); each block adds ``models/lora.lora_apply``'s delta to its
projections. Without a context nothing is added.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.lora import layer_lora, lora_apply
from mlapi_tpu_torch.ops.attention import NEG, full_attention
from mlapi_tpu_torch.ops.cuda.flash_attention import flash_attention
from mlapi_tpu_torch.ops.quant import (
    KV_FORMATS,
    init_kv_cache,
    kv_cache_append,
    kv_cache_coords,
    kv_cache_kv,
    kv_cache_seq_len,
    kv_is_paged_layer,
    kv_is_quantized_layer,
    take,
    weight,
)
from mlapi_tpu_torch.utils.platform import resolve_device

_LN_EPS = 1e-5
_FILTERED = -1e30  # finite stand-in for -inf (prob == 0)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer_norm(x, scale, bias, eps: float = _LN_EPS):
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class _Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel [d_in, d_out]`` (the JAX
    orientation). The product and the bias add round separately in the
    compute dtype, as the JAX expression does. The kernel is read
    through ``ops/quant.weight``, so an int8 kernel
    (``models/quantized``) dequantizes here, at its use."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = _param(d_in, d_out)
        self.bias = _param(d_out)

    def forward(self, x, cdt):
        return x @ weight(self.kernel, cdt) + self.bias.to(cdt)


class _Block(nn.Module):
    def __init__(self, h: int, i: int):
        super().__init__()
        self.qkv = _Dense(h, 3 * h)
        self.attn_out = _Dense(h, h)
        self.ffn_up = _Dense(h, i)
        self.ffn_down = _Dense(i, h)
        self.ln1_scale = nn.Parameter(torch.ones(h), requires_grad=False)
        self.ln1_bias = _param(h)
        self.ln2_scale = nn.Parameter(torch.ones(h), requires_grad=False)
        self.ln2_bias = _param(h)


class DecoderLM(nn.Module):
    """What the decoder families (``GptLM``, ``LlamaLM``) share: the
    cache format and cache-read switches, the dtype and device views,
    layer lookup, the KV cache's shapes, and :meth:`generate` over the
    shared programs below.
    A family supplies ``prefill_core``, ``decode_step`` and
    ``extend_core`` (and ``kv_heads`` when it groups its queries)."""

    input_kind = "text"

    def configure(self, *, kv_quant=None, decode_attn_impl=None) -> None:
        """Set the KV-cache format and the cache-read attention, both
        validated (the JAX package's ``dataclasses.replace`` of the two
        fields)."""
        if kv_quant is not None:
            if kv_quant not in KV_FORMATS:
                raise ValueError(
                    f"unknown kv_quant {kv_quant!r}; one of {KV_FORMATS}"
                )
            self.kv_quant = kv_quant
        if decode_attn_impl is not None:
            if decode_attn_impl not in ("einsum", "flash"):
                raise ValueError(
                    f"unknown decode_attn_impl {decode_attn_impl!r}; "
                    'one of ("einsum", "flash")'
                )
            self.decode_attn_impl = decode_attn_impl

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Heads of the KV cache (a GQA family has fewer than
        ``num_heads``)."""
        return self.num_heads

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def layer(self, n: int):
        return getattr(self, f"layer_{n}")

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """Zeroed KV cache ``[B, max_len, KVH, D]`` per layer, in the
        compute dtype or the int8 layout (``ops/quant``), on ``device``
        (default: the model's; ``"meta"`` gives shapes alone, as the
        byte accounting of ``ops/quant`` and the engine reads them)."""
        return {
            f"layer_{n}": init_kv_cache(
                batch, max_len, self.kv_heads, self.head_dim, self.cdt,
                self.kv_quant, device=device or self.device,
            )
            for n in range(self.num_layers)
        }

    def generate(self, prompt_ids, *, max_new_tokens: int,
                 temperature=0.0, seed: int = 0, pad_lens=None, top_k=0,
                 top_p=1.0):
        """Greedy (``temperature=0``) or sampled generation; see
        :func:`run_generate`."""
        return run_generate(
            self, prompt_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed, pad_lens=pad_lens,
            top_k=top_k, top_p=top_p,
        )


@register_model("gpt_lm")
class GptLM(DecoderLM):
    """Decoder-only causal language model with weight-tied head.

    The constructor takes the JAX dataclass's fields. Parameters are
    drawn from ``seed`` with the JAX package's distributions (normal
    0.02 for ``wte`` and dense kernels, 0.01 for ``wpe``, zero biases,
    unit LayerNorm scales) on the CPU, then moved to ``device``, which
    resolves as every entry point's does (``utils/platform``: CUDA
    unless ``device="cpu"`` or ``MLAPI_TPU_PLATFORM=cpu``; raises with
    no card); ``seed=None`` skips the draw for weights about to be
    loaded.
    ``attention_impl`` is ``"full"`` or ``"flash"`` (the full-sequence
    ``apply`` through the B5-B7 kernels, ``ops/cuda/flash_attention``);
    ``"ring"`` waits for the parallel slice (ROADMAP Queue A item 8).
    The cache paths attend as ``decode_attn_impl`` says, whatever this
    is.
    """

    def __init__(
        self,
        vocab_size: int = 512,
        hidden_size: int = 256,
        num_layers: int = 4,
        num_heads: int = 4,
        max_positions: int = 256,
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
        if hidden_size % num_heads:
            raise ValueError("hidden_size must divide evenly into heads")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_positions = max_positions
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.configure(kv_quant=kv_quant, decode_attn_impl=decode_attn_impl)

        h, i, v = hidden_size, 4 * hidden_size, vocab_size
        self.wte = _param(v, h)
        self.wpe = _param(max_positions, h)
        self.ln_f_scale = nn.Parameter(torch.ones(h), requires_grad=False)
        self.ln_f_bias = _param(h)
        for n in range(num_layers):
            self.add_module(f"layer_{n}", _Block(h, i))
        if seed is not None:
            self._init_weights(int(seed))
        self.to(dev)

    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=gen)
            self.wpe.normal_(0.0, 0.01, generator=gen)
            for n in range(self.num_layers):
                layer = self.layer(n)
                for dense in (layer.qkv, layer.attn_out, layer.ffn_up,
                              layer.ffn_down):
                    dense.kernel.normal_(0.0, 0.02, generator=gen)

    def cast_dense_(self) -> "GptLM":
        """Store every dense kernel and bias in the compute dtype, IN
        PLACE. The forward casts them to that dtype at each use anyway
        (as the JAX package does), so outputs are unchanged; serving
        calls this once so the cast is not paid per decode step."""
        for n in range(self.num_layers):
            layer = self.layer(n)
            for dense in (layer.qkv, layer.attn_out, layer.ffn_up,
                          layer.ffn_down):
                if isinstance(dense.kernel, nn.Parameter):  # not int8
                    dense.kernel.data = dense.kernel.data.to(self.cdt)
                dense.bias.data = dense.bias.data.to(self.cdt)
        return self

    # ------------------------------------------------------------------
    def _block(self, layer: _Block, x, attend, lora=None):
        """One pre-norm transformer block; ``attend(q, k, v)`` supplies
        the attention so the full-sequence and cached paths share every
        other op. ``lora`` is the layer's serving adapters (see
        ``models/lora.lora_apply``), added to each projection's output;
        ``None`` (every path without adapter traffic) adds no op."""
        cdt = self.cdt
        b, l, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        xn = _layer_norm(x, layer.ln1_scale, layer.ln1_bias).to(cdt)
        qkv = lora_apply(lora, "qkv", xn, layer.qkv(xn, cdt))
        q, k, v = qkv.reshape(b, l, 3 * nh, hd).split(nh, dim=2)
        ctx = attend(q, k, v).reshape(b, l, -1)
        attn = lora_apply(lora, "attn_out", ctx, layer.attn_out(ctx, cdt))
        x = x + attn.to(torch.float32)
        xn = _layer_norm(x, layer.ln2_scale, layer.ln2_bias).to(cdt)
        up = lora_apply(lora, "ffn_up", xn, layer.ffn_up(xn, cdt))
        up = F.gelu(up.to(torch.float32), approximate="tanh").to(cdt)
        down = lora_apply(lora, "ffn_down", up, layer.ffn_down(up, cdt))
        return x + down.to(torch.float32)

    def _logits(self, x):
        x = _layer_norm(x, self.ln_f_scale, self.ln_f_bias)
        # Weight-tied head; logits in f32.
        return x.to(torch.float32) @ weight(self.wte, torch.float32).T

    def apply(self, token_ids):
        """``[B, L]`` ids → ``[B, L, V]`` next-token logits (causal)."""
        _, l = token_ids.shape
        pos = torch.arange(l, device=token_ids.device)
        x = take(self.wte, token_ids) + take(self.wpe, pos)[None]

        def attend(q, k, v):
            if self.attention_impl == "flash":
                return flash_attention(q, k, v, causal=True)
            return full_attention(q, k, v, causal=True)

        for n in range(self.num_layers):
            x = self._block(self.layer(n), x, attend)
        return self._logits(x)

    forward = apply

    # ------------------------------------------------------------------
    def prefill_core(self, prompt_ids, n_pad, total_len: int,
                     cache=None, pos0=0, lora=None):
        """Full causal forward over a left-padded ``[B, P]`` prompt,
        writing its K/V into a fresh ``[B, total_len]`` cache (or into
        ``cache`` at slot ``pos0``). Pads are masked and positions
        shifted so row ``b``'s real tokens sit at ``0..P-1-n_pad[b]``.
        Returns ``(cache, last_logits [B, V])``."""
        b, p = prompt_ids.shape
        cache = self.init_cache(b, total_len) if cache is None else cache
        dev = prompt_ids.device
        ar = torch.arange(p, device=dev)[None, :]
        pos_idx = torch.clamp(ar - n_pad[:, None], min=0)
        x = take(self.wte, prompt_ids) + take(self.wpe, pos_idx)
        mask = (ar >= n_pad[:, None]).to(torch.float32)
        coords = kv_cache_coords(cache, pos0, p)
        for n in range(self.num_layers):
            seen = {}

            def attend(q, k, v, _seen=seen):
                _seen["k"], _seen["v"] = k, v
                return full_attention(q, k, v, mask=mask, causal=True)

            x = self._block(self.layer(n), x, attend, layer_lora(lora, n))
            # The prompt attends full-precision in-register; only the
            # stored cache is quantized, at this append.
            kv_cache_append(cache[f"layer_{n}"], seen["k"], seen["v"],
                            pos0, self.cdt, coords)
        return cache, self._logits(x[:, -1])

    def decode_step(self, cache, token_ids, pos, n_pad=None,
                    prefix_len=None, prefix_lo=None, lora=None):
        """One decode step: ``[B, 1]`` ids at slot ``pos`` (an int, or a
        per-row ``[B]`` tensor) → ``(logits [B, V], cache)``. The new
        token's K/V is written into ``cache`` in place BEFORE the read,
        so the step attends to itself."""
        b = token_ids.shape[0]
        max_len = kv_cache_seq_len(cache)
        if n_pad is None:
            n_pad = torch.zeros((b,), dtype=torch.long,
                                device=token_ids.device)
        valid, shift = decode_valid_and_shift(
            max_len, pos, n_pad, prefix_len, prefix_lo
        )
        posq = torch.clamp(pos - shift, min=0)
        x = take(self.wte, token_ids) + take(self.wpe, posq)[:, None, :]
        coords = kv_cache_coords(cache, pos, 1)
        for n in range(self.num_layers):
            def attend(q, k_new, v_new, _n=n):
                ctx, _ = cached_attend(
                    cache[f"layer_{_n}"], q, k_new, v_new, pos, valid,
                    self.cdt, self.head_dim, impl=self.decode_attn_impl,
                    coords=coords,
                )
                return ctx

            x = self._block(self.layer(n), x, attend, layer_lora(lora, n))
        return self._logits(x[:, 0]), cache

    def extend_core(self, cache, token_ids, pos0, n_pad, prefix_len=None,
                    prefix_lo=None, all_logits: bool = False, lora=None):
        """Block forward of ``[B, U]`` tokens at slots ``[pos0,
        pos0+U)`` against the cache (written in place): each query
        attends every earlier valid slot plus the causal part of its
        own block. Returns ``(cache, last_logits [B, V])``, or logits
        at every position ``[B, U, V]`` with ``all_logits``."""
        _, u = token_ids.shape
        max_len = kv_cache_seq_len(cache)
        posq, mask = extend_positions_and_mask(
            max_len, u, pos0, n_pad, prefix_len, prefix_lo
        )
        x = take(self.wte, token_ids) + take(self.wpe, posq)
        coords = kv_cache_coords(cache, pos0, u)
        for n in range(self.num_layers):
            def attend(q, k_new, v_new, _n=n):
                ctx, _ = cached_attend(
                    cache[f"layer_{_n}"], q, k_new, v_new, pos0, mask,
                    self.cdt, self.head_dim, impl=self.decode_attn_impl,
                    coords=coords,
                )
                return ctx

            x = self._block(self.layer(n), x, attend, layer_lora(lora, n))
        if not all_logits:
            x = x[:, -1]
        return cache, self._logits(x)


def decode_valid_and_shift(max_len, pos, n_pad, prefix_len=None,
                           prefix_lo=None):
    """Decode-time key mask + per-row position shift. Valid keys: slot
    ``<= pos``, ``>= prefix_lo``, and outside the row's pad hole
    ``[prefix_len, prefix_len + n_pad[b])``; the shift maps slot ``s``
    to position ``s - prefix_lo - n_pad[b]``. ``pos`` and ``prefix_lo``
    are scalars or per-row ``[B]`` tensors. Returns ``(valid [B, 1, 1,
    L] bool, shift [B])``."""
    prefix_len = 0 if prefix_len is None else prefix_len
    prefix_lo = 0 if prefix_lo is None else prefix_lo
    idx = torch.arange(max_len, device=n_pad.device)[None, :]
    posk = pos[:, None] if _is_vector(pos) else pos
    lok = prefix_lo[:, None] if _is_vector(prefix_lo) else prefix_lo
    valid = (
        (idx <= posk)
        & (idx >= lok)
        & ((idx < prefix_len) | (idx >= prefix_len + n_pad[:, None]))
    )[:, None, None, :]
    return valid, prefix_lo + n_pad


def extend_positions_and_mask(max_len, u, pos0, n_pad, prefix_len=None,
                              prefix_lo=None):
    """Block-extend variant of :func:`decode_valid_and_shift`: for U
    queries at slots ``[pos0, pos0+U)``, per-row positions ``[B, U]``
    (clipped at 0 for pad slots) and the ``[B, 1, U, L]`` key mask."""
    prefix_len = 0 if prefix_len is None else prefix_len
    prefix_lo = 0 if prefix_lo is None else prefix_lo
    dev = n_pad.device
    idx = torch.arange(max_len, device=dev)
    pos0k = pos0[:, None] if _is_vector(pos0) else pos0
    lok = prefix_lo[:, None] if _is_vector(prefix_lo) else prefix_lo
    qpos = pos0k + torch.arange(u, device=dev)[None, :]   # [B|1, U]
    shift = prefix_lo + n_pad                             # [B]
    posq = torch.clamp(qpos - shift[:, None], min=0)
    valid_k = (idx[None, :] >= lok) & (
        (idx[None, :] < prefix_len)
        | (idx[None, :] >= prefix_len + n_pad[:, None])
    )                                                     # [B, L]
    causal = idx[None, None, :] <= qpos[:, :, None]       # [B|1, U, L]
    mask = (valid_k[:, None, :] & causal)[:, None, :, :]
    return posq, mask


def _is_vector(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim > 0


def cached_attend(cache_layer, q, k_new, v_new, pos, valid, cdt, head_dim,
                  impl: str = "einsum", coords=None, expand=None):
    """Attention against a fixed-shape KV cache, shared by decode steps
    and extend spans: append the new K/V at ``pos`` (in place, BEFORE
    the read; a paged layer's pool ``coords`` come from the caller,
    computed once for all layers), then attend ``q [B, U, H, D]`` to the
    whole cache under ``valid`` (``[B, 1, U, L]``). Returns ``(ctx,
    cache_layer)``.

    ``impl="einsum"`` is the reference oracle: the cache dequantizes at
    the read seam (a paged layer gathers its pages first) and two
    einsums attend. ``impl="flash"`` hands the STORED cache (int8
    payload + scales, or the compute-dtype tensors) to the CUDA
    kernels: flash-decode for ``U == 1``, flash-extend for multi-token
    spans; a paged layer's pools and table go to their paged twins,
    which read the pages in place. ``expand`` broadcasts the einsum
    path's KV heads to the query heads (a GQA family passes its
    ``repeat_interleave``; the kernels group query heads themselves)."""
    from mlapi_tpu_torch.ops.cuda import (
        decode_attention, extend_attention, paged_decode_attention,
        paged_extend_attention,
    )

    layer = kv_cache_append(cache_layer, k_new, v_new, pos, cdt, coords)
    if impl == "flash":
        if kv_is_quantized_layer(layer):
            k = {"q": layer["k_q"], "scale": layer["k_scale"]}
            v = {"q": layer["v_q"], "scale": layer["v_scale"]}
        else:
            k, v = layer["k"], layer["v"]
        scale = 1.0 / head_dim**0.5
        u = q.shape[1]
        mask = valid[:, 0, 0, :] if u == 1 else valid[:, 0]
        if kv_is_paged_layer(layer):
            fn = paged_decode_attention if u == 1 else paged_extend_attention
            ctx = fn(q, k, v, layer["table"], mask, scale=scale)
        else:
            fn = decode_attention if u == 1 else extend_attention
            ctx = fn(q, k, v, mask, scale=scale)
        return ctx, layer
    ck, cv = kv_cache_kv(layer, cdt)
    if expand is not None:
        ck, cv = expand(ck), expand(cv)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), ck.float()
    ) / head_dim**0.5
    scores = torch.where(valid, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum(
        "bhqk,bkhd->bqhd", probs.float(), cv.float()
    ).to(q.dtype)
    return ctx, layer


# -- sampling ------------------------------------------------------------

def _filter_top_k_top_p(scaled, top_k, top_p):
    """Per-row nucleus filtering on temperature-scaled logits ``[B,
    V]``: keep the ``top_k[b]`` highest (``<= 0`` or ``>= V``
    disables), then the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``top_p[b]`` (``<= 0`` or
    ``>= 1`` disables; the argmax always survives). Filtered logits
    become the finite ``-1e30``."""
    v = scaled.shape[-1]
    top_k = top_k.to(scaled.device)
    top_p = top_p.to(scaled.device, torch.float32)
    s = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.clamp(top_k, 1, v).to(torch.long)
    kth = s.gather(-1, (k_eff - 1)[:, None])
    apply_k = ((top_k > 0) & (top_k < v))[:, None]
    lg = torch.where(
        apply_k, torch.where(scaled >= kth, scaled, _FILTERED), scaled
    )
    ar = torch.arange(v, device=scaled.device)[None, :]
    s2 = torch.where(apply_k & (ar >= k_eff[:, None]), _FILTERED, s)
    probs = torch.softmax(s2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    thr = torch.where(keep, s2, math.inf).amin(dim=-1, keepdim=True)
    apply_p = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    return torch.where(
        apply_p, torch.where(lg >= thr, lg, _FILTERED), lg
    )


def _stream_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for (row seed, stream index): a row's
    draw at token ``index`` depends on nothing but these two."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def _pick_token(temps, logits, seeds, step, top_k=None, top_p=None):
    """Next token per row: greedy where ``temps[b] <= 0``, else sampled
    from ``logits / temps[b]`` (top-k/top-p filtered) with a
    ``torch.Generator`` seeded from the row's seed and its own token
    index ``step[b]`` — a row's stream does not depend on its batch
    slot. ``temps``, ``seeds``, ``step``, ``top_k`` and ``top_p`` are
    host arrays (or scalars for ``step``). JAX's PRNG draws are not
    reproduced; greedy decoding is identical."""
    b, v = logits.shape
    temps = np.asarray(temps, np.float32).reshape(b)
    greedy = torch.argmax(logits, dim=-1)
    if not np.any(temps > 0.0):
        return greedy
    step = np.broadcast_to(np.asarray(step, np.int64), (b,))
    top_k = np.zeros(b, np.int64) if top_k is None else np.asarray(top_k)
    top_p = np.ones(b, np.float32) if top_p is None else np.asarray(top_p)
    safe_t = np.where(temps > 0.0, temps, 1.0).astype(np.float32)
    scaled = logits / torch.as_tensor(safe_t, device=logits.device)[:, None]
    if np.any((top_k > 0) & (top_k < v)) or np.any(
        (top_p > 0.0) & (top_p < 1.0)
    ):
        scaled = _filter_top_k_top_p(
            scaled, torch.as_tensor(top_k), torch.as_tensor(top_p)
        )
    out = greedy.clone()
    for row in np.flatnonzero(temps > 0.0):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_stream_seed(seeds[row], step[row]))
        probs = torch.softmax(scaled[row].to(torch.float32), dim=-1)
        out[row] = torch.multinomial(probs, 1, generator=gen)[0]
    return out


# -- generation programs (in place, no compilation) ------------------------

def run_generate(model, prompt_ids, *, max_new_tokens: int,
                 temperature=0.0, seed: int = 0, pad_lens=None, top_k=0,
                 top_p=1.0):
    """Prefill ``[B, P]`` then ``max_new_tokens - 1`` cached decode
    steps → ``[B, max_new_tokens]`` tokens. ``pad_lens`` marks each
    row's left pads (masked; positions shifted). Row ``b`` samples with
    the seed ``_stream_seed(seed, b)``."""
    prompt_ids = torch.as_tensor(prompt_ids, device=model.device)
    b, p = prompt_ids.shape
    if p + max_new_tokens > model.max_positions:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_positions ({model.max_positions})"
        )
    seeds = np.asarray([_stream_seed(seed, i) for i in range(b)], np.int64)
    temps = np.broadcast_to(np.asarray(temperature, np.float32), (b,))
    top_k = np.broadcast_to(np.asarray(top_k, np.int64), (b,))
    top_p = np.broadcast_to(np.asarray(top_p, np.float32), (b,))
    n_pad = torch.as_tensor(
        np.zeros(b, np.int64) if pad_lens is None
        else np.asarray(pad_lens, np.int64),
        device=model.device,
    )
    first, cache = prefill_fn(
        model, prompt_ids, seeds, temps, n_pad, top_k, top_p,
        total_len=p + max_new_tokens,
    )
    if max_new_tokens == 1:
        return first[:, None]
    rest, _, _ = decode_chunk_fn(
        model, cache, first, p, n_pad, temps, seeds, 1, top_k, top_p,
        chunk=max_new_tokens - 1,
    )
    return torch.cat([first[:, None], rest], dim=1)


@torch.no_grad()
def prefill_fn(model, prompt_ids, seeds, temps, n_pad, top_k, top_p, *,
               total_len: int, lora=None):
    """Prefill + first token: ``(first_tok [B], cache)`` for a fresh
    ``[B, total_len]`` cache. ``lora`` (here and in the functions
    below) is the batch's serving-adapter context, or None."""
    cache, logits = model.prefill_core(prompt_ids, n_pad, total_len,
                                       lora=lora)
    return _pick_token(temps, logits, seeds, 0, top_k, top_p), cache


@torch.no_grad()
def decode_chunk_fn(model, cache, tok, pos: int, n_pad, temps, seeds,
                    step0, top_k, top_p, *, chunk: int, prefix_len=0,
                    prefix_lo=0, lora=None):
    """``chunk`` cached decode steps from the last emitted ``tok [B]``
    whose successor is written at slot ``pos``; ``step0`` (scalar or
    per-row) is the sampling-stream index of the first step. The cache
    is updated IN PLACE. Returns ``(tokens [B, chunk], cache,
    last_tok)``."""
    step0 = np.broadcast_to(np.asarray(step0, np.int64), (tok.shape[0],))
    toks = []
    for i in range(chunk):
        logits, cache = model.decode_step(
            cache, tok[:, None], pos + i, n_pad, prefix_len, prefix_lo,
            lora=lora,
        )
        tok = _pick_token(temps, logits, seeds, step0 + i, top_k, top_p)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache, tok


@torch.no_grad()
def extend_chunk_fn(model, cache, chunk_ids, pos0: int, n_pad, lora=None):
    """Chunked prefill: one ``[B, width]`` block of a long prompt
    forwarded against the cache at slot ``pos0`` (``extend_core``),
    cache updated IN PLACE. Returns ``(cache, last_logits)``; callers
    sample the final chunk's logits with :func:`sample_fn`."""
    return model.extend_core(cache, chunk_ids, pos0, n_pad, 0, 0, lora=lora)


@torch.no_grad()
def paged_prefill_fn(model, cache, prompt_ids, off: int, seeds, temps,
                     n_pad, top_k, top_p, lora=None):
    """Page-native prefill + first token: the same full causal forward
    as :func:`prefill_fn` (the prompt attends in full precision, no
    kernel), with the K/V append written through ``cache``'s page table
    at VIRTUAL slot ``off`` (the row's bucket start) into the pool
    tensors, in place. ``n_pad`` is the row's LOCAL pad count (``bucket
    - used``): positions are ``local_slot - n_pad``, whatever ``off``.
    Returns ``(first_tok [R], cache)``."""
    cache, logits = model.prefill_core(prompt_ids, n_pad, 0, cache=cache,
                                       pos0=off, lora=lora)
    return _pick_token(temps, logits, seeds, 0, top_k, top_p), cache


@torch.no_grad()
def paged_extend_fn(model, cache, chunk_ids, pos0: int, n_pad,
                    prefix_len=0, lo=0, lora=None):
    """One ``[B, width]`` block forward against a PAGED cache at slot
    ``pos0`` (``extend_core``), pools written in place: the chunked
    long-prompt prefill of a paged engine (``prefix_len = lo = 0``).
    Returns ``(cache, last_logits)``; callers sample the final block's
    logits with :func:`sample_fn`."""
    return model.extend_core(cache, chunk_ids, pos0, n_pad, prefix_len, lo,
                             lora=lora)


@torch.no_grad()
def prefix_prefill_fn(model, prefix_kv, suffix_ids, hole, lo, seeds, temps,
                      top_k, top_p, *, total: int):
    """Shared-prefix prefill + first token: a cached prefix's KV
    (``prefix_kv``, a ``[1, P]``-shaped cache from the prefix's own
    prefill) is written into slots ``[0, P)`` of EVERY row of a fresh
    ``[B, total]`` cache, then the left-padded ``[B, U]`` suffix runs as
    ONE ``extend_core`` block at slots ``[P, P+U)``: the prefix's
    forward is never recomputed. ``hole [B]`` is each row's suffix pad
    count (the pad hole of the mask helpers) and ``lo`` the prefix's own
    left pad. A cross-prefix batch passes a per-row ``[B, P]`` stack
    (each row's prefix right-aligned to the common region end ``P``)
    and a per-row ``[B]`` ``lo``. Sampling draws at stream index 0, so
    the stream is the one the same prompt gets without a prefix.
    Returns ``(first_tok [B], cache)``."""
    b = suffix_ids.shape[0]
    p_len = next(iter(prefix_kv["layer_0"].values())).shape[1]
    cache = model.init_cache(b, total)
    for ln, layer in cache.items():
        for name, leaf in layer.items():
            leaf[:, :p_len] = prefix_kv[ln][name]
    cache, logits = model.extend_core(cache, suffix_ids, p_len, hole, p_len,
                                      lo)
    return _pick_token(temps, logits, seeds, 0, top_k, top_p), cache


@torch.no_grad()
def paged_scatter_fn(cache, mini, table, off: int):
    """Paged ADOPT: copy a contiguous ``[R, W]``-shaped cache ``mini``
    (a prefix entry's KV, a widened prefix stack) into pool pages at
    virtual slots ``[off, off + W)`` of the ``[R, NP]`` page-table rows
    ``table``, IN PLACE: one ``index_put_`` per pool leaf, at the
    coordinates of the paged append (``ops/quant._paged_coords``).
    Returns ``cache``."""
    from mlapi_tpu_torch.ops.quant import _paged_coords

    layer0 = cache["layer_0"]
    w = next(iter(mini["layer_0"].values())).shape[1]
    tab = torch.as_tensor(np.asarray(table, np.int32),
                          device=layer0["table"].device)
    pids, offs = _paged_coords({**layer0, "table": tab}, off, w)
    for ln, layer in cache.items():
        for name, upd in mini[ln].items():
            layer[name].index_put_((pids, offs), upd.to(layer[name].dtype))
    return cache


@torch.no_grad()
def paged_cow_fn(cache, src, dst):
    """Copy-on-write, the device half: duplicate pool pages ``src`` into
    pages ``dst`` (``[R]`` ids each, disjoint) across every layer's
    pools, IN PLACE. R pages move, whatever the sequence length or the
    batch; the caller rewrites the host page table. Returns ``cache``."""
    dev = next(iter(cache["layer_0"].values())).device
    src = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    for layer in cache.values():
        for name, pool in layer.items():
            if name != "table":
                pool.index_copy_(0, dst, pool.index_select(0, src))
    return cache


def _as_delta(delta, dev):
    return torch.as_tensor(np.asarray(delta, np.int64), device=dev)


@torch.no_grad()
def realign_fn(cache, delta):
    """Per-row cache ROLL for the batched-speculation handoff, IN PLACE:
    row ``b``'s slots shift right by ``delta[b]`` (``new[b, i] = old[b,
    i - delta_b]``; reads below slot 0 clamp to it and are garbage).
    Callers bump ``n_pad[b] += delta_b``, so every effective position
    (``slot - n_pad``) is unchanged: the learned positions and the
    stored rotary phases key on it, and the scalar-``pos`` chunk loop
    resumes as if the rows had always been in step. Each leaf is
    gathered whole before it is written back. Returns ``cache``."""
    dev = next(iter(cache["layer_0"].values())).device
    delta = _as_delta(delta, dev)
    for layer in cache.values():
        for leaf in layer.values():
            b, length = leaf.shape[:2]
            idx = torch.arange(length, device=dev)[None, :] - delta[:, None]
            idx = idx.clamp(0, length - 1)
            idx = idx.reshape((b, length) + (1,) * (leaf.ndim - 2))
            leaf.copy_(torch.gather(leaf, 1, idx.expand(leaf.shape)))
    return cache


@torch.no_grad()
def paged_realign_fn(cache, delta):
    """The paged twin of :func:`realign_fn` for a handoff whose deltas
    are not all page multiples (a page-multiple shift is a host table
    edit, ``BatchRun._paged_realign``): every row's virtual window is
    gathered at the shifted coordinates through its table (``new[b, v]
    = old[b, v - delta_b]``, clamped likewise), then scattered back into
    the row's OWN pages, IN PLACE. Unmapped tiles route to the null
    page, which nothing reads. Rows must not share pages (batched
    speculation takes only ``p_len == 0`` batches). Returns ``cache``."""
    from mlapi_tpu_torch.ops.quant import kv_layer_page_size

    layer0 = cache["layer_0"]
    table = layer0["table"].long()
    page = kv_layer_page_size(layer0)
    b, npv = table.shape
    length = npv * page
    dev = table.device
    vdst = torch.arange(length, device=dev)[None, :].expand(b, length)
    vsrc = (vdst - _as_delta(delta, dev)[:, None]).clamp(0, length - 1)
    pd = torch.gather(table, 1, vdst // page)
    ps = torch.gather(table, 1, vsrc // page)
    od, os_ = vdst % page, vsrc % page
    for layer in cache.values():
        for name, pool in layer.items():
            if name != "table":
                pool.index_put_((pd, od), pool[ps, os_])
    return cache


def sample_fn(logits, seeds, temps, top_k, top_p):
    """Each row's first token from the final prefill chunk's logits, at
    stream index 0 (the same draw as :func:`prefill_fn`)."""
    return _pick_token(temps, logits, seeds, 0, top_k, top_p)
