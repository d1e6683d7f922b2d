"""The KV-cache formats and layouts: full precision or int8 payload +
f32 scales, contiguous or paged.

Counterpart of the KV subset of ``mlapi_tpu/ops/quant.py``. A cache
layer is a dict of tensors: ``{"k", "v"}`` in the compute dtype, or
``{"k_q", "k_scale", "v_q", "v_scale"}`` for ``kv_quant="int8"``
(symmetric per-token-per-head int8, ``scale f32[B, L, H, 1]``).

The paged layout keeps the same key names with POOL-shaped leaves
``[P, page, H, D]`` and adds the layer's page table, ``{"k": ...,
"v": ..., "table": int32[B, NP]}``: virtual slot ``s`` of row ``b``
lives at ``pool[table[b, s // page], s % page]``. Page id 0 is the
null page: unallocated table entries point at it, dummy and finished
rows write their dead tokens into it, and no row reads it unmasked.
The presence of ``"table"`` is the one paged predicate. Allocation and
refcounts are host bookkeeping (``serving/paged_pool.py``).

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

import numpy as np
import torch

KV_FORMATS = ("none", "int8")


def _is_quant_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def kv_is_quantized_layer(layer: dict) -> bool:
    return "k_q" in layer


KV_PAGED_NULL = 0  # reserved pool page id: unallocated / dead writes


def kv_is_paged_layer(layer: dict) -> bool:
    """Is this per-layer cache dict in the paged (pool + table)
    layout?"""
    return isinstance(layer, dict) and "table" in layer


def kv_layer_page_size(layer: dict) -> int:
    """Tokens per page of a paged layer (pool dim 1)."""
    leaf = layer["k_q"] if kv_is_quantized_layer(layer) else layer["k"]
    return leaf.shape[1]


def _paged_coords(layer: dict, pos, u: int):
    """``(pids, offs)``, both ``[B, u]`` long, for virtual slots ``[pos,
    pos + u)`` (``pos`` an int or a per-row ``[B]`` tensor) of every
    row."""
    table = layer["table"]
    page = kv_layer_page_size(layer)
    b = table.shape[0]
    ar = torch.arange(u, device=table.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        vpos = pos.to(table.device, torch.long)[:, None] + ar[None, :]
    else:
        vpos = (int(pos) + ar)[None, :].expand(b, u)
    pids = torch.gather(table, 1, vpos // page).long()
    return pids, vpos % page


def kv_cache_coords(cache: dict, pos, u: int):
    """The pool coordinates of a ``u``-token append at slot ``pos`` for
    a whole paged cache (every layer shares one page table), or ``None``
    for a contiguous cache: a forward computes them once and hands them
    to each layer's :func:`kv_cache_append`."""
    layer = cache["layer_0"]
    return _paged_coords(layer, pos, u) if kv_is_paged_layer(layer) else None


def kv_gather_pages(pool, table):
    """``pool [P, page, ...]`` through ``table [B, NP]`` → the
    contiguous ``[B, NP * page, ...]`` layout (``pool[table]``). Page
    ids are checked on the CPU, so an id outside ``[0, P)`` raises
    ``IndexError``. (On the card the check would be a host sync, which
    CUDA graph capture refuses; the gather's own device-side bounds
    check stands.)"""
    n = pool.shape[0]
    if table.device.type == "cpu" and table.numel() and (
        int(table.min()) < 0 or int(table.max()) >= n
    ):
        bad = table[(table < 0) | (table >= n)]
        raise IndexError(
            f"page id {int(bad[0])} out of range for a pool of {n} pages"
        )
    g = pool[table.long()]                            # [B, NP, page, ...]
    return g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))


def make_paged_pools(model, num_pages: int, page_size: int) -> dict:
    """Zeroed device page pools for every layer of ``model``'s cache
    format: each ``[1, page, H, D]``-shaped cache leaf becomes a
    ``[num_pages, page, H, D]`` pool (int8 scales ride along). Page 0
    is the null page; callers never allocate it."""
    return model.init_cache(num_pages, page_size)


def paged_cache_tree(pools: dict, table) -> dict:
    """The paged cache a decode/extend/prefill call takes: every
    layer's pool tensors (the SAME tensors, written in place) plus the
    page table, freshly uploaded from the host ``[B, NP]`` array (the
    source of truth). A new upload each time the host table changes:
    work already enqueued keeps reading the table it was given.
    ``pools`` may be bare pool layers or an earlier cache (its stale
    table is replaced)."""
    pools = paged_pools_of(pools)
    dev = next(iter(pools["layer_0"].values())).device
    tab = torch.as_tensor(np.asarray(table, np.int32), device=dev)
    return {ln: {**layer, "table": tab} for ln, layer in pools.items()}


def paged_pools_of(cache: dict) -> dict:
    """Inverse of :func:`paged_cache_tree`: the pool tensors alone."""
    return {
        ln: {n: t for n, t in layer.items() if n != "table"}
        for ln, layer in cache.items()
    }


def kv_page_bytes(model, page_size: int) -> int:
    """Exact device bytes of one page across every layer: the model's
    own ``init_cache(1, page_size)`` on the meta device (shapes and
    dtypes, no memory), so a GQA model counts its KV heads."""
    return kv_tree_bytes(model.init_cache(1, page_size, device="meta"))


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


def kv_cache_append(layer: dict, k_new, v_new, pos, cdt,
                    coords=None) -> dict:
    """Write a ``[B, U, H, D]`` K/V block into ``layer`` at slot ``pos``
    (scalar, or per-row ``[B]``), IN PLACE; returns ``layer``. An int8
    layer quantizes the block first and writes payload and scales.

    A paged layer takes one ``index_put_`` per leaf at the table-mapped
    pool coordinates ``(table[b, v // page], v % page)`` (``coords``,
    from :func:`kv_cache_coords`, or computed here): a block may span
    pages, and rows whose table entry is the null page write their dead
    tokens there (several rows may hit the same null slot in one call;
    nothing reads it unmasked)."""
    if kv_is_quantized_layer(layer):
        kq, ks = kv_quantize(k_new)
        vq, vs = kv_quantize(v_new)
        updates = {"k_q": kq, "k_scale": ks, "v_q": vq, "v_scale": vs}
    else:
        updates = {"k": k_new.to(cdt), "v": v_new.to(cdt)}
    if kv_is_paged_layer(layer):
        if coords is None:
            coords = _paged_coords(layer, pos, k_new.shape[1])
        pids, offs = coords
        for name, upd in updates.items():
            layer[name].index_put_((pids, offs), upd.to(layer[name].dtype))
        return layer
    for name, upd in updates.items():
        _write(layer[name], upd, pos)
    return layer


def kv_cache_kv(layer: dict, cdt):
    """The einsum read seam: a cache layer → ``(k, v)`` in the compute
    dtype (an int8 layer dequantizes here). A paged layer gathers its
    pages into the contiguous ``[B, NP * page, H, D]`` layout first
    (``pool[table]``): the einsum path over a paged cache is the
    contiguous oracle with one gather."""
    if kv_is_paged_layer(layer):
        layer = {n: kv_gather_pages(t, layer["table"])
                 for n, t in layer.items() if n != "table"}
    if kv_is_quantized_layer(layer):
        return (
            kv_dequantize(layer["k_q"], layer["k_scale"], cdt),
            kv_dequantize(layer["v_q"], layer["v_scale"], cdt),
        )
    return layer["k"], layer["v"]


def kv_cache_seq_len(cache: dict) -> int:
    """Sequence capacity of a cache: the contiguous buffer length, or
    pages per row x page size for the paged layout (the virtual length
    every mask and position helper sees)."""
    layer = cache["layer_0"]
    leaf = layer["k_q"] if kv_is_quantized_layer(layer) else layer["k"]
    if kv_is_paged_layer(layer):
        return layer["table"].shape[1] * leaf.shape[1]
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
