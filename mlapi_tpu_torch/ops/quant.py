"""Weight-only int8 quantization, and the KV-cache formats and
layouts: full precision or int8 payload + f32 scales, contiguous or
paged.

Counterpart of ``mlapi_tpu/ops/quant.py``.

Weights (the end of this module): :func:`quantize_tree` turns every
float leaf with ``ndim >= 2`` and at least ``MIN_QUANT_SIZE`` elements
into a ``{"q": int8, "scale": f32}`` pair, symmetric per channel over
the LAST axis, in numpy on the host, bit for bit as the JAX package
does. Inside a model a quantized leaf is a :class:`QuantLeaf` module
(int8 ``q`` and f32 ``scale`` buffers) in the float parameter's place;
the models read every weight through :func:`weight` and gather
embedding rows through :func:`take`, so a quantized leaf dequantizes at
its use (``q.float() * scale``, then the site's own cast) and an
embedding only for the rows it gathers. A float leaf goes through the
same two calls as the plain ``t.to(dtype)`` / ``t[idx]``.

KV caches: a cache
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
from torch import nn

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


# -- weight-only int8 ------------------------------------------------------

# Leaves smaller than this stay float: quantizing a small bias saves
# nothing and costs accuracy.
MIN_QUANT_SIZE = 4096


def _quantize_array(a: np.ndarray):
    amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def _quantizable(a, min_size: int) -> bool:
    return (a.ndim >= 2 and a.size >= min_size
            and np.issubdtype(a.dtype, np.floating))


def quantize_tree(params, *, min_size: int = MIN_QUANT_SIZE):
    """Quantize every float leaf of a nested dict of arrays with
    ``ndim >= 2`` and ``size >= min_size`` to a per-channel symmetric
    int8 ``{"q", "scale"}`` pair (``scale`` keeps the reduced axes at
    length 1); other leaves pass through. Host-side numpy, one pass."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, min_size=min_size)
                for k, v in params.items()}
    a = np.asarray(params)
    if not _quantizable(a, min_size):
        return params
    q, scale = _quantize_array(a)
    return {"q": q, "scale": scale}


def dequantize_tree(params, dtype=torch.float32):
    """Every ``{"q", "scale"}`` pair of a nested dict → ``q * scale`` in
    ``dtype`` (f32 by default: each model site applies its own compute
    cast); other leaves pass through."""
    if _is_quant_leaf(params):
        return params["q"].to(dtype) * params["scale"].to(dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    return params


def _tree_leaves(params):
    if _is_quant_leaf(params) or not isinstance(params, dict):
        yield params
        return
    for v in params.values():
        yield from _tree_leaves(v)


def _numel(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(
        np.asarray(x).size)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.numel()) * x.element_size()
    return int(np.asarray(x).nbytes)


def is_quantized(params) -> bool:
    """Whether a nested dict holds a ``{"q", "scale"}`` pair, or a
    module a :class:`QuantLeaf`."""
    if isinstance(params, nn.Module):
        return any(isinstance(m, QuantLeaf) for m in params.modules())
    return any(_is_quant_leaf(x) for x in _tree_leaves(params))


def quantized_bytes(params) -> tuple[int, int]:
    """``(bytes as stored, bytes if fully f32)`` of a nested dict of
    arrays or of a module (its :class:`QuantLeaf` modules count as
    pairs), as the JAX package counts them."""
    if isinstance(params, nn.Module):
        params = _module_tree(params)
    stored = full = 0
    for x in _tree_leaves(params):
        if _is_quant_leaf(x):
            stored += _numel(x["q"]) + 4 * _numel(x["scale"])
            full += 4 * _numel(x["q"])
        else:
            stored += _nbytes(x)
            full += _nbytes(x)
    return stored, full


def _module_tree(module: nn.Module) -> dict:
    """A module's parameters and persistent buffers as a nested dict,
    each :class:`QuantLeaf` as its ``{"q", "scale"}`` pair."""
    if isinstance(module, QuantLeaf):
        return {"q": module.q, "scale": module.scale}
    tree: dict = {}
    for name, p in module._parameters.items():
        if p is not None:
            tree[name] = p
    for name, b in module._buffers.items():
        if b is not None and name not in module._non_persistent_buffers_set:
            tree[name] = b
    for name, child in module._modules.items():
        if child is not None:
            tree[name] = _module_tree(child)
    return tree


class QuantLeaf(nn.Module):
    """One int8 weight inside a model, in the float parameter's place:
    ``q`` (int8, the weight's shape) and ``scale`` (f32, the reduced
    axes at length 1), so the state dict holds ``<path>.q`` and
    ``<path>.scale``, the JAX package's quantized key paths."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequantize(self, dtype=None) -> torch.Tensor:
        w = self.q.to(torch.float32) * self.scale
        return w if dtype is None else w.to(dtype)


def weight(w, dtype=None):
    """A weight at its use: ``w.to(dtype)`` (``w`` itself for
    ``dtype=None``), or for a :class:`QuantLeaf` its f32 dequantization
    cast to ``dtype``."""
    if isinstance(w, QuantLeaf):
        return w.dequantize(dtype)
    return w if dtype is None else w.to(dtype)


def take(w, *idx):
    """``w[idx]``: gathered rows of a table. A :class:`QuantLeaf`
    dequantizes the gathered rows alone (its per-channel scales run
    along the last axis, which a row gather keeps)."""
    if isinstance(w, QuantLeaf):
        return w.q[idx].to(torch.float32) * w.scale.reshape(-1)
    return w[idx]


def quantize_module_(model: nn.Module) -> nn.Module:
    """Replace every float parameter of ``model`` with ``ndim >= 2`` and
    at least ``MIN_QUANT_SIZE`` elements by a :class:`QuantLeaf` holding its
    :func:`quantize_tree` pair, IN PLACE (the float storage is freed).
    The parameters are read on the host, so quantize before moving the
    model to the card."""
    for owner in list(model.modules()):
        for name, p in list(owner._parameters.items()):
            if p is None:
                continue
            a = p.detach().to("cpu", torch.float32).numpy() \
                if p.is_floating_point() else None
            if a is None or not _quantizable(a, MIN_QUANT_SIZE):
                continue
            q, scale = _quantize_array(a)
            del owner._parameters[name]
            owner.add_module(name, QuantLeaf(
                torch.from_numpy(q).to(p.device),
                torch.from_numpy(scale).to(p.device)))
    return model
