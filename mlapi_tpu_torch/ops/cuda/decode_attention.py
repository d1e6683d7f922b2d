"""Flash-decode (B1), flash-extend (B2) and their paged twins (B3, B4):
split-K attention that reads the stored KV cache, int8 payload
included, inside a CUDA kernel.

Counterpart of ``mlapi_tpu/ops/pallas/decode_attention.py``
(``decode_attention`` / ``extend_attention`` / ``paged_decode_attention``
/ ``paged_extend_attention``). The kernel is ``csrc/decode_attention.cu``;
its source note says what bounds it on an H100 and what the design does
about that. Here are the public functions, with the JAX layouts kept:

- ``q``: ``[B, 1, H, D]`` (decode) or ``[B, U, H, D]`` (extend);
- ``k``/``v``: ``[B, L, KVH, D]`` tensors, or int8 ``{"q", "scale"}``
  pairs with ``scale f32[B, L, KVH, 1]``; for the paged functions,
  pools ``[P, page, KVH, D]`` (int8 pairs with ``scale f32[P, page,
  KVH, 1]``) plus an int32 page ``table [B, NP]``: virtual slot ``s``
  of row ``b`` is ``pool[table[b, s // page], s % page]``;
- ``mask``: binary ``[B, L]`` (decode) or ``[B, U, L]`` (extend, with
  the causal intra-span structure encoded in it), over virtual slots
  (``L = NP * page``) for the paged functions;
- result in ``q.dtype``, same shape as ``q``.

For a CUDA tensor a wrapper launches its kernel or raises; it runs the
plain version (``*_plain`` below, the same algorithm in PyTorch ops)
only for tensors on the CPU. Each wrapper counts its kernel launches
in ``<wrapper>.launches``, and by body in ``<wrapper>.bodies``.

The source has three bodies (:func:`_geometry` says which one a call
runs): ``"decode"`` for every decode call (B1, B3), a memory pipeline
whose splits meet in a thread-block cluster, so one launch per call;
``"mma"``, tensor cores, for the extend entry points with bf16 queries
over a bf16 or int8 cache at a compiled head dim up to 128; ``"fma"``,
CUDA-core f32, for the other extend calls (f32 queries, one-token spans,
other head dims), whose split-K merge -- computed in jnp outside the Pallas
kernel by the JAX package -- is a second small CUDA kernel launched by
the same C call when the call has more than one split, as it is for a
multi-split ``mma`` call.

Head dims: every ``d >= 1``. The CUDA-core bodies are compiled for
``d`` in 16, 32, 64, 128 and 256, the tensor-core body for 16, 32, 64
and 128; another ``d`` up to 256 runs the CUDA-core bodies at the next
compiled one with guarded loads, over the cache as it is. A ``d`` past
256 runs the CUDA-core split-K body (``"fma"``, decode calls too) at 256
in ``ceil(d / 256)`` column chunks: each block owns 256 output columns
and sums its scores over every chunk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mlapi_tpu_torch.ops.attention import NEG
from mlapi_tpu_torch.ops.quant import _is_quant_leaf, kv_gather_pages

_COMPILED_DIMS = (16, 32, 64, 128, 256)
_MMA_DIMS = (16, 32, 64, 128)
# Per body: keys per tile, query rows per block, blocks aimed at per SM,
# most tiles in one split (the mma body holds a split's mask words). The
# mma body aims at one block per SM: a call with one split skips the
# merge kernel, which costs more than the occupancy a second split buys.
# The decode body's tile, rows per block and blocks per SM depend on the
# call (below); its splits, one cluster, are at most 8 (``kMaxCluster``).
_BODIES = {"mma": (64, 64, 1, 16), "fma": (32, 32, 4, None),
           "decode": (None, None, None, 8)}
# decode: bytes of K (and of V) in a warp's tile (``kDecTileBytes``), and
# the blocks of 128 threads that fit an SM by the registers of a body
# serving 1, 2, 4 or 8 query heads (ptxas: at most 72, 96, 128 and 255
# registers; the 24-26 KB rings would fit eight).
_DECODE_TILE_BYTES = 1024
_DECODE_BLOCKS_PER_SM = {1: 7, 2: 5, 4: 4, 8: 2}
_EXTEND_ENTRIES = ("mlapi_extend_attention", "mlapi_paged_extend_attention")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _unpack(x):
    """``(payload, scale_or_None)`` of a K/V operand."""
    if isinstance(x, dict):
        if _is_quant_leaf(x):
            return x["q"], x["scale"]
        raise TypeError(
            "decode_attention takes tensors or {'q', 'scale'} quantized "
            f"pairs, got dict with keys {sorted(x)}"
        )
    return x, None


def _operands(q, k, v, mask, decode: bool, table=None):
    kq, ks = _unpack(k)
    vq, vs = _unpack(v)
    if (ks is None) != (vs is None):
        raise ValueError("k and v must share one cache format")
    b, uq, h, d = q.shape
    if kq.shape != vq.shape or kq.ndim != 4 or kq.shape[3] != d:
        raise ValueError(
            f"cache shapes disagree with q: k {tuple(kq.shape)}, "
            f"v {tuple(vq.shape)}, q {tuple(q.shape)}"
        )
    kvh = kq.shape[2]
    if table is None:
        lk = kq.shape[1]
    else:
        if table.ndim != 2 or table.shape[0] != b:
            raise ValueError(
                f"page table {tuple(table.shape)} must be [B={b}, NP]"
            )
        if table.dtype != torch.int32:
            raise ValueError(f"page table must be int32, got {table.dtype}")
        lk = table.shape[1] * kq.shape[1]   # virtual slots: NP * page
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({kvh})"
        )
    want = (b, lk) if decode else (b, uq, lk)
    if tuple(mask.shape) != want:
        raise ValueError(
            f"mask {tuple(mask.shape)} must be {list(want)} "
            + ("[B, L]" if decode else "[B, U, L] (per span position)")
            + (" over the virtual layout NP * page" if table is not None
               else "")
        )
    return kq, ks, vq, vs


def _fit_block(requested: int, length: int) -> int:
    """Largest halving of ``requested`` dividing ``length`` (the JAX
    package's tiling rule, so the plain version rounds like the Pallas
    kernel it is compared with)."""
    blk = min(requested, length)
    while length % blk:
        blk //= 2
    if blk < 8 and blk < length:
        return length
    return blk


def _splitk_plain(q, kd, vd, mask3, scale, block_k):
    """The Pallas kernels' algorithm in PyTorch ops: per ``block_k``
    tile, ``(acc, m, l)`` for every query row (dead tiles give the
    identity triple), then the log-sum-exp merge. ``q [B, U, H, D]``,
    ``kd``/``vd`` ``[B, L, KVH, D]`` (already in the compute dtype),
    ``mask3 [B, U, L]`` → ``[B, U, H, D]`` in ``q.dtype``."""
    b, u, h, d = q.shape
    lk, kvh = kd.shape[1], kd.shape[2]
    group = h // kvh
    bk = _fit_block(block_k, lk)
    nk = lk // bk
    kt = kd.repeat_interleave(group, dim=2).reshape(b, nk, bk, h, d)
    vt = vd.repeat_interleave(group, dim=2).reshape(b, nk, bk, h, d)
    keep = mask3.to(torch.float32).reshape(b, u, nk, bk).permute(0, 2, 1, 3)
    keep = keep[:, :, :, None, :]                     # [B, nk, U, 1, bk]
    s = torch.einsum("buhd,bkthd->bkuht", q.float(), kt.float()) * scale
    s = s + (1.0 - keep) * NEG
    m = s.amax(dim=-1, keepdim=True)                  # [B, nk, U, H, 1]
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(
        "bkuht,bkthd->bkuhd", p.to(vd.dtype).float(), vt.float()
    )
    live = (keep > 0).flatten(2).any(dim=-1)[:, :, None, None, None]
    acc = torch.where(live, acc, torch.zeros_like(acc))
    m = torch.where(live, m, torch.full_like(m, NEG))
    l = torch.where(live, l, torch.zeros_like(l))
    return _merge(acc, m, l).to(q.dtype)


def _merge(acc, m, l):
    """Split-K reduction over dim 1 (the JAX package's
    ``_splitk_merge_rows``): rows with no valid key come out zero."""
    m_max = m.amax(dim=1, keepdim=True)
    alpha = torch.exp(m - m_max)
    l_tot = (alpha * l).sum(dim=1)
    acc_tot = (alpha * acc).sum(dim=1)
    return acc_tot / torch.clamp(l_tot, min=1e-30)


def _dequant(payload, scale, dtype):
    return payload if scale is None else (
        payload.to(dtype) * scale.to(dtype)
    )


def decode_attention_plain(q, k, v, mask, *, scale=None,
                           block_k: int = 512):
    """B1's plain version: the same function as the kernel, in PyTorch
    ops (any device)."""
    kq, ks, vq, vs = _operands(q, k, v, mask, True)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    return _splitk_plain(
        q, _dequant(kq, ks, q.dtype), _dequant(vq, vs, q.dtype),
        mask[:, None, :], scale, block_k,
    )


def extend_attention_plain(q, k, v, mask, *, scale=None,
                           block_k: int = 512):
    """B2's plain version: the same function as the kernel, in PyTorch
    ops (any device)."""
    kq, ks, vq, vs = _operands(q, k, v, mask, False)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    return _splitk_plain(
        q, _dequant(kq, ks, q.dtype), _dequant(vq, vs, q.dtype),
        mask, scale, block_k,
    )


def paged_decode_attention_plain(q, k, v, table, mask, *, scale=None):
    """B3's plain version: gather ``pool[table]`` and run the split-K
    algorithm with one tile per page (the Pallas paged tiling)."""
    kq, ks, vq, vs = _operands(q, k, v, mask, True, table)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    return _paged_plain(q, kq, ks, vq, vs, table, mask[:, None, :], scale)


def paged_extend_attention_plain(q, k, v, table, mask, *, scale=None):
    """B4's plain version: gather ``pool[table]`` and run the split-K
    algorithm with one tile per page (the Pallas paged tiling)."""
    kq, ks, vq, vs = _operands(q, k, v, mask, False, table)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    return _paged_plain(q, kq, ks, vq, vs, table, mask, scale)


def _paged_plain(q, kq, ks, vq, vs, table, mask3, scale):
    page = kq.shape[1]

    def gathered(payload, sc):
        return _dequant(
            kv_gather_pages(payload, table),
            None if sc is None else kv_gather_pages(sc, table), q.dtype,
        )

    return _splitk_plain(
        q, gathered(kq, ks), gathered(vq, vs), mask3, scale, page,
    )


_ARGTYPES = {
    # q, k, v, ks, vs, mask, partials, out | 3 strides | dtype, quant,
    # B, U, H, KVH, L, D, S, tiles_per_split, row_chunks | scale, stream
    "contiguous": (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    ),
    # q, k, v, ks, vs, table, mask, partials, out | 3 strides | dtype,
    # quant, B, U, H, KVH, NP, page, D, S, tiles_per_split, row_chunks
    # | scale, stream
    "paged": (
        [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    ),
}
_ENTRY_LAYOUT = {
    "mlapi_decode_attention": "contiguous",
    "mlapi_extend_attention": "contiguous",
    "mlapi_paged_decode_attention": "paged",
    "mlapi_paged_extend_attention": "paged",
}


@functools.cache
def _entries():
    """The four entry points of the kernel library, argtypes set once:
    pointers and the stream as ``c_void_p`` (so none is cut to 32
    bits), q's three strides as ``c_longlong``, the rest ``c_int`` and
    the scale ``c_float``."""
    from mlapi_tpu_torch.ops.cuda import build

    lib = build.load("decode_attention")
    out = {}
    for name, layout in _ENTRY_LAYOUT.items():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[layout]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Geometry(NamedTuple):
    """How one call is cut: the body that runs, its tile and row-block
    sizes, the grid's row blocks and splits, and the f32 scratch the
    kernel writes its partials into."""

    body: str               # "decode", "mma" (tensor cores) or "fma"
    tile_keys: int          # keys per tile
    rows_per_block: int     # query rows per block
    row_chunks: int         # row blocks per KV head
    splits: int             # key splits per row block
    tiles_per_split: int
    # acc [n, D] + m [n] + l [n], n = B*S*KVH*rows; none when the mma
    # body runs one split (it then writes the output itself).
    partial_floats: int
    # fma: 256-wide column chunks of a head dim past 256 (grid x holds
    # splits * d_chunks blocks); 1 otherwise.
    d_chunks: int = 1


def _compiled_d(d: int) -> int:
    """The compiled head dim a call of head dim ``d`` runs at (the C
    source's ``compiled_d``): 256 past 256, in :func:`_d_chunks`
    chunks."""
    return next((c for c in _COMPILED_DIMS if c >= d), 256)


def _d_chunks(d: int) -> int:
    """256-wide column chunks of head dim ``d`` (``d_chunks``)."""
    return -(-d // 256)


def _decode_heads(group: int) -> int:
    """Query heads one decode block serves (``dec_heads``): the group,
    rounded up to 1, 2, 4 or 8; a larger group takes blocks of 8."""
    return 1 if group == 1 else 2 if group == 2 else 4 if group <= 4 else 8


def _geometry(entry: str, dtype, b: int, u: int, h: int, kvh: int,
              lk: int, d: int, sm_count: int, quant: bool = False
              ) -> Geometry:
    """The grid of one call (pure, so the CPU tests reach it). The body
    is the C source's dispatch: ``fma`` for any ``d`` past 256, else
    ``decode`` for a decode entry point, ``mma`` for an extend entry
    point with bf16 queries, ``u > 1`` and a compiled ``d`` up to 128,
    else ``fma``. Splits of the key tiles are
    chosen so that the blocks number about ``per_sm * sm_count``, never
    more splits than tiles, no empty split; for the mma body at most 16
    tiles in a split; for the decode body a power of two of at most 8 splits (one
    cluster) and no more blocks than fit the card at once.

    The decode body's tile is 1 KB of K: ``1024 / (D * itemsize)`` keys,
    ``D`` the compiled head dim and ``itemsize`` the cache's (4 f32, 2
    bf16, 1 int8; at D = 256 one f32 key a tile, its row in 32-byte lane
    chunks); a block serves :func:`_decode_heads` query heads of
    one KV head."""
    if d > 256:
        body = "fma"
    elif entry not in _EXTEND_ENTRIES:
        body = "decode"
    elif dtype == torch.bfloat16 and u > 1 and d in _MMA_DIMS:
        body = "mma"
    else:
        body = "fma"
    tile, chunk_rows, per_sm, most = _BODIES[body]
    rows = u * (h // kvh)
    if body == "decode":
        itemsize = 1 if quant else 4 if dtype == torch.float32 else 2
        tile = _DECODE_TILE_BYTES // (_compiled_d(d) * itemsize)
        chunk_rows = _decode_heads(h // kvh)
        per_sm = _DECODE_BLOCKS_PER_SM[chunk_rows]
    row_chunks = -(-rows // chunk_rows)
    n_tiles = -(-lk // tile)
    d_chunks = _d_chunks(d)
    blocks = b * kvh * row_chunks * d_chunks
    if body == "decode":
        fit = max(1, min(most, n_tiles, per_sm * sm_count // blocks))
        splits = 1 << (fit.bit_length() - 1)
    else:
        splits = min(n_tiles, max(1, -(-per_sm * sm_count // blocks)))
        if most is not None:
            splits = max(splits, -(-n_tiles // most))
    per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // per_split)
    one_pass = body == "decode" or (body == "mma" and splits == 1)
    partials = 0 if one_pass else b * splits * kvh * rows * (d + 2)
    return Geometry(body, tile, chunk_rows, row_chunks, splits, per_split,
                    partials, d_chunks)


def _launch(entry: str, q, kq, ks, vq, vs, mask3, scale, table=None):
    """Validate, then one C call: the body's kernel and, for a split-K
    body with several splits, its merge → ``([B, U, H, D]`` in
    ``q.dtype``, the body that ran)``. ``table`` selects the paged
    layout (``kq`` etc. are then pools)."""
    b, u, h, d = q.shape
    kvh = kq.shape[2]
    lk = kq.shape[1] if table is None else table.shape[1] * kq.shape[1]
    quant = ks is not None
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{entry}: unsupported dtype {q.dtype}")
    if not quant and kq.dtype != q.dtype:
        raise ValueError(
            f"{entry}: cache dtype {kq.dtype} differs from q {q.dtype}"
        )
    if quant and (kq.dtype != torch.int8 or ks.dtype != torch.float32):
        raise ValueError(f"{entry}: int8 cache needs int8 + f32 scales")
    for t in (q, kq, ks, vq, vs, mask3, table):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{entry}: every operand must be on the card")
    geo = _geometry(entry, q.dtype, b, u, h, kvh, lk, d,
                    _sm_count(q.device.index), quant)
    # The CUDA-core bodies read q by element; the mma body by 16-byte
    # rows.
    if q.stride(-1) != 1 or (geo.body == "mma" and (
            q.data_ptr() % 16 or any(s % 8 for s in q.stride()[:3]))):
        q = q.contiguous()
    if mask3.dtype != torch.bool:
        mask3 = mask3 != 0
    mask3 = mask3.contiguous()
    for t in (kq, ks, vq, vs, table):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{entry}: cache operands must be contiguous")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError(f"{entry}: K/V payloads must be 16-byte aligned")
    partials = torch.empty((geo.partial_floats,), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, u, h, d), dtype=q.dtype, device=q.device)
    if table is None:
        layout = [mask3.data_ptr()]
        dims = [lk]
    else:
        layout = [table.data_ptr(), mask3.data_ptr()]
        dims = [table.shape[1], kq.shape[1]]          # NP, page
    rc = _entries()[entry](
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        *layout, partials.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        _DTYPE_CODES[q.dtype], int(quant), b, u, h, kvh, *dims, d,
        geo.splits, geo.tiles_per_split, geo.row_chunks, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out, geo.body


def _count(fn, body: str) -> None:
    fn.launches += 1
    fn.bodies[body] += 1


def decode_attention(q, k, v, mask, *, scale=None):
    """Single-query flash-decode over a stored KV cache (B1): ``q [B, 1,
    H, D]``, ``mask [B, L]`` → ``[B, 1, H, D]``. CUDA tensors launch
    the kernel; CPU tensors run :func:`decode_attention_plain`."""
    if q.shape[1] != 1:
        raise ValueError(
            f"decode_attention takes one query per row (got q "
            f"{tuple(q.shape)}); multi-token spans go to extend_attention"
        )
    kq, ks, vq, vs = _operands(q, k, v, mask, True)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, scale=scale)
    out, body = _launch("mlapi_decode_attention", q, kq, ks, vq, vs,
                        mask[:, None, :], scale)
    _count(decode_attention, body)
    return out


def extend_attention(q, k, v, mask, *, scale=None):
    """U-token flash-extend over a stored KV cache (B2): ``q [B, U, H,
    D]``, ``mask [B, U, L]`` → ``[B, U, H, D]``. CUDA tensors launch
    the kernel; CPU tensors run :func:`extend_attention_plain`."""
    kq, ks, vq, vs = _operands(q, k, v, mask, False)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return extend_attention_plain(q, k, v, mask, scale=scale)
    out, body = _launch("mlapi_extend_attention", q, kq, ks, vq, vs, mask,
                        scale)
    _count(extend_attention, body)
    return out


def paged_decode_attention(q, k, v, table, mask, *, scale=None):
    """Page-table flash-decode (B3): ``q [B, 1, H, D]`` against pools
    ``[P, page, KVH, D]`` (or int8 pool pairs) through ``table int32[B,
    NP]``, ``mask [B, NP * page]`` over virtual slots → ``[B, 1, H,
    D]``. CUDA tensors launch the kernel; CPU tensors run
    :func:`paged_decode_attention_plain`."""
    if q.shape[1] != 1:
        raise ValueError(
            f"paged_decode_attention takes one query per row (got q "
            f"{tuple(q.shape)}); multi-token spans go to "
            "paged_extend_attention"
        )
    kq, ks, vq, vs = _operands(q, k, v, mask, True, table)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k, v, table, mask,
                                            scale=scale)
    out, body = _launch("mlapi_paged_decode_attention", q, kq, ks, vq, vs,
                        mask[:, None, :], scale, table)
    _count(paged_decode_attention, body)
    return out


def paged_extend_attention(q, k, v, table, mask, *, scale=None):
    """Page-table flash-extend (B4): ``q [B, U, H, D]`` against pools
    through ``table int32[B, NP]``, ``mask [B, U, NP * page]`` → ``[B,
    U, H, D]``. A span may start mid-page and cross pages; the mask
    carries that. CUDA tensors launch the kernel; CPU tensors run
    :func:`paged_extend_attention_plain`."""
    kq, ks, vq, vs = _operands(q, k, v, mask, False, table)
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return paged_extend_attention_plain(q, k, v, table, mask,
                                            scale=scale)
    out, body = _launch("mlapi_paged_extend_attention", q, kq, ks, vq, vs,
                        mask, scale, table)
    _count(paged_extend_attention, body)
    return out


for _fn in (decode_attention, extend_attention, paged_decode_attention,
            paged_extend_attention):
    _fn.launches = 0
    _fn.bodies = {"mma": 0, "fma": 0, "decode": 0}
del _fn
