"""The grid of the flash-decode / flash-extend kernels (B1-B4), on the CPU.

``_geometry`` decides which body of ``csrc/decode_attention.cu`` a call
runs and how the call is cut into blocks; the kernels cannot run here, so
these tests hold the cut to what the kernels index: every query row and
every key tile covered exactly once, no empty split, partials exactly as
large as the kernel writes, the decode body's splits one cluster of at
most 8 blocks, every head dim up to 256 on the next compiled one, and
every head dim past 256 on the CUDA-core split-K body at 256 in 256-wide
column chunks, its grid within the card's limits.
Pure Python; nothing is compiled.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

geo_mod = importlib.import_module("mlapi_tpu_torch.ops.cuda.decode_attention")
_geometry = geo_mod._geometry

EXTEND = ("mlapi_extend_attention", "mlapi_paged_extend_attention")
DECODE = ("mlapi_decode_attention", "mlapi_paged_decode_attention")
SHAPES = [  # b, u, h, kvh, lk
    (8, 128, 12, 12, 1024),     # the full-window chunk
    (1, 128, 12, 12, 416),      # the serving run's chunk
    (8, 128, 12, 12, 928),      # the prefill-heavy leg's chunks
    (4, 128, 16, 4, 1024),      # GQA
    (2, 100, 12, 12, 1000),     # ragged
    (3, 17, 16, 4, 70),
    (2, 2, 12, 12, 64),
    (1, 5, 8, 2, 4096),         # more tiles than one split holds
    (8, 1, 12, 12, 1024),       # decode
    (1, 1, 8, 2, 100),
]


def _cases():
    for entry in EXTEND + DECODE:
        for dtype in (torch.bfloat16, torch.float32):
            for b, u, h, kvh, lk in SHAPES:
                if entry in DECODE and u != 1:
                    continue
                for sm in (132, 16):
                    yield entry, dtype, b, u, h, kvh, lk, sm


@pytest.mark.parametrize("entry,dtype,b,u,h,kvh,lk,sm", list(_cases()))
def test_every_row_and_tile_is_covered_exactly_once(entry, dtype, b, u, h,
                                                    kvh, lk, sm):
    g = _geometry(entry, dtype, b, u, h, kvh, lk, 64, sm)
    rows = u * (h // kvh)
    n_tiles = -(-lk // g.tile_keys)
    row_hits = [0] * rows
    for chunk in range(g.row_chunks):
        block = range(chunk * g.rows_per_block,
                      min(rows, (chunk + 1) * g.rows_per_block))
        assert len(block) > 0
        for r in block:
            row_hits[r] += 1
    tile_hits = [0] * n_tiles
    for split in range(g.splits):
        tiles = range(split * g.tiles_per_split,
                      min(n_tiles, (split + 1) * g.tiles_per_split))
        assert len(tiles) > 0                 # no empty split
        for t in tiles:
            tile_hits[t] += 1
    assert row_hits == [1] * rows
    assert tile_hits == [1] * n_tiles
    assert 1 <= g.splits <= n_tiles
    if g.body == "mma":
        assert g.tiles_per_split <= 16        # the mask words a block holds


@pytest.mark.parametrize("entry,dtype,b,u,h,kvh,lk,sm", list(_cases()))
def test_partials_are_exactly_what_the_kernel_writes(entry, dtype, b, u, h,
                                                     kvh, lk, sm):
    """Every (batch row, split, head, row) writes acc[D], m and l at the
    offsets the kernel computes -- acc at ((b*S + s)*KVH*rows + j*rows +
    r)*D + d, then m and l after all acc -- so the scratch must hold
    exactly that, each float written once; the mma body with one split
    writes the output itself and needs none. (A head dim of 8 keeps the
    index arrays small; the layout does not depend on it.)"""
    d = 8
    g = _geometry(entry, dtype, b, u, h, kvh, lk, d, sm)
    rows = u * (h // kvh)
    if g.body == "decode" or (g.body == "mma" and g.splits == 1):
        # One pass: the decode body's splits meet in their cluster, a
        # one-split mma block writes the output itself.
        assert g.partial_floats == 0
        return
    n_rows = b * g.splits * kvh * rows
    bi, s, j, r = torch.meshgrid(torch.arange(b), torch.arange(g.splits),
                                 torch.arange(kvh), torch.arange(rows),
                                 indexing="ij")
    row = ((bi * g.splits + s) * kvh * rows + j * rows + r).flatten()
    acc = (row[:, None] * d + torch.arange(d)[None]).flatten()
    every = torch.cat([acc, n_rows * d + row, n_rows * d + n_rows + row])
    written = torch.bincount(every, minlength=g.partial_floats)
    assert bool((written == 1).all())


@pytest.mark.parametrize("entry", EXTEND)
def test_bf16_extend_takes_the_tensor_core_body(entry):
    for b, u, h, kvh, lk in SHAPES:
        body = _geometry(entry, torch.bfloat16, b, u, h, kvh, lk, 64,
                         132).body
        assert body == ("mma" if u > 1 else "fma")
        assert _geometry(entry, torch.float32, b, u, h, kvh, lk, 64,
                         132).body == "fma"


@pytest.mark.parametrize("entry", DECODE)
def test_decode_keeps_the_fma_body(entry):
    """Every decode call up to head dim 256 runs the decode body (a
    CUDA-core memory pipeline), whatever the dtype and format."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in (12, 64, 128):
            for quant in (False, True):
                assert _geometry(entry, dtype, 8, 1, 12, 12, 1024, d, 132,
                                 quant).body == "decode"


def test_main_path_shapes():
    """The serving chunk spreads over the card (one or two tiles per
    split); the full window runs as one split, without the merge."""
    small = _geometry(EXTEND[0], torch.bfloat16, 1, 128, 12, 12, 416, 64, 132)
    assert small.tiles_per_split <= 2 and small.splits > 1
    full = _geometry(EXTEND[0], torch.bfloat16, 8, 128, 12, 12, 1024, 64, 132)
    assert (full.splits, full.rows_per_block, full.tile_keys) == (1, 64, 64)
    assert full.partial_floats == 0


def test_python_geometry_matches_the_cuda_source():
    """The tile and row-block sizes the wrapper assumes are the ones the
    kernels are compiled with."""
    src = (Path(geo_mod.__file__).resolve().parents[2] / "csrc"
           / "decode_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    tile, rows, _, most = geo_mod._BODIES["mma"]
    assert (tile, rows, most) == (const("kMmaKeys"), const("kMmaRows"),
                                  const("kMaxSplitTiles"))
    tile, rows, _, _ = geo_mod._BODIES["fma"]
    assert (tile, rows) == (const("kTileKeys"), const("kRowChunk"))
    _, _, _, most = geo_mod._BODIES["decode"]
    assert most == const("kMaxCluster")
    assert geo_mod._DECODE_TILE_BYTES == const("kDecTileBytes")
    # The dispatch, head-dim rounding and decode geometry _geometry mirrors.
    assert ("return extend && dtype == 1 && U > 1 && compiled_d(D) == D "
            "&& D <= 128;") in src
    assert "if (!extend) return kBodyDecode;" in src
    assert re.search(
        r"return d <= 16\s+\? 16\s+: d <= 32\s+\? 32\s+: d <= 64\s+\? 64"
        r"\s+: d <= 128 \? 128\s+: 256;", src)
    assert "constexpr int d_chunks(int d) { return (d + 255) / 256; }" in src
    assert "if (D > 256) return kBodyFma;" in src
    assert "dim3 grid(p.S * p.nd, p.KVH * p.row_chunks, p.B);" in src
    assert "return f32_cache && d_c <= 128 ? 4 : 8;" in src
    assert "return kDecTileBytes / (d_c * itemsize);" in src
    assert "dec_tile_keys(compiled_d(D), quant ? 1 : dtype == 0 ? 4 : 2)" in src
    assert ("return group == 1 ? 1 : group == 2 ? 2 : group <= 4 ? 4 : 8;"
            in src)


DECODE_SHAPES = [  # b, h, kvh, lk
    (8, 12, 12, 1024),          # GPT-2 small, full window
    (8, 12, 12, 48),            # the short tier
    (1, 12, 12, 416),           # one stream, long prompt
    (4, 16, 4, 1024),           # GQA 4
    (8, 32, 8, 1024),           # Llama-class
    (3, 12, 2, 1000),           # group 6
    (2, 40, 2, 100),            # group 20: head chunks of 8
    (1, 4, 1, 1),               # one key
    (64, 12, 12, 4096),         # more blocks than fit the card at once
]


def _decode_cases():
    for entry in DECODE:
        for b, h, kvh, lk in DECODE_SHAPES:
            for d in (12, 16, 32, 64, 100, 128, 160, 256):
                for dtype, quant in ((torch.bfloat16, False),
                                     (torch.float32, False),
                                     (torch.bfloat16, True)):
                    yield entry, dtype, quant, b, h, kvh, lk, d


@pytest.mark.parametrize("entry,dtype,quant,b,h,kvh,lk,d",
                         list(_decode_cases()))
def test_decode_cluster_covers_every_tile_and_head_once(entry, dtype, quant,
                                                        b, h, kvh, lk, d):
    """The decode body: the splits of one (b, KV head, head chunk) are one
    cluster -- at most 8 blocks, the whole of grid x, so the cluster
    divides the grid -- and cover every key tile exactly once; the
    block's warps take every fourth tile of their split, each exactly
    once; the head chunks cover the group exactly once. Splits are a power
    of two but where fewer tiles force fewer."""
    sm = 132
    g = _geometry(entry, dtype, b, 1, h, kvh, lk, d, sm, quant)
    assert g.body == "decode" and g.partial_floats == 0
    group = h // kvh
    itemsize = 1 if quant else 4 if dtype == torch.float32 else 2
    dc = geo_mod._compiled_d(d)
    assert g.tile_keys == 1024 // (dc * itemsize)
    assert 1 <= g.splits <= 8
    grid = (g.splits, kvh * g.row_chunks, b)
    assert grid[0] % g.splits == 0           # the cluster divides the grid
    blocks = grid[0] * grid[1] * grid[2]
    per_sm = geo_mod._DECODE_BLOCKS_PER_SM[g.rows_per_block]
    assert g.splits == 1 or blocks <= per_sm * sm   # one wave
    n_tiles = -(-lk // g.tile_keys)
    hits = [0] * n_tiles
    for split in range(g.splits):
        tiles = range(split * g.tiles_per_split,
                      min(n_tiles, (split + 1) * g.tiles_per_split))
        assert len(tiles) > 0                # no empty split
        for warp in range(4):
            for t in tiles[warp::4]:
                hits[t] += 1
    assert hits == [1] * n_tiles
    if g.splits & (g.splits - 1):
        assert g.splits < 8 and g.tiles_per_split * (g.splits + 1) > n_tiles
    heads = [0] * group
    for chunk in range(g.row_chunks):
        served = range(chunk * g.rows_per_block,
                       min(group, (chunk + 1) * g.rows_per_block))
        assert 0 < len(served) <= 8
        for hh in served:
            heads[hh] += 1
    assert heads == [1] * group
    assert g.rows_per_block == min(8, 1 << (group - 1).bit_length())


def test_every_head_dim_maps_to_the_next_compiled_one():
    """1 <= D <= 256 run: the CUDA-core bodies at the next of 16, 32, 64,
    128, 256; the tensor-core body only at the first four. Past 256 every
    entry point runs the CUDA-core split-K body at 256 in ceil(D / 256)
    column chunks."""
    for d in range(1, 1025):
        dc = geo_mod._compiled_d(d)
        assert dc == min([c for c in (16, 32, 64, 128, 256) if c >= d]
                         + [256])
        assert geo_mod._d_chunks(d) == -(-d // 256)
        body = _geometry(EXTEND[0], torch.bfloat16, 2, 40, 8, 2, 456, d,
                         132).body
        assert body == ("mma" if d == dc and d <= 128 else "fma")
        if d > 256:
            for entry in DECODE:
                assert _geometry(entry, torch.bfloat16, 2, 1, 8, 2, 456, d,
                                 132).body == "fma"


WIDE_SHAPES = [  # entry, b, u, h, kvh, lk
    ("mlapi_decode_attention", 8, 1, 12, 12, 1024),
    ("mlapi_paged_decode_attention", 2, 1, 8, 4, 512),
    ("mlapi_extend_attention", 2, 64, 8, 4, 512),
    ("mlapi_paged_extend_attention", 1, 128, 12, 12, 416),
    ("mlapi_decode_attention", 1, 1, 4, 1, 1),
]


@pytest.mark.parametrize("d", [257, 320, 512, 1000])
@pytest.mark.parametrize("entry,b,u,h,kvh,lk", WIDE_SHAPES)
def test_head_dims_past_256_cut_into_column_chunks(entry, b, u, h, kvh, lk,
                                                   d):
    """A head dim past 256: the CUDA-core split-K body, every row and key
    tile covered exactly once per column chunk, grid x = splits * chunks
    (within 2^31 - 1), y = KVH * row chunks (within 65535), partials of
    the full d (acc [n, d], then m, l)."""
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True)):
        g = _geometry(entry, dtype, b, u, h, kvh, lk, d, 132, quant)
        assert g.body == "fma" and g.d_chunks == -(-d // 256)
        assert (g.tile_keys, g.rows_per_block) == (32, 32)
        rows = u * (h // kvh)
        assert g.row_chunks == -(-rows // 32)
        n_tiles = -(-lk // 32)
        assert 1 <= g.splits <= n_tiles
        assert (g.splits - 1) * g.tiles_per_split < n_tiles
        assert g.splits * g.tiles_per_split >= n_tiles
        grid = (g.splits * g.d_chunks, kvh * g.row_chunks, b)
        assert grid[0] < 2**31 and grid[1] <= 65535 and grid[2] <= 65535
        assert g.partial_floats == b * g.splits * kvh * rows * (d + 2)
