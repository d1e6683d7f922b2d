"""The grid of the flash-attention kernels (B5-B7), on the CPU.

The wrapper's ``_body`` mirrors which body of ``csrc/flash_attention.cu``
a call runs (on the card the C source decides and reports it), and ``key_tiles`` / ``query_tiles`` below mirror which
tiles a block of the C source walks; the kernels cannot run here, so
these tests hold the dispatch to the rule
(tensor cores for B5, B6 and B7 in bf16 up to head dim 128, CUDA cores
for f32 and head dims from 256 on, a head dim past 256 zero-padded to a
multiple of 256 and run in 256-wide column chunks whose grid stays
within its limits) and the tile ranges to a brute-force
keep-mask: every attendable (query, key) pair is walked by the block that
owns it, and every tile a block walks holds one (so a causal or windowed
call skips nothing it needs and walks nothing it could skip). Grouped-
query attention changes no range (a group's heads share the key mask and
the positions); the card tests run group 4. The tile constants and the
dispatch are read back from the C source. Pure Python; nothing is
compiled.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

flash = importlib.import_module("mlapi_tpu_torch.ops.cuda.flash_attention")

ENTRIES = ("mlapi_flash_forward", "mlapi_flash_backward_dq",
           "mlapi_flash_backward_dkv")
SRC = (Path(flash.__file__).resolve().parents[2] / "csrc"
       / "flash_attention.cu").read_text()
# Per (entry point, body): the rows a block owns on its own axis and the
# tile of the axis it walks -- (query rows, keys per tile) for B5 and B6,
# (keys, queries per tile) for B7, whose tensor-core query tile depends on
# the head dim (``dkv_q_rows``: 64 up to D = 64, 32 at 128).
TILES = {
    ("mlapi_flash_forward", "mma"): (64, 64),
    ("mlapi_flash_forward", "fma"): (64, 32),
    ("mlapi_flash_backward_dq", "mma"): (64, 64),
    ("mlapi_flash_backward_dq", "fma"): (32, 32),
    ("mlapi_flash_backward_dkv", "mma"): (64, None),
    ("mlapi_flash_backward_dkv", "fma"): (32, 32),
}


def dkv_q_rows(dc):
    return 64 if dc <= 64 else 32


def tiles(entry, body, dc):
    rows, tile = TILES[(entry, body)]
    return rows, (dkv_q_rows(dc) if tile is None else tile)


def key_tiles(q0, nq, bk, lk, causal, window):
    """Key tiles of width ``bk`` that queries ``[q0, q0 + nq)`` can see
    (the C source's ``key_tiles``)."""
    k_lo, k_hi = 0, lk
    if causal:
        k_hi = min(lk, q0 + nq)
        if window:
            k_lo = max(0, q0 - window + 1)
    lo = k_lo // bk
    return range(lo, max(lo, -(-k_hi // bk)))


def query_tiles(k0, nk, bq, lq, causal, window):
    """Query tiles of width ``bq`` that can see keys ``[k0, k0 + nk)``
    (the C source's ``query_tiles``)."""
    q_lo, q_hi = 0, lq
    if causal:
        q_lo = min(k0, lq)
        if window:
            q_hi = min(lq, k0 + nk - 1 + window)
    lo = q_lo // bq
    return range(lo, max(lo, -(-q_hi // bq)))


def test_body_dispatch():
    """bf16 B5, B6 and B7 at a head dim up to 128 (padded to 16, 32, 64
    or 128) run the tensor-core body; f32 and head dims past 128 (padded
    to 256, or past 256 to a multiple of 256) the CUDA-core body."""
    for entry in ENTRIES:
        for d in range(1, 1025):
            dc = flash._compiled_d(entry, d)
            if d <= 256:
                assert dc == min(c for c in (16, 32, 64, 128, 256) if c >= d)
            else:
                assert dc % 256 == 0 and dc - 256 < d <= dc
            for dtype in (torch.bfloat16, torch.float32):
                mma = dtype == torch.bfloat16 and d <= 128
                assert flash._body(dtype, dc) == (
                    "mma" if mma else "fma"), (entry, d, dtype)
    with pytest.raises(ValueError, match="head_dim 0 must be at least 1"):
        flash._compiled_d("mlapi_flash_forward", 0)


@pytest.mark.parametrize("d", [257, 288, 320, 512, 513, 4096])
def test_head_dims_past_256_run_in_chunks_within_the_grid(d):
    """A head dim past 256 runs the CUDA-core bodies at 256 in nd = dc / 256
    column chunks: grid x is the tile count times nd (B5: 64-row tiles,
    B6: 32-row, B7: 32-key), and stays within 2^31 - 1 at any length the
    launcher takes, while y (heads) and z (batch) keep their 65535."""
    dc = flash._compiled_d("mlapi_flash_forward", d)
    nd = dc // 256
    assert nd == -(-d // 256)
    for entry in ENTRIES:
        body = flash._body(torch.bfloat16, dc)
        assert body == "fma"
        rows, _ = tiles(entry, body, 256)
        for length in (1, 128, 1000, 65536):
            assert -(-length // rows) * nd < 2**31
    assert ("(static_cast<long long>(Lq) + 31) / 32 * nd > 0x7fffffff"
            in SRC)
    assert "dim3((p.Lq + 63) / 64 * p.nd, p.H, p.B)" in SRC
    assert "dim3((p.Lq + 31) / 32 * p.nd, p.H, p.B)" in SRC
    assert "dim3((p.Lk + 31) / 32 * p.nd, p.KVH," in SRC


def _keep(lq, lk, causal, window):
    mask = torch.ones(1, lk)
    keep = flash._keep(mask, causal, window, lq, lk)[0, 0] > 0
    return keep.expand(lq, lk)


CASES = [  # lq, lk, causal, window
    (128, 128, False, None),     # sst2-bert
    (130, 130, True, None),      # ragged causal
    (1000, 1000, True, None),
    (100, 100, True, 48),        # sliding window
    (257, 257, True, 1),         # the diagonal alone
    (256, 256, True, 64),
    (300, 300, True, 1000),      # a window past L
    (50, 130, False, None),      # Lq != Lk
    (1, 1, True, None),
]


def _bodies(entry):
    return ("mma", "fma")


@pytest.mark.parametrize("lq,lk,causal,window", CASES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_tiles_cover_exactly_the_attendable_pairs(entry, lq, lk, causal,
                                                  window):
    keep = _keep(lq, lk, causal, window)
    for body in _bodies(entry):
        for dc in (64, 128):
            rows, tile = tiles(entry, body, dc)
            if entry == "mlapi_flash_backward_dkv":
                # A block owns `rows` keys and walks query tiles.
                own, walk = keep.T, keep
                n_own, ranges = lk, lambda r0: query_tiles(
                    r0, rows, tile, lq, causal, window)
            else:
                # A block owns `rows` query rows and walks key tiles.
                own, walk = keep, keep.T
                n_own, ranges = lq, lambda r0: key_tiles(
                    r0, rows, tile, lk, causal, window)
            n_walk = walk.shape[0]
            for r0 in range(0, n_own, rows):
                block = own[r0:r0 + rows]            # [owned, walked]
                walked = torch.zeros(n_walk, dtype=torch.bool)
                for t in ranges(r0):
                    seg = slice(t * tile, min(n_walk, (t + 1) * tile))
                    assert 0 <= t * tile < n_walk
                    # Tight: the tile holds a pair the block needs.
                    assert block[:, seg].any(), (body, dc, r0, t)
                    walked[seg] = True
                # Covering: every pair of the block lies in a walked tile.
                need = block.any(dim=0)
                assert not (need & ~walked).any(), (body, dc, r0)


def test_tile_constants_and_dispatch_match_the_cuda_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             SRC).group(1))

    assert TILES[("mlapi_flash_forward", "mma")] == (
        const("kFwdRows"), const("kFwdKeys"))
    assert TILES[("mlapi_flash_backward_dq", "mma")] == (
        const("kDqRows"), const("kDqKeys"))
    assert TILES[("mlapi_flash_backward_dkv", "mma")][0] == const(
        "kDkvKeys")
    assert ("constexpr int dkv_q_rows(int d) { return d <= 64 ? 64 : 32; }"
            in SRC)
    # The CUDA-core bodies' tiles.
    assert "constexpr int BQ = 64, BK = 32, R = BQ / 16" in SRC
    assert "constexpr int BQ = 32, BK = 32, R = BQ / 16" in SRC
    assert "constexpr int BK = 32, BQ = 32, R = BK / 16" in SRC
    assert TILES[("mlapi_flash_forward", "fma")] == (64, 32)
    assert TILES[("mlapi_flash_backward_dq", "fma")] == (32, 32)
    assert TILES[("mlapi_flash_backward_dkv", "fma")] == (32, 32)
    # The dispatch and the tile walks that key_tiles / query_tiles mirror.
    assert "return dtype == 1 && D <= 128 ? kBodyMma : kBodyFma;" in SRC
    assert "if (p.window > 0) k_lo = max(0, q0 - p.window + 1);" in SRC
    assert "k_hi = min(p.Lk, q0 + nq);" in SRC
    assert "q_lo = min(k0, p.Lq);" in SRC
    assert ("if (p.window > 0) q_hi = min(p.Lq, k0 + nk - 1 + p.window);"
            in SRC)
    assert flash._BODY_NAMES == ("fma", "mma")
    assert "enum Body { kBodyFma = 0, kBodyMma = 1 };" in SRC
    assert flash._COMPILED_DIMS == (16, 32, 64, 128, 256)
    assert "D != 128 && D % 256 != 0" in SRC
