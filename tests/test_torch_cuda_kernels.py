"""The port's CUDA kernels on a card: each against its plain version,
and each paged kernel against its contiguous twin on the same bytes.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels build
from ``mlapi_tpu_torch/csrc`` at first use) and skips without one. The
file imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py -q

Tolerances: max abs error <= 2e-2 on rows with a valid key in bf16
(rounding of p before the PV product differs in place between the
kernel's online softmax and the plain version's per-tile one), 1e-5 in
f32.
"""

import numpy as np
import pytest
import torch

from mlapi_tpu_torch.ops import cuda as kern
from mlapi_tpu_torch.ops.quant import kv_quantize

pytestmark = pytest.mark.requires_cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(card, b, u, h, kvh, length, d, dtype, fmt, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(card)

    q = t(b, u, h, d).to(dtype)
    k, v = t(b, length, kvh, d).to(dtype), t(b, length, kvh, d).to(dtype)
    if fmt == "int8":
        k = dict(zip(("q", "scale"), kv_quantize(k)))
        v = dict(zip(("q", "scale"), kv_quantize(v)))
    idx = torch.arange(length, device=card)
    last = torch.as_tensor(rng.integers(length // 2, length, b), device=card)
    pads = torch.as_tensor(rng.integers(0, length // 4, b), device=card)
    qpos = last[:, None] - u + 1 + torch.arange(u, device=card)[None]
    mask = (idx[None, None] <= qpos[:, :, None]) & (
        idx[None, None] >= pads[:, None, None]
    )
    if u > 1 and b > 1:
        mask[0] = False                 # a batch row with no valid key
    return q, k, v, (mask[:, 0] if u == 1 else mask)


def _check(fn, plain, q, k, v, mask, dtype):
    n0 = fn.launches
    got = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    want = plain(q, k, v, mask)
    live = mask.reshape(q.shape[0], -1, mask.shape[-1]).any(-1)
    err = (got.float() - want.float()).abs()[live].max().item()
    assert torch.isfinite(got).all() and err <= TOL[dtype], err
    assert not got[~live].any()         # rows with no valid key are zero


@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,u,h,kvh,length,d",
    [(8, 1, 12, 12, 1024, 64),      # GPT-2 small, full window
     (1, 1, 12, 12, 416, 64),       # B = 1 decode: one tile per split
     (3, 1, 8, 2, 100, 64),         # GQA, ragged length
     (1, 128, 12, 12, 416, 64),     # a chunked-prefill chunk
     (2, 5, 8, 2, 70, 64)],         # GQA span, several row chunks
)
def test_kernel_matches_plain(card, b, u, h, kvh, length, d, dtype, fmt):
    args = _case(card, b, u, h, kvh, length, d, dtype, fmt, seed=length)
    if u == 1:
        _check(kern.decode_attention, kern.decode_attention_plain, *args,
               dtype)
    else:
        _check(kern.extend_attention, kern.extend_attention_plain, *args,
               dtype)


def _paged(card, k, page, mask, seed):
    """The cache ``k`` ([B, L, KVH, D] tensor or int8 pair) scattered
    into a pool behind a shuffled page table. Tiles no query of the row
    attends map to the null page 0, which holds finite garbage."""
    rng = np.random.default_rng(seed)
    leaves = k if isinstance(k, dict) else {"t": k}
    some = next(iter(leaves.values()))
    b, length = some.shape[:2]
    n_tiles = length // page
    n_pages = b * n_tiles + 2
    ids = rng.permutation(n_pages - 1) + 1
    keep = mask.reshape(b, -1, length).any(1).reshape(b, n_tiles, page)
    table = torch.zeros((b, n_tiles), dtype=torch.int32)
    for bi in range(b):
        for t in range(n_tiles):
            if keep[bi, t].any():
                table[bi, t] = int(ids[bi * n_tiles + t])
    table = table.to(card)
    pools = {}
    for name, leaf in leaves.items():
        pool = torch.as_tensor(
            rng.standard_normal((n_pages, page) + tuple(leaf.shape[2:]))
        ).to(card, leaf.dtype)
        if leaf.dtype == torch.float32 and name == "scale":
            pool = pool.abs()
        tiles = leaf.reshape((b, n_tiles, page) + tuple(leaf.shape[2:]))
        live = table != 0
        pool[table[live].long()] = tiles[live]
        pools[name] = pool
    return (pools if isinstance(k, dict) else pools["t"]), table


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize(
    "b,u,h,kvh,length",
    [(4, 1, 12, 12, 256),           # decode, GPT-2 small heads
     (1, 1, 8, 2, 192),             # GQA decode, B = 1
     (2, 7, 12, 12, 192),           # a span that starts mid-page
     (1, 128, 12, 12, 256)],        # a chunked-prefill chunk
)
def test_paged_kernel_matches_plain_and_contiguous(card, b, u, h, kvh,
                                                   length, fmt, page):
    """B3/B4 against their plain versions (tolerance) and against B1/B2
    over the same bytes in a contiguous cache (bit for bit)."""
    dtype = torch.bfloat16
    q, k, v, mask = _case(card, b, u, h, kvh, length, 64, dtype, fmt,
                          seed=length + page)
    pk, table = _paged(card, k, page, mask, seed=1)
    pv, _ = _paged(card, v, page, mask, seed=1)
    if u == 1:
        paged, contiguous = kern.paged_decode_attention, kern.decode_attention
        plain = kern.paged_decode_attention_plain
    else:
        paged, contiguous = kern.paged_extend_attention, kern.extend_attention
        plain = kern.paged_extend_attention_plain
    n0, c0 = paged.launches, contiguous.launches
    got = paged(q, pk, pv, table, mask)
    torch.cuda.synchronize()
    assert paged.launches == n0 + 1 and contiguous.launches == c0
    want = plain(q, pk, pv, table, mask)
    live = mask.reshape(b, -1, length).any(-1)
    err = (got.float() - want.float()).abs()[live].max().item()
    assert torch.isfinite(got).all() and err <= TOL[dtype], err
    assert not got[~live].any()
    same = contiguous(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, same)


def test_paged_kernel_checks_its_table(card):
    q, k, v, mask = _case(card, 2, 1, 12, 12, 64, 64, torch.bfloat16,
                          "none", seed=3)
    pk, table = _paged(card, k, 16, mask, seed=2)
    n0 = kern.paged_decode_attention.launches
    with pytest.raises(ValueError, match="int32"):
        kern.paged_decode_attention(q, pk, pk, table.long(), mask)
    with pytest.raises(ValueError, match="virtual"):
        kern.paged_decode_attention(q, pk, pk, table, mask[:, :48])
    assert kern.paged_decode_attention.launches == n0


def test_strided_query_from_the_fused_projection(card):
    """The model hands the kernel q as a view of the fused qkv
    projection (non-contiguous heads): same answer as a contiguous q."""
    q, k, v, mask = _case(card, 4, 1, 12, 12, 256, 64, torch.bfloat16,
                          "none", seed=1)
    qkv = torch.cat([q, q, q], dim=2)            # [B, 1, 3H, D]
    view = qkv[:, :, :12]
    assert not view.is_contiguous()
    torch.testing.assert_close(
        kern.decode_attention(view, k, v, mask),
        kern.decode_attention(q.contiguous(), k, v, mask), rtol=0, atol=0,
    )


def test_unsupported_head_dim_raises_not_falls_back(card):
    q, k, v, mask = _case(card, 2, 1, 4, 4, 64, 128, torch.bfloat16,
                          "none", seed=2)
    n0 = kern.decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        kern.decode_attention(q, k, v, mask)
    assert kern.decode_attention.launches == n0


def test_model_streams_equal_through_kernels_and_einsum(card):
    """float32 end to end: greedy generation through the kernels equals
    the einsum oracle's, both cache formats, pads included."""
    from mlapi_tpu_torch.models.gpt import GptLM

    model = GptLM(vocab_size=260, hidden_size=128, num_layers=2, num_heads=2,
                  max_positions=256, compute_dtype="float32", seed=1,
                  device=card)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 2:
                p.mul_(10.0)
    ids = torch.as_tensor(np.random.default_rng(3).integers(4, 260, (3, 40)),
                          device=card)
    for kv_quant in ("none", "int8"):
        streams = []
        for impl in ("einsum", "flash"):
            model.configure(kv_quant=kv_quant, decode_attn_impl=impl)
            with torch.inference_mode():
                streams.append(model.generate(
                    ids, max_new_tokens=24, pad_lens=[0, 5, 17]
                ).tolist())
        assert streams[0] == streams[1], kv_quant
