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
    """D = 288 is taken on the card: one launch of the CUDA-core split-K
    body (two 256-wide column chunks), within tolerance of the plain
    version; nothing falls back."""
    q, k, v, mask = _case(card, 2, 1, 4, 4, 64, 288, torch.bfloat16,
                          "none", seed=2)
    _check_body(kern.decode_attention, "fma", (q, k, v, mask),
                kern.decode_attention_plain, torch.bfloat16)


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


# -- flash-extend on the tensor cores (B2/B4, bf16 and int8) ---------------

def _span_case(card, b, u, h, kvh, length, slot, dtype, fmt, seed):
    """A U-token span whose first token sits at ``slot`` of every row,
    ragged left pads up to the slot, causal inside the span; batch row 0
    has no valid key when ``b > 1``."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(card, dtype)

    q = t(b, u, h, 64)
    k, v = t(b, length, kvh, 64), t(b, length, kvh, 64)
    if fmt == "int8":
        k = dict(zip(("q", "scale"), kv_quantize(k)))
        v = dict(zip(("q", "scale"), kv_quantize(v)))
    idx = torch.arange(length, device=card)
    pads = torch.as_tensor(rng.integers(0, slot + 1, b), device=card)
    qpos = slot + torch.arange(u, device=card)
    mask = (idx[None, None] <= qpos[None, :, None]) & (
        idx[None, None] >= pads[:, None, None])
    if b > 1:
        mask[0] = False
    return q, k, v, mask


def _check_body(fn, body, got_args, plain, dtype):
    """One launch of ``fn`` on ``body``, within tolerance of ``plain``
    on live rows, exact zeros on dead rows; returns the output."""
    q, mask = got_args[0], got_args[-1]
    n0, b0 = fn.launches, dict(fn.bodies)
    got = fn(*got_args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert fn.bodies[body] == b0[body] + 1, fn.bodies
    want = plain(*got_args)
    live = mask.reshape(q.shape[0], -1, mask.shape[-1]).any(-1)
    err = (got.float() - want.float()).abs()[live].max().item()
    assert torch.isfinite(got).all() and err <= TOL[dtype], err
    assert not got[~live].any()
    return got


@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize(
    "b,u,h,kvh,length,slot",
    [(2, 2, 12, 12, 70, 30),        # U = 2, L not a multiple of 64
     (2, 17, 16, 4, 1000, 500),     # group 4, U = 17
     (3, 64, 8, 2, 1000, 0),        # span at slot 0, group 4
     (2, 128, 12, 12, 1000, 850),   # the ragged chip_smoke row
     (4, 128, 16, 4, 1024, 768)],   # GQA at the full window
)
def test_extend_mma_matches_plain(card, b, u, h, kvh, length, slot, fmt):
    args = _span_case(card, b, u, h, kvh, length, slot, torch.bfloat16, fmt,
                      seed=u + length)
    _check_body(kern.extend_attention, "mma", args,
                kern.extend_attention_plain, torch.bfloat16)


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize(
    "b,u,h,kvh,length,slot",
    [(2, 17, 16, 4, 256, 100),      # group 4, a span mid-page
     (1, 128, 12, 12, 448, 200),    # a chunked-prefill chunk
     (3, 64, 12, 12, 192, 0)],      # slot 0, a row with no valid key
)
def test_paged_extend_mma_equals_contiguous(card, b, u, h, kvh, length, slot,
                                            fmt, page):
    """B4's tensor-core body against its plain version, and bit for bit
    against B2 over the same bytes."""
    q, k, v, mask = _span_case(card, b, u, h, kvh, length, slot,
                               torch.bfloat16, fmt, seed=length + page)
    pk, table = _paged(card, k, page, mask, seed=1)
    pv, _ = _paged(card, v, page, mask, seed=1)
    got = _check_body(kern.paged_extend_attention, "mma",
                      (q, pk, pv, table, mask),
                      kern.paged_extend_attention_plain, torch.bfloat16)
    same = kern.extend_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, same)


def test_extend_mma_reads_a_strided_query(card):
    """q as a view of the fused QKV projection (heads strided by 3H*D
    per span position): the same bits as a contiguous q."""
    q, k, v, mask = _span_case(card, 2, 128, 12, 12, 416, 256,
                               torch.bfloat16, "none", seed=9)
    view = torch.cat([q, q, q], dim=2)[:, :, :12]
    assert not view.is_contiguous()
    n0 = kern.extend_attention.bodies["mma"]
    got = kern.extend_attention(view, k, v, mask)
    want = kern.extend_attention(q.contiguous(), k, v, mask)
    assert kern.extend_attention.bodies["mma"] == n0 + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize("dtype,u", [(torch.float32, 17),
                                     (torch.bfloat16, 1)])
def test_extend_f32_and_single_token_run_the_fma_body(card, dtype, u, fmt):
    """f32 queries (the 1e-5 witness) and a one-token span keep the
    CUDA-core body, contiguous and paged."""
    q, k, v, mask = _span_case(card, 2, u, 8, 2, 200, 60, dtype, fmt,
                               seed=u)
    _check_body(kern.extend_attention, "fma", (q, k, v, mask),
                kern.extend_attention_plain, dtype)
    pk, table = _paged(card, k, 8, mask, seed=2)
    pv, _ = _paged(card, v, 8, mask, seed=2)
    _check_body(kern.paged_extend_attention, "fma", (q, pk, pv, table, mask),
                kern.paged_extend_attention_plain, dtype)


# -- flash attention for training: B5 forward, B6 dq, B7 dk/dv ------------

FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _flash_case(card, b, lq, lk, h, kvh, dtype, ragged, seed):
    """q/k/v drawn N(0, 1); dO drawn 0.1 * N(0, 1) (a training step's
    gradients reaching attention are smaller still), so bf16 gradients
    stay where one bf16 step is below the tolerance. ``ragged``: key
    lengths drawn per row, the last batch row fully masked."""
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(card, dtype)

    q, k, v = t(b, lq, h, 64), t(b, lk, kvh, 64), t(b, lk, kvh, 64)
    mask = torch.ones(b, lk, device=card)
    if ragged:
        lens = rng.integers(1, lk + 1, b)
        mask = (torch.arange(lk)[None] < torch.as_tensor(lens)[:, None])
        mask[-1] = False
        mask = mask.to(card, torch.float32)
    return q, k, v, mask, t(b, lq, h, 64, s=0.1)


@pytest.mark.parametrize(
    "b,lq,lk,h,kvh,dtype,causal,window,ragged",
    [(4, 128, 128, 12, 12, torch.bfloat16, False, None, True),  # sst2-bert
     (2, 200, 200, 4, 4, torch.bfloat16, True, None, False),    # ragged edge
     (2, 150, 150, 8, 2, torch.float32, True, 40, True),        # GQA window
     (3, 50, 130, 4, 2, torch.float32, False, None, True),      # Lq != Lk
     (2, 256, 256, 12, 12, torch.float32, False, None, True)],
)
def test_flash_kernels_match_plain(card, b, lq, lk, h, kvh, dtype, causal,
                                   window, ragged):
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    q, k, v, mask, dout = _flash_case(card, b, lq, lk, h, kvh, dtype, ragged,
                                      seed=lq + lk)
    cfg = dict(causal=causal, scale=0.125, window=window)
    n = [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                              kern.flash_backward_dkv)]
    out, lse = kern.flash_forward(q, k, v, mask, **cfg)
    out_p, lse_p = kern.flash_forward_plain(q, k, v, mask, **cfg)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dq = kern.flash_backward_dq(q, k, v, mask, dout, lse_p, delta, **cfg)
    dk, dv = kern.flash_backward_dkv(q, k, v, mask, dout, lse_p, delta, **cfg)
    torch.cuda.synchronize()
    assert [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                                 kern.flash_backward_dkv)] == [x + 1 for x in n]
    dq_p, dk_p, dv_p = kern.flash_backward_plain(q, k, v, mask, dout, lse_p,
                                                 delta, **cfg)
    keep = _keep(mask, causal, window, lq, lk)[:, 0].expand(b, lq, lk)
    live_q, live_k = keep.any(-1), keep.any(-2)          # [B, Lq], [B, Lk]
    tol = FLASH_TOL[dtype]
    for name, got, want, live in (
        ("out", out, out_p, live_q), ("dq", dq, dq_p, live_q),
        ("dk", dk, dk_p, live_k), ("dv", dv, dv_p, live_k),
    ):
        assert torch.isfinite(got).all(), name
        err = (got.float() - want.float()).abs()[live].max().item()
        ref = want.float().abs()[live].max().item()
        # Absolute, and relative to the largest value: a small gradient
        # must not pass by being small.
        assert err <= tol and err <= tol * ref, (name, err, ref)
        assert not got[~live].any(), name     # exact zeros where dead
    err = (lse - lse_p).abs()[live_q[:, None, :].expand_as(lse)].max().item()
    assert err <= 1e-4, err


def test_flash_autograd_runs_the_three_kernels(card):
    q, k, v, mask, dout = _flash_case(card, 2, 128, 128, 12, 12,
                                      torch.bfloat16, True, seed=4)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    n = [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                              kern.flash_backward_dkv)]
    out = kern.flash_attention(*qkv, mask)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                                 kern.flash_backward_dkv)] == [x + 1 for x in n]
    _, lse_p = kern.flash_forward_plain(q, k, v, mask, scale=0.125)
    delta = (dout.float() * out.detach().float()).sum(-1).transpose(1, 2)
    want = kern.flash_backward_plain(q, k, v, mask, dout, lse_p,
                                     delta.contiguous(), scale=0.125)
    for t, w in zip(qkv, want):
        err = (t.grad.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item()


def test_flash_reads_strided_views_of_a_fused_projection(card):
    q, k, v, mask, _ = _flash_case(card, 2, 96, 96, 12, 12, torch.bfloat16,
                                   False, seed=5)
    qkv = torch.cat([q, k, v], dim=2)              # [B, L, 3H, D]
    views = qkv.split(12, dim=2)
    assert not views[0].is_contiguous()
    got, lse = kern.flash_forward(*views, mask, causal=True, scale=0.125)
    want, lse_c = kern.flash_forward(q.contiguous(), k.contiguous(),
                                     v.contiguous(), mask, causal=True,
                                     scale=0.125)
    assert torch.equal(got, want) and torch.equal(lse, lse_c)


def test_flash_head_dim_other_than_64_raises(card):
    """D = 288 is taken on the card: the wrapper pads it to 512, and one
    B5 launch on the CUDA-core body gives the plain version's output."""
    rng = np.random.default_rng(288)
    q = torch.as_tensor(rng.standard_normal((2, 32, 4, 288)),
                        dtype=torch.float32).to(card, torch.bfloat16)
    n0, b0 = kern.flash_forward.launches, kern.flash_forward.bodies["fma"]
    out = kern.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert kern.flash_forward.launches == n0 + 1
    assert kern.flash_forward.bodies["fma"] == b0 + 1
    mask = torch.ones(2, 32, device=card)
    want, _ = kern.flash_forward_plain(q, q, q, mask, scale=288 ** -0.5)
    assert out.shape == want.shape
    assert (out.float() - want.float()).abs().max().item() <= 2e-2


# -- every head dim up to 128; the decode body (B1/B3) ----------------------

DECODE_FORMATS = {  # name: (query dtype, cache format)
    "bf16": (torch.bfloat16, "none"), "f32": (torch.float32, "none"),
    "int8": (torch.bfloat16, "int8"),
}


def _decode_case(card, b, h, kvh, length, d, fmt, seed):
    """One decode token per row: keys from a ragged left pad up to a
    random last slot attend; batch row 0 has no valid key."""
    dtype, cache = DECODE_FORMATS[fmt]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(card, dtype)

    q = t(b, 1, h, d)
    k, v = t(b, length, kvh, d), t(b, length, kvh, d)
    if cache == "int8":
        k = dict(zip(("q", "scale"), kv_quantize(k)))
        v = dict(zip(("q", "scale"), kv_quantize(v)))
    idx = torch.arange(length, device=card)
    last = torch.as_tensor(rng.integers(length // 2, length, b), device=card)
    pads = torch.as_tensor(rng.integers(0, length // 4 + 1, b), device=card)
    mask = (idx[None] <= last[:, None]) & (idx[None] >= pads[:, None])
    mask[0] = False
    return q, k, v, mask


@pytest.mark.parametrize("fmt", list(DECODE_FORMATS))
@pytest.mark.parametrize("group", [1, 2, 4, 6])
@pytest.mark.parametrize("d", [12, 16, 32, 64, 128, 160, 256])
def test_decode_body_matches_plain(card, d, group, fmt):
    """B1's decode body against its plain version at every context length
    a served window reaches (1, 48, 416, 1000, 1024), with a batch row
    that attends nothing: within tolerance on live rows, exact zeros on
    the dead one, one launch on the decode body each."""
    dtype = DECODE_FORMATS[fmt][0]
    for length in (1, 48, 416, 1000, 1024):
        args = _decode_case(card, 3, 2 * group, 2, length, d, fmt,
                            seed=length + d + group)
        _check_body(kern.decode_attention, "decode", args,
                    kern.decode_attention_plain, dtype)


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("d", [12, 32, 128, 160, 256])
def test_paged_decode_body_equals_contiguous(card, d, fmt, page):
    """B3 on the decode body: within tolerance of its plain version, and
    bit for bit B1 over the same bytes (group 4, a dead batch row)."""
    dtype = DECODE_FORMATS[fmt][0]
    q, k, v, mask = _decode_case(card, 3, 8, 2, 448, d, fmt, seed=d + page)
    pk, table = _paged(card, k, page, mask, seed=1)
    pv, _ = _paged(card, v, page, mask, seed=1)
    got = _check_body(kern.paged_decode_attention, "decode",
                      (q, pk, pv, table, mask),
                      kern.paged_decode_attention_plain, dtype)
    n0 = kern.decode_attention.bodies["decode"]
    same = kern.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert kern.decode_attention.bodies["decode"] == n0 + 1
    assert torch.equal(got, same)


@pytest.mark.parametrize("d", [12, 64, 128])
def test_decode_body_reads_a_strided_query(card, d):
    """q as a view of the fused QKV projection, GQA: the same bits as a
    contiguous q."""
    q, k, v, mask = _decode_case(card, 4, 8, 2, 300, d, "bf16", seed=d)
    view = torch.cat([q, q, q], dim=2)[:, :, :8]
    assert not view.is_contiguous()
    n0 = kern.decode_attention.bodies["decode"]
    got = kern.decode_attention(view, k, v, mask)
    want = kern.decode_attention(q.contiguous(), k, v, mask)
    assert kern.decode_attention.bodies["decode"] == n0 + 2
    assert torch.equal(got, want)


def _span_case_d(card, b, u, h, kvh, length, slot, d, dtype, fmt, seed):
    """``_span_case`` at head dim ``d``."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(card, dtype)

    q = t(b, u, h, d)
    k, v = t(b, length, kvh, d), t(b, length, kvh, d)
    if fmt == "int8":
        k = dict(zip(("q", "scale"), kv_quantize(k)))
        v = dict(zip(("q", "scale"), kv_quantize(v)))
    idx = torch.arange(length, device=card)
    pads = torch.as_tensor(rng.integers(0, slot + 1, b), device=card)
    qpos = slot + torch.arange(u, device=card)
    mask = (idx[None, None] <= qpos[None, :, None]) & (
        idx[None, None] >= pads[:, None, None])
    mask[0] = False
    return q, k, v, mask


@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_extend_mma_head_dims(card, d, fmt):
    """B2 and B4 on the tensor-core body at compiled head dims other than
    64, GQA, paged bit for bit equal to contiguous."""
    q, k, v, mask = _span_case_d(card, 3, 40, 8, 2, 456, 300, d,
                                 torch.bfloat16, fmt, seed=d)
    got = _check_body(kern.extend_attention, "mma", (q, k, v, mask),
                      kern.extend_attention_plain, torch.bfloat16)
    pk, table = _paged(card, k, 8, mask, seed=3)
    pv, _ = _paged(card, v, 8, mask, seed=3)
    paged = _check_body(kern.paged_extend_attention, "mma",
                        (q, pk, pv, table, mask),
                        kern.paged_extend_attention_plain, torch.bfloat16)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [12, 48, 160, 256, 320, 512])
def test_extend_uncompiled_head_dim_runs_the_fma_body(card, d, dtype):
    """A head dim outside {16, 32, 64, 128} runs the CUDA-core body at the
    next compiled dim (256 included; past 256 in 256-wide column chunks)
    over the cache as it is, contiguous and paged."""
    q, k, v, mask = _span_case_d(card, 2, 9, 8, 2, 200, 60, d, dtype,
                                 "none", seed=d)
    got = _check_body(kern.extend_attention, "fma", (q, k, v, mask),
                      kern.extend_attention_plain, dtype)
    pk, table = _paged(card, k, 8, mask, seed=2)
    pv, _ = _paged(card, v, 8, mask, seed=2)
    paged = _check_body(kern.paged_extend_attention, "fma",
                        (q, pk, pv, table, mask),
                        kern.paged_extend_attention_plain, dtype)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [12, 16, 32, 128, 160, 256, 320, 512])
def test_flash_kernels_head_dims(card, d, dtype):
    """B5-B7 at head dims other than 64 (12, 160 and 320 through the
    wrappers' zero padding; 320 and 512 in two 256-wide column chunks):
    against the plain versions, GQA, causal, a dead batch row; the
    autograd Function's gradients too."""
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    rng = np.random.default_rng(d)

    def t(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(card, dtype)

    b, length, h, kvh = 2, 96, 4, 2
    q, k, v = t(b, length, h, d), t(b, length, kvh, d), t(b, length, kvh, d)
    dout = t(b, length, h, d, s=0.1)
    mask = torch.ones(b, length, device=card)
    mask[-1] = 0.0
    cfg = dict(causal=True, scale=d ** -0.5, window=None)
    n = [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                              kern.flash_backward_dkv)]
    out, lse = kern.flash_forward(q, k, v, mask, **cfg)
    out_p, lse_p = kern.flash_forward_plain(q, k, v, mask, **cfg)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dq = kern.flash_backward_dq(q, k, v, mask, dout, lse_p, delta, **cfg)
    dk, dv = kern.flash_backward_dkv(q, k, v, mask, dout, lse_p, delta, **cfg)
    torch.cuda.synchronize()
    assert [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                                 kern.flash_backward_dkv)] == [x + 1 for x in n]
    dq_p, dk_p, dv_p = kern.flash_backward_plain(q, k, v, mask, dout, lse_p,
                                                 delta, **cfg)
    keep = _keep(mask, True, None, length, length)[:, 0].expand(b, length,
                                                                length)
    live_q, live_k = keep.any(-1), keep.any(-2)
    tol = FLASH_TOL[dtype]
    for name, got, want, live in (
        ("out", out, out_p, live_q), ("dq", dq, dq_p, live_q),
        ("dk", dk, dk_p, live_k), ("dv", dv, dv_p, live_k),
    ):
        assert got.shape == want.shape and got.is_contiguous(), name
        assert torch.isfinite(got).all(), name
        err = (got.float() - want.float()).abs()[live].max().item()
        ref = want.float().abs()[live].max().item()
        assert err <= tol and err <= tol * ref, (name, err, ref)
        assert not got[~live].any(), name
    err = (lse - lse_p).abs()[live_q[:, None, :].expand_as(lse)].max().item()
    assert err <= 1e-4, err
    # Through the autograd Function: B5 forward, B6 + B7 backward.
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    n = [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                              kern.flash_backward_dkv)]
    kern.flash_attention(*qkv, mask, causal=True).backward(dout)
    torch.cuda.synchronize()
    assert [f.launches for f in (kern.flash_forward, kern.flash_backward_dq,
                                 kern.flash_backward_dkv)] == [x + 1 for x in n]
    for x, w in zip(qkv, (dq_p, dk_p, dv_p)):
        assert x.grad.shape == w.shape
        err = (x.grad.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(w.float().abs().max().item(), 1e-3), err


# -- B5, B6 and B7 on the tensor cores (bf16, D <= 128) --------------------

FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")


def _flash_bf16_case(card, b, length, h, kvh, d, seed, dead_row=True):
    """q/k/v N(0, 1) and dO 0.1 * N(0, 1) in bf16; key lengths drawn per
    batch row, the last row fully masked when ``dead_row``."""
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(card, torch.bfloat16)

    q, k, v = t(b, length, h, d), t(b, length, kvh, d), t(b, length, kvh, d)
    lens = rng.integers(length // 2, length + 1, b)
    mask = (torch.arange(length)[None] < torch.as_tensor(lens)[:, None])
    if dead_row:
        mask[-1] = False
    return q, k, v, mask.to(card, torch.float32), t(b, length, h, d, s=0.1)


def _flash_run(q, k, v, mask, dout, cfg, bodies):
    """B5, B6 and B7 once each against their plain versions (B6/B7 from
    the plain forward's lse): each launches once on the named body;
    within FLASH_TOL on live rows (absolute and relative to the largest
    value), exact zeros where nothing is attended, lse within 1e-4.
    Returns the kernels' (out, lse, dq, dk, dv)."""
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    b, lq, _, _ = q.shape
    lk = k.shape[1]
    fns = [getattr(kern, w) for w in FLASH]
    n0 = [f.launches for f in fns]
    b0 = [dict(f.bodies) for f in fns]
    out, lse = kern.flash_forward(q, k, v, mask, **cfg)
    out_p, lse_p = kern.flash_forward_plain(q, k, v, mask, **cfg)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dq = kern.flash_backward_dq(q, k, v, mask, dout, lse_p, delta, **cfg)
    dk, dv = kern.flash_backward_dkv(q, k, v, mask, dout, lse_p, delta, **cfg)
    torch.cuda.synchronize()
    for f, n, b_, body in zip(fns, n0, b0, bodies):
        assert f.launches == n + 1
        assert f.bodies[body] == b_[body] + 1, (f.__name__, f.bodies)
    dq_p, dk_p, dv_p = kern.flash_backward_plain(q, k, v, mask, dout, lse_p,
                                                 delta, **cfg)
    keep = _keep(mask, cfg["causal"], cfg["window"], lq, lk)[:, 0]
    keep = keep.expand(b, lq, lk)
    live_q, live_k = keep.any(-1), keep.any(-2)
    tol = FLASH_TOL[q.dtype]
    for name, got, want, live in (
        ("out", out, out_p, live_q), ("dq", dq, dq_p, live_q),
        ("dk", dk, dk_p, live_k), ("dv", dv, dv_p, live_k),
    ):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        err = (got.float() - want.float()).abs()[live].max().item()
        ref = want.float().abs()[live].max().item()
        assert err <= tol and err <= tol * ref, (name, err, ref)
        assert not got[~live].any(), name
    err = (lse - lse_p).abs()[live_q[:, None, :].expand_as(lse)].max().item()
    assert err <= 1e-4, err
    # A query row with no valid key: lse at NEG, as the plain version's.
    dead = ~live_q[:, None, :].expand_as(lse)
    assert not dead.any() or bool((lse[dead] <= -1e29).all())
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 48)])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("length", [100, 128, 1000])
def test_flash_mma_bodies_match_plain(card, length, group, causal, window):
    """B5, B6 and B7 in bf16 at D = 64 on the tensor-core bodies: ragged
    key lengths, a batch row with no valid key, GQA group 1 and 4, causal
    with and without a sliding window."""
    h = 8
    args = _flash_bf16_case(card, 2, length, h, h // group, 64,
                            seed=length + group)
    cfg = dict(causal=causal, scale=0.125, window=window)
    _flash_run(*args, cfg, ("mma", "mma", "mma"))


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_mma_bodies_head_dims(card, d):
    """The tensor-core bodies at D = 16, 64 and 128 (B7 holds K and V as
    fragments up to 64 and reads them per product at 128; B6 reads Q and
    dO per product at every D), causal GQA."""
    args = _flash_bf16_case(card, 3, 300, 8, 2, d, seed=d)
    cfg = dict(causal=True, scale=d ** -0.5, window=None)
    _flash_run(*args, cfg, ("mma", "mma", "mma"))


def test_flash_mma_reads_strided_views(card):
    """q, k, v and dO as views of fused projections (heads strided by
    3H * D): B5 and B7 on the tensor cores give the same bits as on
    contiguous copies."""
    q, k, v, mask, dout = _flash_bf16_case(card, 2, 200, 12, 12, 64, seed=8)
    views = torch.cat([q, k, v], dim=2).split(12, dim=2)
    g_view = torch.cat([dout, dout, dout], dim=2)[:, :, :12]
    assert not views[0].is_contiguous() and not g_view.is_contiguous()
    cfg = dict(causal=True, scale=0.125, window=None)
    n0 = (kern.flash_forward.bodies["mma"],
          kern.flash_backward_dkv.bodies["mma"])
    got = kern.flash_forward(*views, mask, **cfg)
    want = kern.flash_forward(q, k, v, mask, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    lse = want[1]
    delta = (dout.float() * want[0].float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    got = kern.flash_backward_dkv(*views, mask, g_view, lse, delta, **cfg)
    want = kern.flash_backward_dkv(q, k, v, mask, dout, lse, delta, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (kern.flash_forward.bodies["mma"],
            kern.flash_backward_dkv.bodies["mma"]) == (n0[0] + 2, n0[1] + 2)


def test_flash_mma_dkv_is_deterministic(card):
    """B7 sums a GQA group's heads and query tiles in one block, in a
    fixed order: two runs give the same bits."""
    q, k, v, mask, dout = _flash_bf16_case(card, 2, 1000, 16, 4, 64, seed=9)
    cfg = dict(causal=True, scale=0.125, window=None)
    _, lse = kern.flash_forward(q, k, v, mask, **cfg)
    delta = torch.randn(lse.shape, device=card) * 0.1
    first = kern.flash_backward_dkv(q, k, v, mask, dout, lse, delta, **cfg)
    again = kern.flash_backward_dkv(q, k, v, mask, dout, lse, delta, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("d", [64, 256])
def test_flash_f32_and_d256_keep_the_cuda_core_bodies(card, d):
    """f32 (exact f32, no TF32) and bf16 at D = 256 run the CUDA-core
    bodies of B5 and B7."""
    q, k, v, mask, dout = _flash_bf16_case(card, 2, 130, 4, 2, d, seed=d)
    cfg = dict(causal=True, scale=d ** -0.5, window=None)
    if d == 64:
        q, k, v, dout = (x.float() for x in (q, k, v, dout))
    _flash_run(q, k, v, mask, dout, cfg, ("fma", "fma", "fma"))


# -- B6 on the tensor cores (bf16, D <= 128) ------------------------------

def _dq_case(card, b, lq, lk, h, kvh, d, seed):
    """bf16 q [B, Lq, H, D], k/v [B, Lk, KVH, D], dO 0.1 * N(0, 1), key
    lengths drawn per batch row and the last row fully masked; lse from
    the plain forward, delta = rowsum(dO * out)."""
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).to(card, torch.bfloat16)

    q, k, v = t(b, lq, h, d), t(b, lk, kvh, d), t(b, lk, kvh, d)
    lens = rng.integers(lk // 2, lk + 1, b)
    mask = (torch.arange(lk)[None] < torch.as_tensor(lens)[:, None])
    mask[-1] = False
    return q, k, v, mask.to(card), t(b, lq, h, d, s=0.1)


def _dq_check(q, k, v, mask, dout, cfg, views=None):
    """One B6 launch on the tensor-core body against the plain version:
    within 2e-2 (absolute and relative to the largest value) on rows that
    attend a key, exact zeros on the others. ``views``: (q, dO) passed as
    strided views instead, which must give the same bits."""
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    b, lq = q.shape[:2]
    lk = k.shape[1]
    out, lse = kern.flash_forward_plain(q, k, v, mask, **cfg)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    fn = kern.flash_backward_dq
    n0, b0 = fn.launches, fn.bodies["mma"]
    dq = fn(q, k, v, mask, dout, lse, delta, **cfg)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and fn.bodies["mma"] == b0 + 1
    want = kern.flash_backward_plain(q, k, v, mask, dout, lse, delta,
                                     **cfg)[0]
    keep = _keep(mask, cfg["causal"], cfg["window"], lq, lk)[:, 0]
    live = keep.expand(b, lq, lk).any(-1)
    assert dq.shape == want.shape and torch.isfinite(dq).all()
    err = (dq.float() - want.float()).abs()[live].max().item()
    ref = want.float().abs()[live].max().item()
    assert err <= 2e-2 and err <= 2e-2 * ref, (err, ref)
    assert not dq[~live].any()
    if views is not None:
        again = fn(views[0], k, v, mask, views[1], lse, delta, **cfg)
        assert torch.equal(again, dq)


DQ_CASES = [  # b, lq, lk, h, kvh, causal, window
    (2, 128, 128, 12, 12, False, None),    # sst2-bert widths
    (2, 300, 300, 8, 2, True, None),       # causal GQA 8/2, Lq % 64 != 0
    (2, 200, 200, 8, 2, True, 48),         # a sliding window
    (3, 100, 257, 8, 2, False, None),      # Lq != Lk
]


@pytest.mark.parametrize("case", DQ_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_flash_dq_mma_matches_plain(card, d, case):
    """B6 on the tensor-core body at D = 16, 32, 64, 128 and the padded
    48: causal, a window, GQA 8/2, Lq not a multiple of 64, Lq != Lk, a
    batch row with no valid key (exact zeros); Q and dO also as strided
    views of fused projections (same bits)."""
    b, lq, lk, h, kvh, causal, window = case
    q, k, v, mask, dout = _dq_case(card, b, lq, lk, h, kvh, d, seed=d + lq)
    cfg = dict(causal=causal, scale=d ** -0.5, window=window)
    q_view = torch.cat([q, q, q], dim=2)[:, :, h:2 * h]
    g_view = torch.cat([dout, dout], dim=2)[:, :, :h]
    assert not q_view.is_contiguous() and not g_view.is_contiguous()
    _dq_check(q, k, v, mask, dout, cfg, views=(q_view, g_view))


# -- head dims past 256: the D = 256 CUDA-core bodies in column chunks -----

@pytest.mark.parametrize("fmt", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("d", [320, 512])
def test_head_dims_past_256_match_plain(card, d, fmt):
    """B1 and B3 at D = 320 and 512 run the CUDA-core split-K body in two
    column chunks, not the decode body: within tolerance of their plain
    versions, exact zeros on a dead batch row, paged bit for bit equal to
    contiguous (B2/B4: test_extend_uncompiled_head_dim_runs_the_fma_body)."""
    dtype = DECODE_FORMATS[fmt][0]
    q, k, v, mask = _decode_case(card, 3, 8, 2, 448, d, fmt, seed=d)
    got = _check_body(kern.decode_attention, "fma", (q, k, v, mask),
                      kern.decode_attention_plain, dtype)
    pk, table = _paged(card, k, 8, mask, seed=4)
    pv, _ = _paged(card, v, 8, mask, seed=4)
    paged = _check_body(kern.paged_decode_attention, "fma",
                        (q, pk, pv, table, mask),
                        kern.paged_decode_attention_plain, dtype)
    assert torch.equal(got, paged)


# -- TinyLlama-1.1B's geometry: 32 query heads on 4 KV heads of 64 --------
# A group of 8 at D = 64: B1/B3 serve 8 query heads a block, B2/B4's
# tensor-core body tiles U x 8 rows a KV head, B5-B7 read one KV head for
# eight query heads.

@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("length", [96, 2048])
def test_group8_decode_matches_plain_and_paged_equals_contiguous(card,
                                                                 length,
                                                                 fmt):
    dtype = DECODE_FORMATS[fmt][0]
    q, k, v, mask = _decode_case(card, 4, 32, 4, length, 64, fmt,
                                 seed=length)
    got = _check_body(kern.decode_attention, "decode", (q, k, v, mask),
                      kern.decode_attention_plain, dtype)
    pk, table = _paged(card, k, 16, mask, seed=5)
    pv, _ = _paged(card, v, 16, mask, seed=5)
    paged = _check_body(kern.paged_decode_attention, "decode",
                        (q, pk, pv, table, mask),
                        kern.paged_decode_attention_plain, dtype)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize("b,u,length,slot", [(2, 128, 2048, 1024),
                                              (3, 17, 304, 100)])
def test_group8_extend_mma_matches_plain_and_paged_equals_contiguous(
        card, b, u, length, slot, fmt):
    q, k, v, mask = _span_case(card, b, u, 32, 4, length, slot,
                               torch.bfloat16, fmt, seed=u + length)
    got = _check_body(kern.extend_attention, "mma", (q, k, v, mask),
                      kern.extend_attention_plain, torch.bfloat16)
    pk, table = _paged(card, k, 16, mask, seed=6)
    pv, _ = _paged(card, v, 16, mask, seed=6)
    paged = _check_body(kern.paged_extend_attention, "mma",
                        (q, pk, pv, table, mask),
                        kern.paged_extend_attention_plain, torch.bfloat16)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("length", [300, 1024])
def test_group8_flash_mma_bodies_match_plain(card, length):
    """B5, B6 and B7 on the tensor-core bodies, causal, 32 query heads on
    4 KV heads of 64 (B7 sums dk/dv over the group of 8)."""
    args = _flash_bf16_case(card, 2, length, 32, 4, 64, seed=length)
    cfg = dict(causal=True, scale=0.125, window=None)
    _flash_run(*args, cfg, ("mma", "mma", "mma"))


# -- shared-prefix masks (B1-B4 behind a prefix region and a pad hole) -----

PREFIX_TOL = 2 ** -7   # 7.8e-3 on live rows in bf16


def _prefix_case(card, decode, b, u, h, kvh, p, bucket, fmt, per_row, seed):
    """A batch behind a ``p``-slot prefix region: slots ``[lo, p)`` are
    the prefix (the same bytes in every row for a scalar ``lo``, each
    row's own with a per-row ``lo``), ``[p, p + n_pad)`` the row's
    suffix pad hole, then the suffix block of ``bucket`` slots and room
    to decode. Masks from the model's own helpers; the extend call is
    the suffix block at slot ``p`` (U = bucket), the decode call the
    token after it. With a per-row ``lo`` the last row is a dummy: an
    empty region and a hole over everything, so no valid key."""
    from mlapi_tpu_torch.models.gpt import (
        decode_valid_and_shift, extend_positions_and_mask,
    )

    length = p + bucket + 16
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(card, torch.bfloat16)

    q, k, v = t(b, u, h, 64), t(b, length, kvh, 64), t(b, length, kvh, 64)
    n_pad = torch.as_tensor(rng.integers(0, bucket, b), device=card)
    if per_row:
        lo = torch.as_tensor(rng.integers(0, p, b), device=card)
        lo[-1], n_pad[-1] = p, length
    else:
        lo = int(rng.integers(1, p // 2))
        k[:, :p], v[:, :p] = k[:1, :p], v[:1, :p]   # one shared prefix
    if decode:
        valid, _ = decode_valid_and_shift(length, p + bucket, n_pad, p, lo)
        mask = valid[:, 0, 0]
    else:
        _, valid = extend_positions_and_mask(length, u, p, n_pad, p, lo)
        mask = valid[:, 0]
    if fmt == "int8":
        k = dict(zip(("q", "scale"), kv_quantize(k)))
        v = dict(zip(("q", "scale"), kv_quantize(v)))
    return q, k, v, mask


def _share_prefix_pages(table, p, page):
    """Point every row's prefix tiles at row 0's pages, as rows sharing
    one prefix entry do (the bytes are the same)."""
    tiles = p // page
    shared = table[0, :tiles]
    table[:, :tiles] = torch.where(table[:, :tiles] != 0, shared,
                                   table[:, :tiles])
    return table


@pytest.mark.parametrize("per_row", [False, True], ids=["lo", "lo_per_row"])
@pytest.mark.parametrize("fmt", ["none", "int8"])
@pytest.mark.parametrize(
    "decode,b,h,kvh,p,bucket",
    [(True, 8, 12, 12, 768, 128),     # GPT-2 small, a 768-slot prefix
     (False, 8, 12, 12, 768, 128),
     (True, 8, 32, 4, 768, 128),      # TinyLlama's group of 8
     (False, 8, 32, 4, 768, 128),
     (False, 4, 12, 12, 512, 256),    # a suffix past the largest bucket
     (False, 4, 32, 4, 512, 256)],
)
def test_prefix_masks_match_plain_and_paged_equals_contiguous(
        card, decode, b, h, kvh, p, bucket, fmt, per_row):
    """B1/B2 against their plain versions, and B3/B4 over 16-token pages
    (a scalar ``lo``: every row's prefix tiles on the same pages) against
    theirs and against B1/B2 on the same bytes, bit for bit."""
    u = 1 if decode else bucket
    q, k, v, mask = _prefix_case(card, decode, b, u, h, kvh, p, bucket, fmt,
                                 per_row, seed=p + bucket + h)
    fns = ((kern.decode_attention, kern.decode_attention_plain,
            kern.paged_decode_attention, kern.paged_decode_attention_plain)
           if decode else
           (kern.extend_attention, kern.extend_attention_plain,
            kern.paged_extend_attention, kern.paged_extend_attention_plain))
    fn, plain, paged, paged_plain = fns
    live = mask.reshape(b, -1, mask.shape[-1]).any(-1)
    if per_row:
        assert not live[-1].any()       # the dummy row attends nothing
    n0 = fn.launches
    got = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    err = (got.float() - plain(q, k, v, mask).float()).abs()[live].max()
    assert torch.isfinite(got).all() and err.item() <= PREFIX_TOL, err
    assert not got[~live].any()
    pk, table = _paged(card, k, 16, mask, seed=1)
    pv, _ = _paged(card, v, 16, mask, seed=1)
    if not per_row:
        table = _share_prefix_pages(table, p, 16)
    n0 = paged.launches
    pgot = paged(q, pk, pv, table, mask)
    torch.cuda.synchronize()
    assert paged.launches == n0 + 1
    err = (pgot.float()
           - paged_plain(q, pk, pv, table, mask).float()).abs()[live].max()
    assert err.item() <= PREFIX_TOL, err
    assert torch.equal(pgot, got)


# -- sampled tokens and the unit scheduler on the card (fault C4) --------

SERVE_CFG = dict(vocab_size=260, hidden_size=128, num_layers=2, num_heads=4,
                 max_positions=384, compute_dtype="bfloat16")
SAMPLING = dict(temperature=0.9, top_k=40, top_p=0.95)
# With a 256-byte prompt (2 chunks) a 136-token budget overruns the window.
SHORT_NEW, LONG_TEXT = 136, ("a long prompt in two chunks. " * 9)[:256]


def _serving_engine(card, page, kv_quant, sched=2):
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.text import ByteTokenizer

    model = GptLM(**SERVE_CFG, seed=0, device=card)
    model.configure(kv_quant=kv_quant, decode_attn_impl="flash")
    # A pool of 8 full windows: the page budget never holds a lane back.
    pages = 8 * -(-SERVE_CFG["max_positions"] // page) + 1 if page else None
    return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                max_wait_ms=0.0, kv_page_size=page,
                                kv_pages=pages, sched_max_batches=sched)


def _serve(eng, specs, sched=2):
    """Queue ``(text, n_new, sampling seed or None)`` requests together
    (one group per window-compatible run, rows in order) on a started
    engine; returns each stream and the scheduler's trace."""
    import asyncio

    async def run():
        eng.sched_max_batches = sched
        await eng.start()
        try:
            loop = asyncio.get_running_loop()
            reqs = []
            for text, n, seed in specs:
                samp = SAMPLING if seed is not None else {}
                reqs.append(eng._encode(
                    text, n, samp.get("temperature", 0.0), seed or 0, loop,
                    samp.get("top_k", 0), samp.get("top_p", 1.0),
                    stream=True))
            for r in reqs:
                eng._queue.put_nowait(r)
            outs = []
            for r in reqs:
                toks = []
                while (item := await r.queue.get()) is not None:
                    assert not isinstance(item, Exception), item
                    toks += item["token_ids"]
                outs.append(toks)
            return outs, list(eng.sched.trace)
        finally:
            await eng.stop()

    return asyncio.run(run())


@pytest.mark.parametrize("page,kv_quant", [(None, "none"), (16, "int8")])
def test_sampled_streams_keep_their_contract_on_the_card(card, page,
                                                         kv_quant):
    """``_pick_token``'s contract on the card: the same seed gives the
    same stream; a row's stream is the same in slot 0 and slot 3 and
    beside other batch mates (same shapes), and the same at
    ``--sched-max-batches`` 1 and 2 (the same batches); a stop string
    ends the answer where the text says."""
    import json
    import urllib.request

    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.server import BackgroundServer

    eng = _serving_engine(card, page, kv_quant)
    me = ("sample a stream", 32, 11)
    mates = [("mate one", 32, 3), ("mate two", 32, 4), ("mate three", 32, 5)]
    others = [("other a", 32, 6), ("other b", 32, 7), ("other c", 32, 8)]
    alone = _serve(eng, [me])[0][0]
    assert alone == _serve(eng, [me])[0][0]
    assert alone != _serve(eng, [(me[0], 32, 12)])[0][0]
    first = _serve(eng, [me] + mates)[0][0]
    assert first == _serve(eng, mates + [me])[0][3]
    assert first == _serve(eng, [me] + others)[0][0]
    pair = [("sample a stream", SHORT_NEW, 11), (LONG_TEXT, 8, None)]
    (serial, _), (two, trace) = (_serve(eng, pair, 1), _serve(eng, pair, 2))
    assert serial == two and eng.sched_batches_live_max == 2
    body = {"text": me[0], "seed": 11, "max_new_tokens": 32, **SAMPLING}

    def post(b):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps(b).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with BackgroundServer(build_app(eng)) as srv:
        full = post(body)
        assert full["token_ids"] == alone
        text = full["text"]
        stop = next(c for c in text[4:] if c.isalnum())
        out = post({**body, "stop": stop})
    assert out["text"] == text[:text.find(stop)] and out["stopped"] == stop
    assert out["token_ids"] == alone[:len(out["token_ids"])]


@pytest.mark.parametrize("page,kv_quant", [(None, "none"), (16, "int8")])
def test_launches_are_exact_summed_over_lanes(card, page, kv_quant):
    """Two window-incompatible groups live at once (a long prompt's 2
    chunks through B2/B4): flash-decode exactly one launch per layer per
    decode step summed over both lanes, flash-extend one per layer per
    prefill chunk, no other kernel."""
    eng = _serving_engine(card, page, kv_quant)
    decode, extend = ((kern.paged_decode_attention,
                       kern.paged_extend_attention) if page else
                      (kern.decode_attention, kern.extend_attention))
    steps = [0]
    step = eng.model.decode_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    eng.model.decode_step = counted
    fns = (kern.decode_attention, kern.extend_attention,
           kern.paged_decode_attention, kern.paged_extend_attention)
    n0 = [f.launches for f in fns]
    chunks0 = eng.prefill_chunks
    outs, trace = _serve(eng, [(f"short {i}", SHORT_NEW, None)
                               for i in range(4)] + [(LONG_TEXT, 8, None)])
    assert [len(o) for o in outs] == [SHORT_NEW] * 4 + [8]
    assert eng.sched_batches_live_max == 2
    lanes = [lane for lane, _ in trace]
    assert sum(a != b for a, b in zip(lanes, lanes[1:])) >= 2
    layers = SERVE_CFG["num_layers"]
    launched = [f.launches - n for f, n in zip(fns, n0)]
    want = {decode: layers * steps[0],
            extend: layers * (eng.prefill_chunks - chunks0)}
    assert eng.prefill_chunks - chunks0 == 2
    assert launched == [want.get(f, 0) for f in fns]


# -- the scoring path ----------------------------------------------------

@pytest.mark.parametrize("b", [1, 64, 512])
def test_b5_at_serving_shapes_with_dead_rows(card, b):
    """B5 as a BERT classifier's /predict batch runs it: L = 128, 12 heads
    of 64, bf16, key masks of ragged lengths, and for B > 1 a last
    quarter of bucket-padding rows whose keys are all masked (dead):
    within 2e-2 of the plain version on live rows, exact zeros on dead
    ones, on the tensor-core body."""
    rng = np.random.default_rng(b)
    live = b if b == 1 else b - b // 4
    lens = np.concatenate([rng.integers(8, 129, live),
                           np.zeros(b - live, np.int64)])
    mask = (torch.arange(128)[None] < torch.as_tensor(lens)[:, None])
    mask = mask.to(card, torch.float32)

    def t():
        return torch.as_tensor(rng.standard_normal((b, 128, 12, 64)),
                               dtype=torch.float32).to(card, torch.bfloat16)

    q, k, v = t(), t(), t()
    n0, mma0 = kern.flash_forward.launches, kern.flash_forward.bodies["mma"]
    with torch.inference_mode():
        out, _ = kern.flash_forward(q, k, v, mask, scale=0.125)
    torch.cuda.synchronize()
    assert kern.flash_forward.launches == n0 + 1
    assert kern.flash_forward.bodies["mma"] == mma0 + 1
    want, _ = kern.flash_forward_plain(q, k, v, mask, scale=0.125)
    live_q = mask.bool().any(-1)
    err = (out.float() - want.float()).abs()[live_q].max().item()
    assert torch.isfinite(out).all() and err <= FLASH_TOL[torch.bfloat16]
    assert not out[~live_q].any()


@pytest.mark.parametrize("backend", ["pool", "sched"])
def test_score_path_on_the_card_builds_no_graph(card, backend):
    """A BERT classifier (flash attention) behind a ScorePath on the card:
    its runner, on a worker thread or the unit scheduler's dispatch
    thread, launches B5 once per layer per batch, in inference mode, and
    its output requires no grad, though the weights do."""
    import asyncio
    import threading

    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.serving.engine import TextClassificationEngine
    from mlapi_tpu_torch.serving.scoring import ScorePath
    from mlapi_tpu_torch.text import ByteTokenizer
    from mlapi_tpu_torch.utils.vocab import LabelVocab

    model = get_model("bert_classifier", num_classes=2, vocab_size=260,
                      hidden_size=128, num_layers=2, num_heads=2,
                      intermediate_size=256, attention_impl="flash",
                      device=card)
    assert all(p.requires_grad for p in model.parameters())
    eng = TextClassificationEngine(model, LabelVocab(("neg", "pos")),
                                   tokenizer=ByteTokenizer(), max_len=64)
    seen = []
    apply = model.apply

    def probe(x):
        out = apply(x)
        seen.append((threading.current_thread().name,
                     torch.is_inference_mode_enabled(), out.requires_grad))
        return out

    model.apply = probe

    async def run():
        gen = None
        if backend == "sched":
            gen = _serving_engine(card, None, None)
            await gen.start()
        sp = ScorePath(eng, max_wait_ms=0.0, sched_source=(
            (lambda: gen.sched) if gen is not None else None))
        await sp.start()
        try:
            texts = ["a fine film", "", "dreadful" * 3, "ok"]
            rows = [eng.encode(t) for t in texts]
            return await asyncio.gather(*(sp.submit(r) for r in rows)), sp
        finally:
            await sp.stop()
            if gen is not None:
                await gen.stop()

    n0 = kern.flash_forward.launches
    answers, sp = asyncio.run(run())
    assert [lab in ("neg", "pos") and 0.5 <= p <= 1.0
            for lab, p in answers] == [True] * 4
    assert sp.device_calls == 1
    assert sp.sched_dispatches == (1 if backend == "sched" else 0)
    assert kern.flash_forward.launches == n0 + 2     # one per layer
    assert seen and all(mode and not grad for _, mode, grad in seen)
    want = "unitsched" if backend == "sched" else "score-dispatch"
    assert all(name.startswith(want) for name, _, _ in seen), seen


@pytest.mark.parametrize("page,kv_quant", [(None, "none"), (16, "int8")])
def test_spec_streams_equal_plain_through_the_kernels(card, page, kv_quant):
    """Speculative serving in f32 on the card: solo and batched greedy
    streams equal the target-only engine's, the draft's steps through
    flash-decode (B1) and the verify blocks through flash-extend (B2,
    or B4 for a paged target), each counted."""
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.text import ByteTokenizer

    cfg = dict(SERVE_CFG, compute_dtype="float32")

    def engine(draft):
        model = GptLM(**cfg, seed=0, device=card)
        model.configure(kv_quant=kv_quant, decode_attn_impl="flash")
        if draft is not None:
            draft = GptLM(**dict(cfg, num_layers=1), seed=draft, device=card)
            draft.configure(kv_quant=kv_quant, decode_attn_impl="flash")
        return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                    kv_page_size=page, draft=draft)

    verify = kern.paged_extend_attention if page else kern.extend_attention
    specs = ([("a solo row", 40, None)],
             [("row one", 30, None), ("two", 12, None),
              ("row three", 21, None)])
    plain = engine(None)
    want = [_serve(plain, s, sched=1)[0] for s in specs]
    spec = engine(1)
    n_dec, n_ver = kern.decode_attention.launches, verify.launches
    got = [_serve(spec, s, sched=1)[0] for s in specs]
    assert got == want
    assert spec.spec_rounds > 0
    assert kern.decode_attention.launches > n_dec
    assert verify.launches > n_ver


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tier_restored_prefix_streams_equal_never_evicted(card, kv_quant):
    """The host KV tier on the card (paged 16, f32): a prefix whose pool
    pages were spilled to host memory and restored into fresh pages,
    then dropped by the prefix dict's LRU and rebuilt from its blob,
    streams what the never-evicted prefix streamed, with no prefill;
    the restored requests read the restored pages through flash-extend
    (B4, the suffix) and flash-decode (B3), one launch a layer each
    (a step for B3)."""
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.text import ByteTokenizer

    cfg = dict(SERVE_CFG, compute_dtype="float32")
    model = GptLM(**cfg, seed=0, device=card)
    model.configure(kv_quant=kv_quant, decode_attn_impl="flash")
    eng = TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                               kv_page_size=16, kv_tier_bytes=1 << 26)
    # 17 tokens: the 16 after the first are one 16-wide fused chunk.
    prefix, n = "You are a terse assistant on the card. " * 2, 17
    want = eng.generate_text(" q1", prefix=prefix, max_new_tokens=n)
    pages = len(eng.pool.entry_pages(prefix))
    assert eng.pool.evict_idle(1) == 1
    layers = cfg["num_layers"]
    for seam in ("pool", "entry"):
        if seam == "entry":
            eng.prefix.max_entries = 1
            eng.generate_text(" q", prefix="another prefix", max_new_tokens=2)
        b3, b4 = (kern.paged_decode_attention.launches,
                  kern.paged_extend_attention.launches)
        got = eng.generate_text(" q1", prefix=prefix, max_new_tokens=n)
        assert got["token_ids"] == want["token_ids"], seam
        assert kern.paged_extend_attention.launches - b4 == layers
        assert kern.paged_decode_attention.launches - b3 == layers * (n - 1)
    assert eng.prefix_builds == 2          # the prefix and the other one
    assert eng.kv_prefix_restore_hits == 3  # pages, entry, pages
    assert eng.kv_prefix_spill_bytes >= pages * eng.kv_page_bytes()
    assert eng.kv_prefix_restore_bytes == 3 * pages * eng.kv_page_bytes()
