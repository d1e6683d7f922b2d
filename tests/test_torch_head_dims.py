"""Head dims other than GPT-2's 64: the port's plain versions of B1, B2,
B3 and B5-B7 against the JAX package's Pallas kernels (CPU).

The CUDA kernels take every head dim (compiled for 16, 32, 64, 128 and
256; others up to 256 run at the next compiled dim, or -- B5-B7 -- are
zero-padded to it by the wrappers; past 256 they run the D = 256
CUDA-core bodies in 256-wide column chunks). On the card they are held
against these plain versions (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); here the plain versions are held against the
reference at D = 12 (docs-gpt-draft), 16 (docsclf-bert), 32 (docs-gpt,
docs-llama), 128 (Llama-class), 160 (padded to 256), 256 (the widest
public decoder heads), and 320 and 512 (two 256-wide column chunks
each, past every published head), the Pallas kernels in interpret mode as the JAX package's own tests run them on the CPU.
Each interpret-mode compile costs about a second, so the grid is sparse:
each head dim runs once per kernel, B1 and B3 with opposite groups (1
and 4) and the formats rotating, so that each kernel meets both groups
and all three formats and each head dim both groups; B2 runs once, at
D = 320. D = 16 at every group and format, and B5-B7 at D = 16, are the
grids of ``test_torch_decode_attention.py``,
``test_torch_paged_attention.py`` and ``test_torch_flash_attention.py``.
Bounds: 1e-5 at f32, 2e-2 at bf16 and int8 (bf16 compute), the
reference's own; rows with no valid key are exact zeros.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.ops.pallas import decode_attention as jax_decode
from mlapi_tpu.ops.pallas import extend_attention as jax_extend
from mlapi_tpu.ops.pallas import flash_attention_with_lse as jax_flash
from mlapi_tpu.ops.pallas import paged_decode_attention as jax_paged_decode
from mlapi_tpu_torch.ops import cuda as kern
from mlapi_tpu_torch.ops.quant import kv_quantize

flash = importlib.import_module("mlapi_tpu_torch.ops.cuda.flash_attention")

B, L, H, PAGE = 3, 32, 4, 8
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
CDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.bfloat16}
FORMATS = ("f32", "bf16", "int8")
# (D, KV heads: group 1 or 4, format, span) for B1 (span 1); B3 takes the
# other group and the next format. B2 (span U) runs once past 256.
DIMS = (12, 16, 32, 128, 160, 256, 320, 512)
U = 4
CELLS = [(d, H if i % 2 == 0 else H // 4, FORMATS[i % 3], 1)
         for i, d in enumerate(DIMS)] + [(320, H // 4, "int8", U)]
PAGED_CELLS = [(d, H // 4 if i % 2 == 0 else H, FORMATS[(i + 1) % 3])
               for i, d in enumerate(DIMS)]


def _ids(cells):
    return [f"d{c[0]}-group{H // c[1]}-{c[2]}"
            + (f"-span{c[3]}" if len(c) > 3 and c[3] > 1 else "")
            for c in cells]


def _mask():
    """Three decode rows: ragged left pads, a short row, and a row with no
    valid key."""
    idx = np.arange(L)
    return np.stack([(idx >= 5) & (idx <= 29), idx <= 9,
                     np.zeros(L, bool)])


def _to_jax(x):
    if isinstance(x, dict):
        return {n: _to_jax(t) for n, t in x.items()}
    if x.dtype == torch.bfloat16:
        return x.float().numpy().astype(jnp.bfloat16)
    return x.numpy()


def _cache(rng, shape, fmt):
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    if fmt == "int8":
        # Quantized once (bit-exact with the JAX package's kv_quantize);
        # both packages get the same payload.
        return dict(zip(("q", "scale"), kv_quantize(x)))
    return x.to(CDT[fmt])


def _compare(got, want, mask, fmt):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    live = mask.any(-1)
    assert np.isfinite(got).all()
    err = np.abs(got - want)[live].max()
    assert err <= TOL[fmt], err
    assert not got[~live].any()


@pytest.mark.parametrize("d,kvh,fmt,u", CELLS, ids=_ids(CELLS))
def test_decode_plain_matches_pallas_at_head_dim(d, kvh, fmt, u):
    """B1 (span 1) or B2 (a span of U positions at the end of the window,
    the causal span structure in its [B, U, L] mask)."""
    rng = np.random.default_rng(d + kvh)
    q = torch.as_tensor(rng.standard_normal((B, u, H, d)).astype(
        np.float32)).to(CDT[fmt])
    k, v = (_cache(rng, (B, L, kvh, d), fmt) for _ in range(2))
    mask = _mask()
    if u == 1:
        want = jax_decode(_to_jax(q), _to_jax(k), _to_jax(v),
                          jnp.asarray(mask), block_k=16, interpret=True)
        got = kern.decode_attention(q, k, v, torch.as_tensor(mask))
        _compare(got[:, 0], want[:, 0], mask, fmt)
        return
    span = np.arange(L)[None, None] <= (L - u + np.arange(u))[None, :, None]
    mask3 = mask[:, None, :] & span
    want = jax_extend(_to_jax(q), _to_jax(k), _to_jax(v), jnp.asarray(mask3),
                      block_k=16, interpret=True)
    got = kern.extend_attention(q, k, v, torch.as_tensor(mask3))
    _compare(got, want, mask3, fmt)


@pytest.mark.parametrize("d,kvh,fmt", PAGED_CELLS, ids=_ids(PAGED_CELLS))
def test_paged_decode_plain_matches_pallas_at_head_dim(d, kvh, fmt):
    """Pages of 8 behind a shuffled table; tiles nothing attends map to
    the null page 0, which holds finite garbage."""
    rng = np.random.default_rng(d + kvh + 1)
    n_pages, npv = B * L // PAGE + 1, L // PAGE
    q = torch.as_tensor(rng.standard_normal((B, 1, H, d)).astype(
        np.float32)).to(CDT[fmt])
    pk, pv = (_cache(rng, (n_pages, PAGE, kvh, d), fmt) for _ in range(2))
    mask = _mask()
    live = mask.reshape(B, npv, PAGE).any(-1)
    ids = rng.permutation(n_pages - 1)[:B * npv].reshape(B, npv) + 1
    table = np.where(live, ids, 0).astype(np.int32)
    want = jax_paged_decode(_to_jax(q), _to_jax(pk), _to_jax(pv), table,
                            mask, interpret=True)
    got = kern.paged_decode_attention(q, pk, pv, torch.as_tensor(table),
                                      torch.as_tensor(mask))
    _compare(got[:, 0], want[:, 0], mask, fmt)


FLASH_CELLS = [(12, "float32"), (32, "float32"), (128, "bfloat16"),
               (160, "float32"), (256, "bfloat16"), (320, "float32"),
               (512, "bfloat16")]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _flash_inputs(d, seed, lq=L):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, lq, H, d)).astype(np.float32)
    k = rng.standard_normal((2, L, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, L, 2, d)).astype(np.float32)
    mask = np.ones((2, L), np.float32)
    mask[1] = 0.0                        # a batch row with no valid key
    g_out = rng.standard_normal((2, lq, H, d)).astype(np.float32)
    g_lse = rng.standard_normal((2, H, lq)).astype(np.float32)
    return q, k, v, mask, g_out, g_lse


@pytest.mark.parametrize("d,dtype", FLASH_CELLS)
def test_flash_plain_matches_pallas_at_head_dim(d, dtype):
    """B5's forward (out, lse) and, through the autograd Function (B6,
    B7's plain versions on the CPU), dq, dk, dv with a cotangent on both
    outputs; causal GQA, the default scale 1/sqrt(D)."""
    q, k, v, mask, g_out, g_lse = _flash_inputs(d, seed=d)

    def f(q, k, v):
        out, lse = jax_flash(q, k, v, jnp.asarray(mask), causal=True,
                             interpret=True)
        return (jnp.sum(out.astype(jnp.float32) * g_out)
                + jnp.sum(lse * g_lse)), (out, lse)

    cast = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, (out_j, lse_j)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*cast)
    want = [np.asarray(x.astype(jnp.float32))
            for x in (out_j, lse_j, *grads)]
    qkv = [torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
           for x in (q, k, v)]
    out, lse = flash.flash_attention_with_lse(*qkv, torch.tensor(mask),
                                              causal=True)
    ((out.float() * torch.tensor(g_out)).sum()
     + (lse * torch.tensor(g_lse)).sum()).backward()
    got = [x.detach().float().numpy()
           for x in (out, lse, *(t.grad for t in qkv))]
    for label, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=FLASH_TOL[dtype], rtol=0,
                                   err_msg=label)
    out_p, _, dq, dk, dv = got
    assert not out_p[1].any() and not dq[1].any()
    assert not dk[1].any() and not dv[1].any()


@pytest.mark.parametrize("d", [1, 12, 48, 100])
def test_flash_zero_padding_is_exact(d):
    """What the card's wrappers do for an uncompiled D: zero-pad q, k, v
    and dO to the next compiled dim and keep the original D's scale.
    Zero columns change no score, so the padded plain versions give the
    same out, lse and gradients, with zero padded columns."""
    q, k, v, mask, g_out, _ = (torch.tensor(x) for x in
                               _flash_inputs(d, seed=d + 1))
    dc = flash._compiled_d("test", d)
    assert dc == min(c for c in (16, 32, 64, 128) if c >= d)
    cfg = dict(causal=True, scale=d ** -0.5)
    out, lse = flash.flash_forward_plain(q, k, v, mask, **cfg)
    delta = (g_out * out).sum(-1).transpose(1, 2).contiguous()
    grads = flash.flash_backward_plain(q, k, v, mask, g_out, lse, delta,
                                       **cfg)
    pad = [flash._pad(x, dc) for x in (q, k, v, g_out)]
    out_p, lse_p = flash.flash_forward_plain(*pad[:3], mask, **cfg)
    grads_p = flash.flash_backward_plain(*pad[:3], mask, pad[3], lse_p,
                                         delta, **cfg)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=1e-6)
    for a, b in zip((out_p, *grads_p), (out, *grads)):
        torch.testing.assert_close(a[..., :d], b, rtol=0, atol=1e-6)
        assert not a[..., d:].any()


def test_head_dims_past_128_are_refused():
    """No head dim is refused any more: D = 288 is taken. The flash
    wrappers pad it to 512 (two column chunks of the D = 256 bodies),
    the decode geometry runs it on the CUDA-core split-K body at 256 in
    two chunks, and on the CPU B1 computes it through its plain version
    (no launch)."""
    assert flash._compiled_d("mlapi_flash_forward", 288) == 512
    geo = importlib.import_module(
        "mlapi_tpu_torch.ops.cuda.decode_attention")._geometry(
            "mlapi_decode_attention", torch.bfloat16, 2, 1, 4, 4, 64, 288,
            132)
    assert (geo.body, geo.d_chunks) == ("fma", 2)
    rng = np.random.default_rng(288)
    q = torch.as_tensor(rng.standard_normal((2, 1, 4, 288)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((2, 64, 4, 288)),
                            dtype=torch.float32) for _ in range(2))
    mask = torch.ones((2, 64), dtype=torch.bool)
    n0 = kern.decode_attention.launches
    out = kern.decode_attention(q, k, v, mask)
    assert kern.decode_attention.launches == n0
    assert out.shape == (2, 1, 4, 288) and bool(torch.isfinite(out).all())
