"""Parity of the port's flash attention (B5 forward, B6/B7 backward)
with the JAX package's Pallas kernels.

The same numpy inputs go through ``mlapi_tpu.ops.pallas
.flash_attention_with_lse`` in interpret mode (the Pallas kernels,
differentiated through their custom VJP with a cotangent on both
``out`` and ``lse``) and through the port's autograd Function, whose
wrappers run the plain versions for these CPU tensors. Bounds: 1e-5 at
f32, 2e-2 at bf16 (the reference's own kernel-vs-oracle bounds), and
exact zeros on rows and keys that nothing attends. The card's kernels
are held against the same plain versions in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.ops.pallas import flash_attention_with_lse as jax_flash
from mlapi_tpu_torch.ops.quant import kv_quantize

# The module (the package exports its function of the same name).
port = importlib.import_module("mlapi_tpu_torch.ops.cuda.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, L, D = 2, 64, 16

# (name, H, KVH, causal, window, ragged key mask with a dead batch row)
CASES = [
    ("mask", 4, 4, False, None, True),
    ("causal", 4, 4, True, None, False),
    ("gqa", 4, 2, False, None, True),
    ("window", 4, 2, True, 24, False),
]


def _inputs(h, kvh, ragged, seed, lq=L):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, lq, h, D)).astype(np.float32)
    k = rng.standard_normal((B, L, kvh, D)).astype(np.float32)
    v = rng.standard_normal((B, L, kvh, D)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    if ragged:
        mask[0, 37:] = 0.0
        mask[1] = 0.0                     # a batch row with no valid key
    g_out = rng.standard_normal((B, lq, h, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, h, lq)).astype(np.float32)
    return q, k, v, mask, g_out, g_lse


def _jax(q, k, v, mask, g_out, g_lse, dtype, causal, window):
    cast = [jnp.asarray(x, dtype) for x in (q, k, v)]

    def f(q, k, v):
        out, lse = jax_flash(q, k, v, jnp.asarray(mask), causal=causal,
                             window=window, interpret=True)
        loss = (jnp.sum(out.astype(jnp.float32) * g_out)
                + jnp.sum(lse * g_lse))
        return loss, (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True
    )(*cast)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, lse, *grads)]


def _port(q, k, v, mask, g_out, g_lse, dtype, causal, window):
    dt = getattr(torch, dtype)
    qkv = [torch.tensor(x).to(dt).requires_grad_() for x in (q, k, v)]
    out, lse = port.flash_attention_with_lse(
        *qkv, torch.tensor(mask), causal=causal, window=window
    )
    loss = ((out.float() * torch.tensor(g_out)).sum()
            + (lse * torch.tensor(g_lse)).sum())
    loss.backward()
    return [x.detach().float().numpy()
            for x in (out, lse, *(t.grad for t in qkv))]


# Every case at f32; the masked case (sst2-bert's) at bf16 too.
RUNS = [(*c, "float32") for c in CASES] + [(*CASES[0], "bfloat16")]


@pytest.mark.parametrize("name,h,kvh,causal,window,ragged,dtype", RUNS,
                         ids=[f"{r[0]}-{r[-1]}" for r in RUNS])
def test_forward_and_gradients_match_pallas(name, h, kvh, causal, window,
                                            ragged, dtype):
    args = _inputs(h, kvh, ragged, seed=len(name))
    want = _jax(*args, dtype, causal, window)
    got = _port(*args, dtype, causal, window)
    for label, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=TOL[dtype], rtol=0,
                                   err_msg=label)
    if ragged:
        out, _, dq, dk, dv = got
        # Batch row 1 has no valid key: zero output and zero gradients;
        # masked keys of row 0 get no dk/dv.
        assert not out[1].any() and not dq[1].any()
        assert not dk[1].any() and not dv[1].any()
        assert not dk[0, 37:].any() and not dv[0, 37:].any()


@pytest.mark.parametrize("kwargs,qshape,kshape,match", [
    (dict(causal=True), (B, 32, 4, D), (B, L, 4, D), "aligned q/k"),
    (dict(window=8), (B, L, 4, D), (B, L, 4, D), "window requires"),
    (dict(causal=True, window=0), (B, L, 4, D), (B, L, 4, D),
     "window requires"),
    (dict(), (B, L, 6, D), (B, L, 4, D), "multiple of kv heads"),
])
def test_prepare_errors_match_jax(kwargs, qshape, kshape, match):
    q, k = np.zeros(qshape, np.float32), np.zeros(kshape, np.float32)
    with pytest.raises(ValueError, match=match):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                  interpret=True, **kwargs)
    with pytest.raises(ValueError, match=match):
        port.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(k), **kwargs)


def test_kv_head_mismatch_and_head_dim_refused():
    q = torch.zeros(B, L, 4, D)
    k = torch.zeros(B, L, 4, D)
    with pytest.raises(ValueError, match="head counts disagree"):
        port.flash_attention(q, k, torch.zeros(B, L, 2, D))
    # Every head dim is taken: D = 288 is zero-padded to 512, which the
    # card's launcher accepts (two column chunks of the D = 256 bodies;
    # here it stops only at the device check), and on the CPU the padded
    # plain version gives the unpadded one's output.
    rng = np.random.default_rng(288)
    wide = [torch.tensor(rng.standard_normal((B, L, 4, 288)),
                         dtype=torch.float32) for _ in range(3)]
    assert port._compiled_d("mlapi_flash_forward", 288) == 512
    padded = [port._pad(x, 512) for x in wide]
    with pytest.raises(ValueError, match="every operand must be on the card"):
        port._launch("mlapi_flash_forward", *padded, torch.ones(B, L), False,
                     288 ** -0.5, None, [])
    out = port.flash_attention(*wide, causal=True)
    want, _ = port.flash_forward_plain(*padded, torch.ones(B, L), causal=True,
                                       scale=288 ** -0.5)
    assert out.shape == (B, L, 4, 288)
    torch.testing.assert_close(out, want[..., :288], rtol=0, atol=1e-6)
    assert not want[..., 288:].any()


def test_int8_kv_dequantizes_at_entry():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((B, L, 4, D)),
                            dtype=torch.float32) for _ in range(3))
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    got = port.flash_attention(q, {"q": kq, "scale": ks},
                               {"q": vq, "scale": vs}, causal=True)
    want = port.flash_attention(q, kq.float() * ks, vq.float() * vs,
                                causal=True)
    assert torch.equal(got, want)
