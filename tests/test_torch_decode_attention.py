"""Flash-decode (B1) and flash-extend (B2) of the port against the JAX
package's Pallas kernels (CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the
JAX kernels run in interpret mode, as ``cached_attend`` runs them on
the CPU. The grid is {MHA, GQA} x {f32, bf16} x {none, int8}; each call
carries three batch rows with the three mask layouts the serving path
builds (plain, ragged left pads, a shared-prefix region with a pad
hole), made by the JAX package's own mask helpers. Outputs agree on
rows with at least one valid key to <= 1e-5 at f32 and <= 2e-2 at bf16
(the JAX package's own bounds for these kernels). The comparison of
each CUDA kernel with its plain version needs a card and lives in
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models.gpt import (
    decode_valid_and_shift,
    extend_positions_and_mask,
)
from mlapi_tpu.ops.pallas import decode_attention as jax_decode
from mlapi_tpu.ops.pallas import extend_attention as jax_extend
from mlapi_tpu.ops.quant import kv_quantize as jax_kv_quantize
from mlapi_tpu_torch.ops import cuda as kern

B, L, H, D, U, BLOCK = 3, 64, 4, 16, 4, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _decode_mask():
    rows = [
        decode_valid_and_shift(L, 10, jnp.asarray([0]))[0],
        decode_valid_and_shift(L, 33, jnp.asarray([7]))[0],
        decode_valid_and_shift(L, 55, jnp.asarray([5]), jnp.int32(16),
                               jnp.int32(4))[0],
    ]
    return np.concatenate([np.asarray(r)[:, 0, 0, :] for r in rows])


def _extend_mask():
    rows = [
        extend_positions_and_mask(L, U, 0, jnp.asarray([0]))[1],
        extend_positions_and_mask(L, U, 30, jnp.asarray([7]))[1],
        extend_positions_and_mask(L, U, 52, jnp.asarray([5]),
                                  jnp.int32(16), jnp.int32(4))[1],
    ]
    return np.concatenate([np.asarray(r)[:, 0] for r in rows])


def _inputs(u, kvh, dtype, fmt, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, u, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, kvh, D)).astype(np.float32)
    v = rng.standard_normal((B, L, kvh, D)).astype(np.float32)
    qj = jnp.asarray(q).astype(dtype)
    qt = torch.as_tensor(q).to(getattr(torch, dtype))
    if fmt == "int8":
        # Quantize once (JAX) and hand both packages the same payload.
        kq, ks = jax_kv_quantize(jnp.asarray(k))
        vq, vs = jax_kv_quantize(jnp.asarray(v))
        kj = {"q": kq, "scale": ks}
        vj = {"q": vq, "scale": vs}
        kt = {"q": torch.as_tensor(np.asarray(kq)),
              "scale": torch.as_tensor(np.asarray(ks))}
        vt = {"q": torch.as_tensor(np.asarray(vq)),
              "scale": torch.as_tensor(np.asarray(vs))}
    else:
        kj, vj = jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype)
        kt = torch.as_tensor(k).to(getattr(torch, dtype))
        vt = torch.as_tensor(v).to(getattr(torch, dtype))
    return (qj, kj, vj), (qt, kt, vt)


def _compare(got, want, mask, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    live = mask.reshape(B, -1, L).any(-1)            # [B, U] rows
    assert np.isfinite(got).all()
    err = np.abs(got - want)[live].max()
    assert err <= TOL[dtype], err
    # Rows with no valid key are exact zeros in both.
    assert not got[~live].any()


@pytest.mark.parametrize("kvh", [H, H // 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_decode_plain_matches_pallas(kvh, dtype, fmt):
    (qj, kj, vj), (qt, kt, vt) = _inputs(1, kvh, dtype, fmt)
    mask = _decode_mask()
    want = jax_decode(qj, kj, vj, jnp.asarray(mask), block_k=BLOCK,
                      interpret=True)
    got = kern.decode_attention_plain(qt, kt, vt, torch.as_tensor(mask),
                                      block_k=BLOCK)
    _compare(got, want, mask, dtype)


@pytest.mark.parametrize("kvh", [H, H // 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_extend_plain_matches_pallas(kvh, dtype, fmt):
    (qj, kj, vj), (qt, kt, vt) = _inputs(U, kvh, dtype, fmt, seed=1)
    mask = _extend_mask()
    want = jax_extend(qj, kj, vj, jnp.asarray(mask), block_k=BLOCK,
                      interpret=True)
    got = kern.extend_attention_plain(qt, kt, vt, torch.as_tensor(mask),
                                      block_k=BLOCK)
    _compare(got, want, mask, dtype)


def test_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors run the plain version (default tiling) and count no
    kernel launch."""
    (_, _, _), (qt, kt, vt) = _inputs(1, H, "float32", "int8")
    mask = torch.as_tensor(_decode_mask())
    n0 = kern.decode_attention.launches
    got = kern.decode_attention(qt, kt, vt, mask)
    torch.testing.assert_close(
        got, kern.decode_attention_plain(qt, kt, vt, mask), rtol=0, atol=0
    )
    (_, _, _), (qe, ke, ve) = _inputs(U, H, "float32", "none")
    emask = torch.as_tensor(_extend_mask())
    e0 = kern.extend_attention.launches
    got = kern.extend_attention(qe, ke, ve, emask)
    torch.testing.assert_close(
        got, kern.extend_attention_plain(qe, ke, ve, emask), rtol=0, atol=0
    )
    assert kern.decode_attention.launches == n0
    assert kern.extend_attention.launches == e0


@pytest.mark.parametrize("name", ["decode_attention", "extend_attention"])
def test_non_cpu_tensors_never_reach_the_plain_version(name):
    """A tensor that is not on the CPU goes to the kernel or raises: on
    the meta device the launch path refuses it, and nothing counts."""
    u = 1 if name == "decode_attention" else U
    q = torch.empty((B, u, H, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, L, H, 64), dtype=torch.bfloat16, device="meta")
    mask = torch.empty((B, L) if u == 1 else (B, u, L), dtype=torch.bool,
                       device="meta")
    fn = getattr(kern, name)
    n0 = fn.launches
    with pytest.raises(ValueError, match="on the card"):
        fn(q, k, k, mask)
    assert fn.launches == n0


@pytest.mark.parametrize("name", ["decode_attention", "extend_attention"])
def test_shape_checks(name):
    (_, _, _), (qt, kt, vt) = _inputs(1 if name == "decode_attention" else U,
                                      H, "float32", "none")
    fn = getattr(kern, name)
    with pytest.raises(ValueError, match="mask"):
        fn(qt, kt, vt, torch.ones((B, 1, L + 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="one cache format"):
        fn(qt, {"q": kt.to(torch.int8), "scale": kt[..., :1]}, vt,
           torch.ones((B, L), dtype=torch.bool))
