"""The port's KV-cache formats against the JAX package's (CPU).

``mlapi_tpu_torch/ops/quant.py`` must reproduce ``mlapi_tpu/ops/quant.py``
bit for bit: the int8 payload and the f32 scales of a quantized block,
the dequantized values, and what an append writes where — for a scalar
slot and for per-row slots. Inputs come from a numpy seed and go
through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.ops import quant as jq
from mlapi_tpu_torch.ops import quant as tq

B, L, H, D = 3, 12, 2, 8


def _block(seed, shape, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    x[0, 0, 0] = 0.0          # an all-zero head vector: scale must be 1
    x[0, -1, -1, :3] = 0.5    # repeated values: rounding ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact(dtype):
    x = _block(0, (B, 4, H, D)) * 3.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    qj, sj = jq.kv_quantize(xj)
    qt, st = tq.kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0, 0, 0, 0]) == 1.0
    deq_j = np.asarray(jq.kv_dequantize(qj, sj, jnp.float32))
    deq_t = tq.kv_dequantize(qt, st, torch.float32).numpy()
    np.testing.assert_array_equal(deq_t, deq_j)


def _layers(kv_quant):
    jl = jq.init_kv_cache(B, L, H, D, jnp.float32, kv_quant)
    tl = tq.init_kv_cache(B, L, H, D, torch.float32, kv_quant)
    assert set(jl) == set(tl)
    return jl, tl


def _assert_layers_equal(jl, tl):
    for name in jl:
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_append_and_read(kv_quant, per_row):
    """Two appends (a 4-token block, then a 1-token step) land where the
    JAX append puts them, in place, and read back identically."""
    jl, tl = _layers(kv_quant)
    blk = _block(1, (B, 4, H, D))
    step = _block(2, (B, 1, H, D))
    if per_row:
        pos_a, pos_b = np.array([0, 3, 8]), np.array([4, 7, 11])
        ja, jb = jnp.asarray(pos_a), jnp.asarray(pos_b)
        ta, tb = torch.as_tensor(pos_a), torch.as_tensor(pos_b)
    else:
        ja, jb, ta, tb = 2, 6, 2, 6
    jl = jq.kv_cache_append(jl, jnp.asarray(blk), jnp.asarray(blk), ja,
                            jnp.float32)
    jl = jq.kv_cache_append(jl, jnp.asarray(step), jnp.asarray(step), jb,
                            jnp.float32)
    buf = next(iter(tl.values()))
    out = tq.kv_cache_append(tl, torch.as_tensor(blk), torch.as_tensor(blk),
                             ta, torch.float32)
    out = tq.kv_cache_append(out, torch.as_tensor(step),
                             torch.as_tensor(step), tb, torch.float32)
    assert out is tl and next(iter(out.values())) is buf  # in place
    _assert_layers_equal(jl, tl)
    kj, vj = jq.kv_cache_kv(jl, jnp.float32)
    kt, vt = tq.kv_cache_kv(tl, torch.float32)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    cache_j, cache_t = {"layer_0": jl}, {"layer_0": tl}
    assert tq.kv_cache_seq_len(cache_t) == jq.kv_cache_seq_len(cache_j) == L
    assert tq.kv_tree_bytes(cache_t) == jq.kv_tree_bytes(cache_j)


def test_append_clamps_like_dynamic_update_slice():
    """A block that would run past the end starts earlier, as
    ``lax.dynamic_update_slice`` clamps it."""
    jl, tl = _layers("none")
    blk = _block(3, (B, 4, H, D))
    jl = jq.kv_cache_append(jl, jnp.asarray(blk), jnp.asarray(blk), L - 2,
                            jnp.float32)
    tq.kv_cache_append(tl, torch.as_tensor(blk), torch.as_tensor(blk),
                       L - 2, torch.float32)
    _assert_layers_equal(jl, tl)


def test_maybe_dequant_kv():
    x = _block(4, (B, 4, H, D))
    qt, st = tq.kv_quantize(torch.as_tensor(x))
    qj, sj = jq.kv_quantize(jnp.asarray(x))
    got = tq.maybe_dequant_kv({"q": qt, "scale": st})
    want = jq.maybe_dequant_kv({"q": qj, "scale": sj})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = torch.as_tensor(x)
    assert tq.maybe_dequant_kv(plain) is plain
    with pytest.raises(TypeError):
        tq.maybe_dequant_kv({"q": qt})
