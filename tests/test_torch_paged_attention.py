"""Paged flash-decode (B3) and paged flash-extend (B4) of the port against
the JAX package's Pallas kernels (CPU).

On the CPU the port's wrappers run their plain PyTorch versions, which
gather ``pool[table]`` and run the split-K algorithm with one tile per
page (the Pallas paged tiling); the JAX kernels run in interpret mode,
as ``cached_attend`` runs them on the CPU. The grid is {f32, bf16, int8
(bf16 compute)} x {group 1, group 2} x page {8, 16}. Each call carries
three rows behind a shuffled page table whose unreached tiles map to
the null page (which holds finite garbage): a plain row, a row with
left pads, and a row whose first tile is all pads; the extend span of
one row starts mid-page and crosses a page. Inputs are numpy arrays
handed to both packages (int8 payloads quantized once); masks come
from the port's mask helpers, which ``tests/test_torch_gpt.py`` holds
equal to the JAX package's. Outputs agree on rows with a valid key to <=
1e-5 at f32 and <= 2e-2 at bf16 (the JAX package's own bounds). The
kernels against their plain versions, and against B1/B2 on the same
bytes, need a card: ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.ops.pallas import paged_decode_attention as jax_paged_decode
from mlapi_tpu.ops.pallas import paged_extend_attention as jax_paged_extend
from mlapi_tpu_torch.models.gpt import (
    decode_valid_and_shift,
    extend_positions_and_mask,
)
from mlapi_tpu_torch.ops import cuda as kern
from mlapi_tpu_torch.ops.quant import kv_quantize

B, NP, H, D, U, POOL = 3, 4, 2, 16, 5, 14
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
CDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.bfloat16}


def _decode_mask(page):
    length = NP * page
    rows = [(length * 5 // 8, 0), (length // 3, length // 10),
            (length - 1, page + 1)]
    return np.concatenate([
        decode_valid_and_shift(length, pos, torch.tensor([pad]))[0]
        [:, 0, 0, :].numpy()
        for pos, pad in rows
    ])


def _extend_mask(page):
    length = NP * page
    # The second span starts mid-page and crosses into the next page.
    rows = [(0, 0), (2 * page - 2, 3), (length - U, page + 1)]
    return np.concatenate([
        extend_positions_and_mask(length, U, pos0, torch.tensor([pad]))[1]
        [:, 0].numpy()
        for pos0, pad in rows
    ])


def _table(mask, page, rng):
    """Shuffled pool pages for every tile some query attends; the null
    page 0 for the rest."""
    live = mask.reshape(B, -1, NP, page).any(axis=(1, 3))   # [B, NP]
    ids = rng.permutation(POOL - 1)[: B * NP].reshape(B, NP) + 1
    return np.where(live, ids, 0).astype(np.int32)


def _inputs(u, kvh, fmt, page, mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, u, H, D)).astype(np.float32)
    pk = rng.standard_normal((POOL, page, kvh, D)).astype(np.float32)
    pv = rng.standard_normal((POOL, page, kvh, D)).astype(np.float32)
    table = _table(mask, page, rng)
    dt = CDT[fmt]
    qt = torch.as_tensor(q).to(dt)
    if fmt == "int8":
        # Quantized once (the port's kv_quantize is bit-exact with the
        # JAX package's); both packages get the same payload.
        kt, vt = (dict(zip(("q", "scale"), kv_quantize(torch.as_tensor(x))))
                  for x in (pk, pv))
    else:
        kt, vt = (torch.as_tensor(x).to(dt) for x in (pk, pv))
    return _to_jax((qt, kt, vt)), (qt, kt, vt), table


def _to_jax(tree):
    """Torch tensors → numpy (bf16 through ml_dtypes), which the jitted
    JAX kernels take as they are."""
    if isinstance(tree, dict):
        return {n: _to_jax(t) for n, t in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_jax(t) for t in tree)
    if tree.dtype == torch.bfloat16:
        return tree.float().numpy().astype(jnp.bfloat16)
    return tree.numpy()


def _compare(got, want, mask, fmt):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want).astype(np.float32)
    live = mask.reshape(B, -1, mask.shape[-1]).any(-1)       # [B, U]
    assert np.isfinite(got).all()
    err = np.abs(got - want)[live].max()
    assert err <= TOL[fmt], err
    assert not got[~live].any()   # rows with no valid key are exact zeros


GRID = pytest.mark.parametrize("page", [8, 16])
GROUPS = pytest.mark.parametrize("kvh", [H, H // 2], ids=["group1", "group2"])
FORMATS = pytest.mark.parametrize("fmt", ["f32", "bf16", "int8"])


@GRID
@GROUPS
@FORMATS
def test_paged_decode_plain_matches_pallas(fmt, kvh, page):
    mask = _decode_mask(page)
    (qj, kj, vj), (qt, kt, vt), table = _inputs(1, kvh, fmt, page, mask, 0)
    want = jax_paged_decode(qj, kj, vj, table, mask, interpret=True)
    got = kern.paged_decode_attention(qt, kt, vt, torch.as_tensor(table),
                                      torch.as_tensor(mask))
    _compare(got, want, mask, fmt)


@GRID
@GROUPS
@FORMATS
def test_paged_extend_plain_matches_pallas(fmt, kvh, page):
    mask = _extend_mask(page)
    (qj, kj, vj), (qt, kt, vt), table = _inputs(U, kvh, fmt, page, mask, 1)
    want = jax_paged_extend(qj, kj, vj, table, mask, interpret=True)
    got = kern.paged_extend_attention(qt, kt, vt, torch.as_tensor(table),
                                      torch.as_tensor(mask))
    _compare(got, want, mask, fmt)


def test_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors run the plain versions and count no launch."""
    counts = [f.launches for f in (kern.paged_decode_attention,
                                   kern.paged_extend_attention)]
    for u, mask, fn, plain in (
        (1, _decode_mask(8), kern.paged_decode_attention,
         kern.paged_decode_attention_plain),
        (U, _extend_mask(8), kern.paged_extend_attention,
         kern.paged_extend_attention_plain),
    ):
        _, (qt, kt, vt), table = _inputs(u, H, "int8", 8, mask, 2)
        table, mask = torch.as_tensor(table), torch.as_tensor(mask)
        assert torch.equal(fn(qt, kt, vt, table, mask),
                           plain(qt, kt, vt, table, mask))
    assert counts == [f.launches for f in (kern.paged_decode_attention,
                                           kern.paged_extend_attention)]


@pytest.mark.parametrize(
    "name", ["paged_decode_attention", "paged_extend_attention"]
)
def test_non_cpu_tensors_never_reach_the_plain_version(name):
    """A tensor that is not on the CPU goes to the kernel or raises: on
    the meta device the launch path refuses it, and nothing counts."""
    u = 1 if name == "paged_decode_attention" else U
    q = torch.empty((B, u, H, 64), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((POOL, 16, H, 64), dtype=torch.bfloat16,
                       device="meta")
    table = torch.zeros((B, NP), dtype=torch.int32, device="meta")
    shape = (B, NP * 16) if u == 1 else (B, u, NP * 16)
    mask = torch.empty(shape, dtype=torch.bool, device="meta")
    fn = getattr(kern, name)
    n0 = fn.launches
    with pytest.raises(ValueError, match="on the card"):
        fn(q, pool, pool, table, mask)
    assert fn.launches == n0


def test_shape_format_and_table_checks():
    mask = _decode_mask(8)
    _, (qt, kt, vt), table = _inputs(1, H, "f32", 8, mask, 3)
    table, mask = torch.as_tensor(table), torch.as_tensor(mask)
    fn = kern.paged_decode_attention
    with pytest.raises(ValueError, match="virtual layout"):
        fn(qt, kt, vt, table, mask[:, :-1])
    with pytest.raises(ValueError, match="int32"):
        fn(qt, kt, vt, table.long(), mask)
    with pytest.raises(ValueError, match=r"\[B=3, NP\]"):
        fn(qt, kt, vt, table[:2], mask)
    with pytest.raises(ValueError, match="one cache format"):
        fn(qt, {"q": kt.to(torch.int8), "scale": kt[..., :1]}, vt, table,
           mask)
    with pytest.raises(ValueError, match="one query per row"):
        fn(qt.expand(B, 2, H, D), kt, vt, table, mask)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fn(torch.zeros((B, 1, H + 1, D)), kt, vt, table, mask)
    # Page ids are trusted by the kernel; the plain version checks them.
    bad = table.clone()
    bad[1, 0] = POOL
    with pytest.raises(IndexError, match="out of range"):
        fn(qt, kt, vt, bad, mask)
    bad[1, 0] = -1
    with pytest.raises(IndexError, match="out of range"):
        kern.paged_extend_attention_plain(
            qt, kt, vt, bad, mask[:, None, :].expand(B, 1, NP * 8)
        )
