"""The port's page pool and paged KV seams against the JAX package (CPU).

- ``PagePool``: alloc/free round trip, shared-page accounting, a double
  release that fails loudly, and exhaustion (real or injected at the
  ``pool_alloc`` seam) that leaves the pool consistent — the contract of
  ``tests/test_paged_kv.py``'s pool tests.
- ``kv_page_bytes`` equals the JAX package's for both cache formats,
  GPT-2 small's widths included.
- A paged append (scalar slot across a page edge, per-row slots, a
  block that spans pages) followed by the ``kv_cache_kv`` gather gives
  the JAX seams' bytes exactly: int8 payloads and scales bit for bit.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.ops import quant as jq
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.ops import quant as tq
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.paged_pool import PagePool, PagePoolExhausted

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
GPT2_SMALL = dict(num_layers=12, num_heads=12, hidden_size=768,
                  vocab_size=50257, max_positions=1024,
                  compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def model():
    return GptLM(**CFG, seed=None, device="cpu")


def test_pool_alloc_free_roundtrip(model):
    pool = PagePool(model, page_size=8, num_pages=9)
    assert pool.pages_total == 8  # page 0 is the null page, not capacity
    assert pool.layers["layer_0"]["k"].shape == (9, 8, 4, 8)
    a = pool.alloc(3)
    assert 0 not in a and len(set(a.tolist())) == 3
    assert pool.pages_in_use == 3 and pool.pages_shared == 0
    pool.retain(a)  # a second holder
    assert pool.pages_shared == 3 and pool.is_shared(int(a[0]))
    pool.release(a)
    assert pool.pages_in_use == 3 and pool.pages_shared == 0
    pool.release(a)
    assert pool.pages_in_use == 0
    b = pool.alloc(8)  # freed pages come back; the whole pool round-trips
    assert pool.pages_in_use == 8 and pool.utilization == 1.0
    pool.release(np.concatenate([b, [0, 0]]))  # null entries are ignored
    assert pool.pages_in_use == 0


def test_pool_double_release_is_loud(model):
    pool = PagePool(model, page_size=8, num_pages=4)
    a = pool.alloc(1)
    pool.release(a)
    with pytest.raises(AssertionError, match="below zero"):
        pool.release(a)


def test_pool_exhaustion_leaves_the_pool_consistent(model):
    pool = PagePool(model, page_size=8, num_pages=4)
    held = pool.alloc(2)
    with pytest.raises(PagePoolExhausted, match="kv-pages"):
        pool.alloc(2)
    assert pool.exhaustions == 1 and pool.pages_in_use == 2
    # The injected fault fires before the free list changes.
    with faults.active("pool_alloc:raise"):
        with pytest.raises(PagePoolExhausted, match="injected"):
            pool.alloc(1)
        assert faults.injected_count() == 1
    assert pool.pages_in_use == 2
    last = pool.alloc(1)  # what fits still allocates
    pool.release(np.concatenate([held, last]))
    assert pool.pages_in_use == 0
    with pytest.raises(ValueError, match="kv_pages"):
        PagePool(model, page_size=8, num_pages=1)


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_page_bytes_equal_the_jax_package(model, fmt):
    model.configure(kv_quant=fmt)
    jax_small = JaxGpt(**CFG, kv_quant=fmt)
    for page in (8, 16):
        assert tq.kv_page_bytes(model, page) == jq.kv_page_bytes(
            jax_small, page
        )
        assert PagePool(model, page_size=page,
                        num_pages=2).page_bytes == tq.kv_page_bytes(model,
                                                                    page)
    # GPT-2 small, 16-token page: 12 layers x 2 x 16 x 12 heads x 64 x 2 B
    # (bf16) = 589,824 B; int8 payload + f32 scales = 313,344 B.
    # A stand-in with GPT-2 small's cache fields and GptLM's own
    # init_cache (the page bytes come from the model's cache shapes).
    big = types.SimpleNamespace(num_layers=12, kv_heads=12, head_dim=64,
                                cdt=torch.bfloat16, kv_quant=fmt)
    big.init_cache = functools.partial(GptLM.init_cache, big)
    want = {"none": 589_824, "int8": 313_344}[fmt]
    assert tq.kv_page_bytes(big, 16) == want
    assert jq.kv_page_bytes(JaxGpt(**GPT2_SMALL, kv_quant=fmt), 16) == want
    model.configure(kv_quant="none")


def _jax_seams(pools, table, blocks):
    """The JAX package's paged append of every block, then its gather,
    run op by op as its own tests run them (under ``jit`` XLA may
    rewrite ``amax / 127`` and move a scale by one ulp)."""
    layer = {**{n: jnp.asarray(a) for n, a in pools.items()},
             "table": jnp.asarray(table)}
    for k, v, pos in blocks:
        layer = jq.kv_cache_append(layer, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), jnp.float32)
    raw = {n: a for n, a in layer.items() if n != "table"}
    return raw, jq.kv_cache_kv(layer, jnp.float32)


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_paged_append_and_gather_match_the_jax_seams(model, fmt):
    model.configure(kv_quant=fmt)
    page, npv, b = 8, 4, 2
    pools = tq.make_paged_pools(model, 10, page)["layer_0"]
    table = np.array([[3, 1, 7, 0], [5, 9, 2, 8]], np.int32)
    rng = np.random.default_rng(0)

    def block(u):
        return rng.standard_normal((b, u, 4, 8)).astype(np.float32)

    blocks = [
        (block(3), block(3), 6),                           # across a page edge
        (block(3), block(3), np.array([9, 21], np.int32)),  # per-row slots
        (block(3), block(3), np.array([14, 2], np.int32)),  # spans pages
    ]
    layer = tq.paged_cache_tree({"layer_0": pools}, table)["layer_0"]
    for k, v, pos in blocks:
        p = torch.as_tensor(pos) if isinstance(pos, np.ndarray) else pos
        tq.kv_cache_append(layer, torch.as_tensor(k), torch.as_tensor(v), p,
                           torch.float32)
    got_kv = tq.kv_cache_kv(layer, torch.float32)
    jpools = {n: np.zeros(t.shape, t.numpy().dtype) for n, t in pools.items()}
    raw, want_kv = _jax_seams(jpools, table, blocks)
    for name, t in pools.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(raw[name]),
                                      err_msg=name)
    for got, want in zip(got_kv, want_kv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.kv_cache_seq_len({"layer_0": layer}) == npv * page
    assert tq.paged_pools_of({"layer_0": layer})["layer_0"].keys() == (
        pools.keys()
    )
    model.configure(kv_quant="none")
