"""The port's GptLM against the JAX package's (CPU, float32).

One parameter tree drawn from a numpy seed goes into both packages
(``params_from_jax`` carries it into the port). At a tiny config
(vocab 260, hidden 32, 2 layers, 4 heads, 160 positions) the port must
reproduce the JAX model's logits for ``apply``, ``prefill_core``,
``decode_step`` and ``extend_core`` to <= 1e-4, and its greedy
``generate`` streams token for token for every cache format x
cache-read attention. Sampled tokens are not compared (they ride JAX's
PRNG); the top-k/top-p filter is, on the filtered probabilities.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.checkpoint.io import tree_signature as jax_tree_signature
from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.gpt import _filter_top_k_top_p as jax_filter
from mlapi_tpu.ops.attention import full_attention as jax_full_attention
from mlapi_tpu_torch.checkpoint import params_from_jax, tree_signature
from mlapi_tpu_torch.models.gpt import GptLM, _filter_top_k_top_p, _pick_token
from mlapi_tpu_torch.ops.attention import full_attention

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
TOL = 1e-4


def _np_params(seed=0):
    """The JAX param tree's shapes, values from a numpy seed (wider than
    the 0.02 init, so greedy streams are not one repeated token)."""
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        std = 0.3 if "kernel" in name or "wte" in name else 0.05
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    np_params = _np_params()
    jax_params = jax.tree.map(jnp.asarray, np_params)
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return JaxGpt(**CFG), jax_params, model, np_params


def _ids(shape, seed=1):
    return np.random.default_rng(seed).integers(4, 260, shape).astype(
        np.int32)


def test_params_from_jax_round_trip(pair):
    _, jax_params, model, np_params = pair
    sd = model.state_dict()
    flat = {
        jax.tree_util.keystr(p).replace("']['", ".").strip("[']"): leaf
        for p, leaf in jax.tree_util.tree_leaves_with_path(np_params)
    }
    assert set(sd) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(sd[key].numpy(), arr)
    assert tree_signature(model) == jax_tree_signature(jax_params)


def test_full_attention_matches(pair):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 6), np.float32)
    mask[1, :] = 0.0            # a row with every key masked → zeros
    mask[0, :2] = 0.0
    want = np.asarray(jax_full_attention(*map(jnp.asarray, (q, k, v)),
                                         mask=jnp.asarray(mask), causal=True))
    got = full_attention(*map(torch.as_tensor, (q, k, v)),
                         mask=torch.as_tensor(mask), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not got[1].any()


def test_apply_logits(pair):
    jm, jp, model, _ = pair
    ids = _ids((2, 12))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)))
    got = model.apply(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_cached_paths_logits(pair, impl):
    """prefill_core → decode_step → extend_core, left pads included, on
    an int8 cache: logits at every stage, and the caches themselves."""
    jm, jp, model, _ = pair
    jm = dataclasses.replace(jm, kv_quant="int8", decode_attn_impl=impl)
    model.configure(kv_quant="int8", decode_attn_impl=impl)
    try:
        ids = _ids((2, 10))
        n_pad = np.array([0, 4])
        total = 24
        # One jit per JAX stage: eager JAX would compile op by op.
        jc, jl = jax.jit(lambda p, i, n: jm.prefill_core(p, i, n, total))(
            jp, jnp.asarray(ids), jnp.asarray(n_pad))
        tc, tl = model.prefill_core(torch.as_tensor(ids).long(),
                                    torch.as_tensor(n_pad), total)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        step = _ids((2, 1), seed=3)
        jl, jc = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(step),
                                         jnp.int32(10), jnp.asarray(n_pad))
        tl, tc = model.decode_step(tc, torch.as_tensor(step).long(), 10,
                                   torch.as_tensor(n_pad))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        span = _ids((2, 3), seed=4)
        jc, jl = jax.jit(
            lambda p, c, s, n: jm.extend_core(
                p, c, s, jnp.int32(11), n, jnp.int32(0), jnp.int32(0),
                all_logits=True,
            )
        )(jp, jc, jnp.asarray(span), jnp.asarray(n_pad))
        tc, tl = model.extend_core(tc, torch.as_tensor(span).long(), 11,
                                   torch.as_tensor(n_pad), all_logits=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        for n in range(CFG["num_layers"]):
            np.testing.assert_array_equal(
                tc[f"layer_{n}"]["k_q"].numpy(),
                np.asarray(jc[f"layer_{n}"]["k_q"]),
            )
    finally:
        model.configure(kv_quant="none", decode_attn_impl="einsum")


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_greedy_generate_token_identical(pair, kv_quant, impl):
    jm, jp, model, _ = pair
    jm = dataclasses.replace(jm, kv_quant=kv_quant, decode_attn_impl=impl)
    model.configure(kv_quant=kv_quant, decode_attn_impl=impl)
    try:
        ids = _ids((3, 9), seed=5)
        pads = np.array([0, 2, 5])
        ids[1, :2] = 0
        ids[2, :5] = 0
        want = np.asarray(jm.generate(jp, jnp.asarray(ids), max_new_tokens=12,
                                      pad_lens=jnp.asarray(pads)))
        got = model.generate(torch.as_tensor(ids).long(), max_new_tokens=12,
                             pad_lens=pads).numpy()
    finally:
        model.configure(kv_quant="none", decode_attn_impl="einsum")
    np.testing.assert_array_equal(got, want)
    assert len(set(want.ravel().tolist())) > 3   # a real stream


@pytest.mark.parametrize(
    "pos,prefix_len,prefix_lo",
    [(30, 0, 0), (30, 16, 4), ([20, 33, 41], 16, [0, 4, 16])],
    ids=["plain", "prefix", "per_row"],
)
def test_mask_helpers_match(pos, prefix_len, prefix_lo):
    """decode_valid_and_shift / extend_positions_and_mask: scalar and
    per-row slots, with and without a shared-prefix region."""
    from mlapi_tpu.models.gpt import (
        decode_valid_and_shift as jax_valid,
        extend_positions_and_mask as jax_extend_mask,
    )
    from mlapi_tpu_torch.models.gpt import (
        decode_valid_and_shift,
        extend_positions_and_mask,
    )

    n_pad = np.array([0, 3, 7])

    def j(x):
        return jnp.asarray(x) if isinstance(x, list) else x

    def t(x):
        return torch.as_tensor(x) if isinstance(x, (list, np.ndarray)) \
            else x

    jp, jn = j(pos), jnp.asarray(n_pad)
    tp, tn = t(pos), torch.as_tensor(n_pad)
    for got, want in (
        (decode_valid_and_shift(48, tp, tn, prefix_len, t(prefix_lo)),
         jax_valid(48, jp, jn, prefix_len, j(prefix_lo))),
        (extend_positions_and_mask(48, 4, tp, tn, prefix_len, t(prefix_lo)),
         jax_extend_mask(48, 4, jp, jn, prefix_len, j(prefix_lo))),
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_filter_top_k_top_p_matches():
    rng = np.random.default_rng(6)
    logits = (3.0 * rng.standard_normal((5, 40))).astype(np.float32)
    logits[4, :3] = logits[4, 3]          # ties at the kth logit
    top_k = np.array([0, 5, 0, 7, 4], np.int32)
    top_p = np.array([1.0, 1.0, 0.6, 0.8, 0.5], np.float32)
    want = np.asarray(jax.jit(lambda *a: jax.nn.softmax(jax_filter(*a)))(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = torch.softmax(_filter_top_k_top_p(
        torch.as_tensor(logits), torch.as_tensor(top_k),
        torch.as_tensor(top_p)), dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0).sum(-1) <= np.where(top_k > 0, top_k, 40)).all()


def test_pick_token_greedy_and_row_streams():
    """Greedy rows take the argmax; a sampled row's draw depends on its
    own seed and token index only, not on its batch slot."""
    rng = np.random.default_rng(7)
    logits = torch.as_tensor(rng.standard_normal((3, 50)).astype(np.float32))
    temps = np.array([0.0, 0.9, 0.9], np.float32)
    seeds = np.array([1, 11, 22])
    got = _pick_token(temps, logits, seeds, np.array([0, 4, 9]))
    assert int(got[0]) == int(torch.argmax(logits[0]))
    swapped = _pick_token(temps[[0, 2, 1]], logits[[0, 2, 1]], seeds[[0, 2, 1]],
                          np.array([0, 9, 4]))
    assert swapped.tolist() == got[[0, 2, 1]].tolist()
