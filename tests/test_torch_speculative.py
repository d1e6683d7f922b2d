"""The port's speculative-decoding ops on the CPU, against the JAX package.

Tiny float32 models, their weights drawn from numpy seeds and carried by
``params_from_jax``: a GPT (byte vocabulary, hidden 32, 2 layers, 4
heads) with a draft of the same shape whose weights are the target's
plus N(0, 0.02) noise, and one GQA Llama (4 query heads on 2 KV heads).
On the CPU the port runs its kernels' plain versions; the JAX side runs
its default einsum cache reads, except one verify block through
``extend_attention`` in Pallas interpret mode.

- ``realign_fn`` / ``paged_realign_fn``: exactly JAX's caches, int8
  payloads and scales included, with deltas that are and are not page
  multiples (the paged pools compared off the null page, which both
  write in an undefined order and nothing reads).
- Greedy ``speculative_generate`` and ``_batched`` at k in {1, 3}:
  exactly JAX's plain greedy stream; with draft == target every
  proposal is accepted, k + 1 tokens a round.
- ``_accept_and_draw`` fed the reference's own uniforms (re-derived
  here with ``jax.random``): ``m`` exactly JAX's, the normalised
  residual within 1e-6.
- Sampled ``speculative_sample`` over many seeds at a 32-token vocabulary:
  the second token's marginal within the total-variation bound of
  ``tests/test_speculative_sampling.py`` (0.2) of the exact target
  marginal, the token drawn inside a round.
- One verify block at per-row positions: argmax and cache as JAX's
  flash (interpret-mode) verify.
- The role seeds never equal the plain draw's at the same token index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.gpt import paged_realign_fn as jax_paged_realign
from mlapi_tpu.models.gpt import realign_fn as jax_realign
from mlapi_tpu.models.llama import LlamaLM as JaxLlama
from mlapi_tpu.ops import speculative as jspec
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models.gpt import (
    GptLM,
    _stream_seed,
    paged_realign_fn,
    realign_fn,
)
from mlapi_tpu_torch.models.llama import LlamaLM
from mlapi_tpu_torch.ops import speculative as spec
from mlapi_tpu_torch.ops import (
    speculative_generate,
    speculative_generate_batched,
    speculative_sample,
)

GPT = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=96, compute_dtype="float32")
LLAMA = dict(GPT, num_kv_heads=2)
FAMILIES = {"gpt": (JaxGpt, GptLM, GPT), "llama": (JaxLlama, LlamaLM, LLAMA)}
N_NEW = 24


def _draw(family, seed, base=None, scale=0.3):
    jm = FAMILIES[family][0](**FAMILIES[family][2])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) >= 2:
            return (scale * rng.standard_normal(s.shape)).astype(np.float32)
        fill = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return np.full(s.shape, fill, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    if base is not None:
        tree = jax.tree.map(lambda b, n: b + n if n.ndim >= 2 else b,
                            base, tree)
    return tree


def _port(family, tree, **kw):
    model = FAMILIES[family][1](**{**FAMILIES[family][2], **kw}, seed=None,
                                device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.fixture(scope="module")
def pairs():
    """Per family: (JAX target, its params, port target, port draft)."""
    out = {}
    for family in FAMILIES:
        target = _draw(family, 0)
        draft = _draw(family, 1, base=target, scale=0.02)
        jm = FAMILIES[family][0](**FAMILIES[family][2])
        out[family] = (jm, jax.tree.map(jnp.asarray, target),
                       _port(family, target), _port(family, draft))
    return out


PROMPTS = np.asarray([[72, 101, 108, 108, 111, 32, 119],
                      [97, 98, 99, 97, 98, 99, 97],
                      [120, 121, 122, 32, 113, 32, 116]], np.int32)


@pytest.fixture(scope="module")
def jax_greedy(pairs):
    """JAX's plain greedy streams of each prompt, per family."""
    out = {}
    for family, (jm, jp, _, _) in pairs.items():
        out[family] = np.asarray(jm.generate(
            jp, jnp.asarray(PROMPTS), max_new_tokens=N_NEW)).tolist()
    return out


# -- realign -----------------------------------------------------------------

def _cache(fmt, b, length, rng, h=2, d=4):
    if fmt == "int8":
        return {"k_q": rng.integers(-127, 128, (b, length, h, d), np.int8),
                "k_scale": rng.random((b, length, h, 1), np.float32),
                "v_q": rng.integers(-127, 128, (b, length, h, d), np.int8),
                "v_scale": rng.random((b, length, h, 1), np.float32)}
    return {"k": rng.standard_normal((b, length, h, d), np.float32),
            "v": rng.standard_normal((b, length, h, d), np.float32)}


def _to_torch(tree):
    return {ln: {n: torch.as_tensor(np.array(a)) for n, a in layer.items()}
            for ln, layer in tree.items()}


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_realign_matches_jax(fmt):
    rng = np.random.default_rng(3)
    cache = {f"layer_{n}": _cache(fmt, 3, 24, rng) for n in range(2)}
    delta = np.asarray([0, 5, 16], np.int32)
    want = jax_realign()(jax.tree.map(jnp.asarray, cache),
                         jnp.asarray(delta))
    got = _to_torch(cache)
    assert realign_fn(got, delta) is got
    for ln in cache:
        for n in cache[ln]:
            np.testing.assert_array_equal(got[ln][n].numpy(),
                                          np.asarray(want[ln][n]))


@pytest.mark.parametrize("delta", [[0, 8, 4], [0, 5, 3]],
                         ids=["page-multiples", "sub-page"])
@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_paged_realign_matches_jax(fmt, delta):
    rng = np.random.default_rng(4)
    page, npv = 4, 5
    pools = {f"layer_{n}": _cache(fmt, 16, page, rng) for n in range(2)}
    # Rows own disjoint pages; a few tiles are unmapped (null page 0).
    table = np.asarray([[3, 7, 1, 0, 0], [9, 2, 11, 5, 0],
                        [4, 0, 13, 8, 6]], np.int32)
    cache = {ln: {**layer, "table": table} for ln, layer in pools.items()}
    delta = np.asarray(delta, np.int32)
    want = jax_paged_realign()(jax.tree.map(jnp.asarray, cache),
                               jnp.asarray(delta))
    got = _to_torch(cache)
    assert paged_realign_fn(got, delta) is got
    for ln in cache:
        for n in pools[ln]:
            np.testing.assert_array_equal(got[ln][n].numpy()[1:],
                                          np.asarray(want[ln][n])[1:])


# -- greedy streams -----------------------------------------------------------

@pytest.mark.parametrize("family,k", [("gpt", 1), ("gpt", 3),
                                      ("llama", 3)])
def test_greedy_streams_equal_jax_plain(pairs, jax_greedy, family, k):
    _, _, target, draft = pairs[family]
    want = jax_greedy[family]
    for i in range(len(PROMPTS)):
        got, stats = speculative_generate(
            target, draft, PROMPTS[i:i + 1], max_new_tokens=N_NEW, k=k)
        assert got == want[i], (family, k, i)
        assert stats.emitted + stats.fallback_steps == N_NEW - 1
    got, stats = speculative_generate_batched(
        target, draft, PROMPTS, max_new_tokens=N_NEW, k=k)
    assert got == want
    # A partial draft: some proposals accepted, not all.
    assert 0 < stats.accepted < stats.drafted


def test_draft_equal_to_target_accepts_everything(pairs, jax_greedy):
    _, _, target, _ = pairs["gpt"]
    got, stats = speculative_generate(target, target, PROMPTS[:1],
                                      max_new_tokens=N_NEW + 1, k=3)
    assert got == jax_greedy["gpt"][0] + got[N_NEW:]
    assert stats.accepted == stats.drafted == 6 * 3
    assert stats.tokens_per_round == 4.0
    got, stats = speculative_generate_batched(
        target, target, PROMPTS, max_new_tokens=N_NEW + 1, k=3)
    assert [g[:N_NEW] for g in got] == jax_greedy["gpt"]
    assert stats.accepted == stats.drafted


# -- acceptance-rejection ---------------------------------------------------

@pytest.mark.parametrize("usable", [4, 2, 0])
def test_accept_and_draw_matches_jax_uniforms(usable):
    k, v = 4, 16
    rng = np.random.default_rng(usable)
    for trial in range(6):
        pr = rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32)
        q = rng.dirichlet(np.full(v, 0.3), size=k).astype(np.float32)
        props = np.asarray([rng.choice(v, p=q[i] / q[i].sum())
                            for i in range(k)], np.int32)
        key = jax.random.key(100 + trial)
        step0 = 3 + trial
        m_want, _ = jspec._accept_and_draw(
            key, jnp.asarray(pr), jnp.asarray(q), jnp.asarray(props),
            jnp.int32(usable), jnp.int32(step0))
        m_want = int(m_want)
        # The reference's uniforms, re-derived: the ACC-tagged stream at
        # each proposal's own index.
        u_acc = np.asarray([
            jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(key, jspec._ACC_TAG), step0 + i))
            for i in range(k)], np.float32)
        m, final, dist = spec._accept_and_draw(
            torch.as_tensor(pr)[None], torch.as_tensor(q)[None],
            torch.as_tensor(props, dtype=torch.long)[None],
            torch.as_tensor([usable]), torch.as_tensor(u_acc)[None],
            torch.full((1, k + 1), 0.5))
        assert int(m[0]) == m_want, (usable, trial)
        qm = q[m_want] if m_want < k else np.zeros(v, np.float32)
        r = np.maximum(pr[m_want] - qm, 0.0) if m_want < usable \
            else pr[m_want]
        np.testing.assert_allclose(dist[0].numpy(), r / r.sum(), atol=1e-6)
        assert dist[0, int(final[0])] > 0


def _exact_marginal(target, prompt, temperature):
    """The exact marginal of the second token under plain sampling."""
    with torch.no_grad():
        seq = torch.as_tensor(prompt, dtype=torch.long)
        p0 = torch.softmax(target.apply(seq)[0, -1] / temperature, -1)
        v = p0.shape[0]
        rows = torch.cat([seq.expand(v, -1), torch.arange(v)[:, None]], 1)
        p1 = torch.softmax(target.apply(rows)[:, -1] / temperature, -1)
    return (p0[:, None] * p1).sum(0).numpy()


def test_sampled_marginal_within_tv_bound():
    cfg = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
               max_positions=64, compute_dtype="float32")
    target = GptLM(**cfg, seed=4, device="cpu")
    draft = GptLM(**dict(cfg, hidden_size=16, num_layers=1, num_heads=2),
                  seed=9, device="cpu")
    with torch.no_grad():
        for m in (target, draft):
            for p in m.parameters():
                if p.ndim >= 2:
                    p.mul_(40.0)  # spread the tiny models' distributions
    prompt = np.asarray([[5, 6, 7]], np.int32)
    temperature, n_runs = 1.2, 600
    counts = np.zeros(cfg["vocab_size"])
    rounds = 0
    for seed in range(n_runs):
        toks, stats = speculative_sample(
            target, draft, prompt, max_new_tokens=3, k=1,
            temperature=temperature, seed=seed)
        counts[toks[1]] += 1
        rounds += stats.rounds
    assert rounds == n_runs  # the second token is a round's, every run
    exact = _exact_marginal(target, prompt, temperature)
    tv = 0.5 * np.abs(counts / n_runs - exact).sum()
    assert tv < 0.2, tv


# -- the verify block at per-row positions -----------------------------------

def test_verify_block_matches_jax_flash_interpret(pairs):
    jm, jp, target, _ = pairs["gpt"]
    jm = JaxGpt(**GPT, decode_attn_impl="flash")
    target.configure(decode_attn_impl="flash")
    try:
        from mlapi_tpu.models.gpt import prefill_fn as jax_prefill

        total, k = 24, 3
        n_pad = np.asarray([0, 2], np.int32)
        prompts = PROMPTS[:2].copy()
        prompts[1, :2] = 0
        _, jcache = jax_prefill(jm, total)(
            jp, jnp.asarray(prompts),
            jnp.asarray(np.stack([np.asarray(jax.random.key_data(
                jax.random.key(0)))] * 2)),
            jnp.zeros((2,), jnp.float32), jnp.asarray(n_pad),
            jnp.zeros((2,), jnp.int32), jnp.ones((2,), jnp.float32))
        pcache = _to_torch(jax.tree.map(np.asarray, jcache))
        block = np.asarray([[5, 9, 13, 17], [21, 25, 29, 33]], np.int32)
        pos0 = np.asarray([7, 10], np.int32)   # rows at their own slots
        jcache, want = jspec.verify_fn(jm, k + 1)(
            jp, jcache, jnp.asarray(block), jnp.asarray(pos0),
            jnp.asarray(n_pad))
        pcache, got = spec.verify_fn(
            target, pcache, torch.as_tensor(block, dtype=torch.long),
            torch.as_tensor(pos0, dtype=torch.long),
            torch.as_tensor(n_pad, dtype=torch.long))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for ln in pcache:
            for n in pcache[ln]:
                np.testing.assert_allclose(pcache[ln][n].numpy(),
                                           np.asarray(jcache[ln][n]),
                                           atol=1e-5)
    finally:
        target.configure(decode_attn_impl="einsum")


def test_role_seeds_never_equal_the_plain_draw():
    for seed in (0, 1, 7, 2**40 + 3, -5):
        for index in (0, 1, 2, 31, 1000):
            plain = _stream_seed(seed, index)
            roles = {spec._role_seed(seed, tag, index)
                     for tag in (spec._DRAFT_TAG, spec._ACC_TAG,
                                 spec._RES_TAG)}
            assert plain not in roles and len(roles) == 3
