"""The port's LlamaLM against the JAX package's (CPU).

One parameter tree drawn from a numpy seed goes into both packages
(``params_from_jax`` carries it into the port), at a tiny GQA config:
vocab 260, hidden 64, 2 layers, 8 query heads on 2 KV heads of 8
(group 4), 160 positions. Bounds: ``_rms_norm`` 1e-6 and ``_rope``
1e-5 in f32 (bf16 ``_rope`` within one bf16 rounding of the operand);
f32 logits of ``apply`` (full and flash: the port's plain B5-B7 against
the Pallas kernels in interpret mode), flash gradients and the cached
paths within 1e-4; bf16 logits within 2e-2; greedy streams, caches'
int8 payloads and byte counts exact.

- ``generate`` token for token for {none, int8} x {einsum, flash}, left
  pads included; the port's paged streams equal its contiguous ones.
- A checkpoint written as the JAX package writes one (its manifest and
  tree signature, the JAX key paths) serves through the port's engine
  with JAX's greedy stream; the port's checkpoint reads back in JAX.
- Fault C2: ``kv_page_bytes``, ``PagePool.page_bytes`` and the engine's
  ``kv_cache_slot_bytes`` equal the JAX package's for a GQA Llama and a
  GPT, and TinyLlama-1.1B's 16-token page is 360,448 B (bf16) and
  191,488 B (int8), not 8x that.
"""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.checkpoint.io import FORMAT_VERSION, CheckpointMeta, _stable_hash
from mlapi_tpu.checkpoint.io import tree_signature as jax_tree_signature
from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.llama import LlamaLM as JaxLlama
from mlapi_tpu.models.lora import LoraModel as JaxLoraModel
from mlapi_tpu.models.llama import _rms_norm as jax_rms_norm
from mlapi_tpu.models.llama import _rope as jax_rope
from mlapi_tpu.ops import quant as jq
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import (
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
    tree_signature,
)
from mlapi_tpu_torch.models.gpt import GptLM, decode_chunk_fn, paged_prefill_fn
from mlapi_tpu_torch.models.llama import LlamaLM, _rms_norm, _rope
from mlapi_tpu_torch.models.lora import LoraModel
from mlapi_tpu_torch.ops import quant as tq
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.paged_pool import PagePool
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=8,
           num_kv_heads=2, max_positions=160, compute_dtype="float32")
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
                 num_heads=32, num_kv_heads=4, intermediate_size=5632,
                 max_positions=2048, compute_dtype="bfloat16")
BUCKETS = (16, 32, 64)
TOL = 1e-4


def _np_params(seed=0):
    """The JAX param tree's shapes, values from a numpy seed (wider than
    the 0.02 init, so greedy streams are not one repeated token)."""
    shapes = jax.eval_shape(lambda: JaxLlama(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        std = 0.1 if "w_" in name else 0.3
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(np_params, **kw):
    model = LlamaLM(**{**CFG, **kw}, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    np_params = _np_params()
    jax_params = jax.tree.map(jnp.asarray, np_params)
    return JaxLlama(**CFG), jax_params, _port(np_params), np_params


def _ids(shape, seed=1):
    return np.random.default_rng(seed).integers(4, 260, shape).astype(
        np.int32)


def test_params_and_signature_match_jax(pair):
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
    assert (model.kv_heads, model.head_dim, model.ffn_size) == (2, 8, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match(dtype):
    """Positions 0 and max_positions - 1 in every row, the rest random;
    rows of a left-padded batch clamp their pads at 0."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = rng.integers(0, 160, (2, 6)).astype(np.int32)
    pos[:, 0], pos[:, -1] = 0, 159
    pos[1, :3] = 0
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)
    rope = jax.jit(jax_rope, static_argnums=2)
    want = np.asarray(rope(jx, jnp.asarray(pos), 10_000.0), np.float32)
    got = _rope(tx, torch.as_tensor(pos), 10_000.0).float().numpy()
    # bf16: XLA may fuse x*cos + xr*sin without the roundings in between.
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got[:, 0], x[:, 0], atol=atol, rtol=0)
    if dtype == "float32":
        want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(scale)))
        got = _rms_norm(torch.as_tensor(x), torch.as_tensor(scale)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_apply_logits_and_flash_gradients(pair, impl):
    """Logits of ``apply`` (1e-4); with flash, the gradient of every
    parameter through B5-B7 (1e-4)."""
    _, _, _, np_params = pair
    jm = JaxLlama(**CFG, attention_impl=impl)
    jp = jax.tree.map(jnp.asarray, np_params)
    ids = _ids((2, 24), seed=3)

    def loss(p):
        # The LM objective: mean next-token cross-entropy.
        logits = jm.apply(p, jnp.asarray(ids))
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(ids)[:, 1:, None], -1)
        return jnp.mean(nll), logits

    model = _port(np_params, attention_impl=impl)
    if impl == "full":
        want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)))
        with torch.no_grad():
            got = model.apply(torch.as_tensor(ids).long()).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        return
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    for p in model.parameters():
        p.requires_grad_(True)
    tids = torch.as_tensor(ids).long()
    out = model.apply(tids)
    torch.nn.functional.cross_entropy(out[:, :-1].transpose(1, 2),
                                      tids[:, 1:]).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=TOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=TOL, rtol=0, err_msg=key)


def test_bf16_logits(pair):
    _, jp, _, np_params = pair
    jm = JaxLlama(**{**CFG, "compute_dtype": "bfloat16"})
    model = _port(np_params, compute_dtype="bfloat16")
    ids = _ids((2, 16), seed=5)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)))
    with torch.no_grad():
        got = model.apply(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_cached_paths_logits(pair, impl):
    """prefill_core → decode_step → extend_core, left pads included, on
    an int8 cache of ROTATED keys: logits at every stage and the int8
    payloads themselves."""
    jm, jp, model, _ = pair
    jm = dataclasses.replace(jm, kv_quant="int8", decode_attn_impl=impl)
    model.configure(kv_quant="int8", decode_attn_impl=impl)
    try:
        ids, step, span = _ids((2, 10)), _ids((2, 1), 3), _ids((2, 3), 4)
        n_pad = np.array([0, 4])
        total = 24

        @jax.jit
        def stages(p, n):
            # One program for the three JAX stages (one compile).
            c, prefill = jm.prefill_core(p, jnp.asarray(ids), n, total)
            decode, c = jm.decode_step(p, c, jnp.asarray(step),
                                       jnp.int32(10), n)
            c, extend = jm.extend_core(p, c, jnp.asarray(span),
                                       jnp.int32(11), n, jnp.int32(0),
                                       jnp.int32(0), all_logits=True)
            return (prefill, decode, extend), c

        want, jc = stages(jp, jnp.asarray(n_pad))
        tn = torch.as_tensor(n_pad)
        tc, prefill = model.prefill_core(torch.as_tensor(ids).long(), tn,
                                         total)
        decode, tc = model.decode_step(tc, torch.as_tensor(step).long(), 10,
                                       tn)
        tc, extend = model.extend_core(tc, torch.as_tensor(span).long(), 11,
                                       tn, all_logits=True)
        for got, w in zip((prefill, decode, extend), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL)
        for n in range(CFG["num_layers"]):
            assert tc[f"layer_{n}"]["k_q"].shape == (2, total, 2, 8)
            np.testing.assert_array_equal(
                tc[f"layer_{n}"]["k_q"].numpy(),
                np.asarray(jc[f"layer_{n}"]["k_q"]),
            )
    finally:
        model.configure(kv_quant="none", decode_attn_impl="einsum")


TEXTS = ("grouped k", "rope kv", "gqa!")     # 9, 7 and 4 bytes


def _padded_prompts():
    """TEXTS as byte ids, left-padded to 9 (pads 0, 2, 5)."""
    tok = ByteTokenizer()
    ids = np.zeros((3, 9), np.int32)
    for row, text in zip(ids, TEXTS):
        row[9 - len(text):] = tok.token_ids(text)
    return ids, np.array([0, 2, 5])


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_greedy_generate_token_identical(pair, kv_quant, impl):
    jm, jp, model, _ = pair
    jm = dataclasses.replace(jm, kv_quant=kv_quant, decode_attn_impl=impl)
    model.configure(kv_quant=kv_quant, decode_attn_impl=impl)
    try:
        ids, pads = _padded_prompts()
        want = np.asarray(jm.generate(jp, jnp.asarray(ids), max_new_tokens=12,
                                      pad_lens=jnp.asarray(pads)))
        got = model.generate(torch.as_tensor(ids).long(), max_new_tokens=12,
                             pad_lens=pads).numpy()
    finally:
        model.configure(kv_quant="none", decode_attn_impl="einsum")
    np.testing.assert_array_equal(got, want)
    assert len(set(want.ravel().tolist())) > 3   # a real stream


def _paged_generate(model, ids, pads, n_new, page=4):
    """Greedy generation through a paged cache: each row's pages drawn
    from a fresh pool in shuffled order, the page-native prefill and the
    decode chunk writing and reading them through the table."""
    b, p = ids.shape
    npv = -(-(p + n_new) // page)
    pool = PagePool(model, page_size=page, num_pages=b * npv + 1)
    pages = np.random.default_rng(3).permutation(pool.alloc(b * npv))
    cache = tq.paged_cache_tree(pool.layers, pages.reshape(b, npv))
    n_pad = torch.as_tensor(pads)
    temps, seeds = np.zeros(b, np.float32), np.zeros(b, np.int64)
    top_k, top_p = np.zeros(b, np.int64), np.ones(b, np.float32)
    first, cache = paged_prefill_fn(model, cache, ids, 0, seeds, temps,
                                    n_pad, top_k, top_p)
    rest, _, _ = decode_chunk_fn(model, cache, first, p, n_pad, temps, seeds,
                                 1, top_k, top_p, chunk=n_new - 1)
    return torch.cat([first[:, None], rest], dim=1)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_streams_equal_contiguous(pair, kv_quant):
    _, _, model, _ = pair
    ids, pads = _padded_prompts()
    ids = torch.as_tensor(ids).long()
    streams = {}
    try:
        for impl in ("einsum", "flash"):
            model.configure(kv_quant=kv_quant, decode_attn_impl=impl)
            with torch.inference_mode():
                streams[impl] = model.generate(ids, max_new_tokens=12,
                                               pad_lens=pads).tolist()
                streams["paged " + impl] = _paged_generate(
                    model, ids, pads, 12).tolist()
    finally:
        model.configure(kv_quant="none", decode_attn_impl="einsum")
    assert streams["paged flash"] == streams["flash"] == streams["einsum"]
    assert streams["paged einsum"] == streams["einsum"]


def _jax_style_checkpoint(path, np_params, config):
    """A checkpoint as the JAX package describes one: its manifest (its
    CheckpointMeta, config hash and tree signature) beside the parameters
    at their JAX key paths in ``params.npz``."""
    path.mkdir(parents=True)
    flat = {
        "/".join(str(k.key) for k in p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_leaves_with_path(np_params)
    }
    np.savez(path / "params.npz", **flat)
    meta = CheckpointMeta(
        format_version=FORMAT_VERSION, framework_version="jax", step=7,
        created_unix=0.0, config=config, config_hash=_stable_hash(config),
        tree_signature=jax_tree_signature(np_params), vocab=None,
    )
    (path / "MANIFEST.json").write_text(json.dumps(meta.to_json()))
    return path


def test_jax_checkpoint_serves_and_port_checkpoint_reads_back(pair, tmp_path):
    """The JAX-side checkpoint serves through the port's engine (flash,
    int8, paged 16) each of TEXTS with JAX's greedy stream of it (the
    int8 einsum program of test_greedy_generate_token_identical, left
    pads and all); the port's own checkpoint of the same model loads
    back into JAX with the same signature and the same logits."""
    jm, jp, model, np_params = pair
    config = {"model": "llama_lm", "model_kwargs": CFG,
              "tokenizer": JaxByteTokenizer().fingerprint()}
    ckpt = _jax_style_checkpoint(tmp_path / "jax", np_params, config)
    eng = TextGenerationEngine.from_checkpoint(
        ckpt, device="cpu", kv_quant="int8", decode_attn_impl="flash",
        prompt_buckets=BUCKETS, kv_page_size=16,
    )
    assert isinstance(eng.model, LlamaLM) and eng.model.kv_heads == 2
    ids, pads = _padded_prompts()
    jm8 = dataclasses.replace(jm, kv_quant="int8", decode_attn_impl="einsum")
    want = np.asarray(jm8.generate(jp, jnp.asarray(ids), max_new_tokens=12,
                                   pad_lens=jnp.asarray(pads)))
    for text, row in zip(TEXTS, want):
        got = eng.generate_text(text, max_new_tokens=12)
        assert got["token_ids"] == row.tolist(), text
    assert eng.kv_pages_in_use == 0

    out = save_checkpoint(tmp_path / "port", model, step=3, config=config)
    state, meta = load_checkpoint(out, LlamaLM(**CFG, seed=None,
                                               device="cpu"))
    with np.load(out / "params.npz") as z:
        nested: dict = {}
        for key in z.files:
            *heads, leaf = key.split("/")
            node = nested
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(z[key])
    assert jax_tree_signature(nested) == meta.tree_signature
    ids = jnp.asarray(_ids((1, 12), seed=6))
    apply = jax.jit(jm.apply)
    np.testing.assert_array_equal(np.asarray(apply(nested, ids)),
                                  np.asarray(apply(jp, ids)))


def _engines(port_model, jax_model, jax_params, **kw):
    port = TextGenerationEngine(port_model, tokenizer=ByteTokenizer(),
                                prompt_buckets=BUCKETS, **kw)
    ref = JaxEngine(jax_model, jax_params, tokenizer=JaxByteTokenizer(),
                    prompt_buckets=BUCKETS, chunk=8, **kw)
    return port, ref


@pytest.mark.parametrize("kv_quant,impl", [("none", "flash"),
                                           ("int8", "einsum")])
def test_kv_bytes_equal_the_jax_package(pair, kv_quant, impl):
    """Fault C2: the port sized caches by query heads. Page bytes, pool
    page bytes, slot bytes and the modeled decode read (flash: the
    stored cache; einsum over int8: the stored cache and the query-head
    operand) for the GQA Llama and a GPT, against the JAX package's
    engines; TinyLlama's page from shapes alone."""
    jm, jp, _, np_params = pair
    gpt_cfg = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
                   max_positions=160, compute_dtype="float32")
    modes = dict(kv_quant=kv_quant, decode_attn_impl=impl)
    jgpt = JaxGpt(**gpt_cfg, **modes)
    gpt = GptLM(**gpt_cfg, **modes, seed=None, device="cpu")
    gpt_params = jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jgpt.init(jax.random.key(0))),
    )
    for port_model, jax_model, params in (
        (_port(np_params, **modes), dataclasses.replace(jm, **modes), jp),
        (gpt, jgpt, gpt_params),
    ):
        port, ref = _engines(port_model, jax_model, params, kv_page_size=16)
        assert tq.kv_page_bytes(port_model, 16) == jq.kv_page_bytes(
            jax_model, 16)
        assert port.kv_page_bytes() == ref.kv_page_bytes()
        assert port.pool.page_bytes == ref.kv_page_bytes()
        assert port.kv_cache_slot_bytes() == ref.kv_cache_slot_bytes()
        assert port.decode_bytes_per_step() == ref.decode_bytes_per_step()
    # TinyLlama-1.1B, 16-token page: 22 layers x K and V x 16 x 4 KV heads
    # x 64 x 2 B (bf16) = 360,448 B; int8 payload + f32 scales 191,488 B.
    tiny = types.SimpleNamespace(num_layers=22, kv_heads=4, head_dim=64,
                                 cdt=torch.bfloat16, kv_quant=kv_quant)
    tiny.init_cache = functools.partial(LlamaLM.init_cache, tiny)
    want = {"none": 360_448, "int8": 191_488}[kv_quant]
    assert tq.kv_page_bytes(tiny, 16) == want
    assert jq.kv_page_bytes(JaxLlama(**TINYLLAMA, kv_quant=kv_quant),
                            16) == want


def test_unported_pieces_refuse_by_roadmap_item(pair):
    _, _, model, np_params = pair
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        LlamaLM(**CFG, attention_impl="ring", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        model.param_shardings()
    # LoRA is served since Queue A item 5: a JAX LoRA tree (rank 4, its
    # adapters with nonzero b) loads into the port's LoraModel, hashes
    # the same and computes the same logits.
    jlora = JaxLoraModel(JaxLlama(**CFG), rank=4)
    tree = jax.tree.map(np.asarray, jlora.init(
        jax.random.key(1), base_params=jax.tree.map(jnp.asarray, np_params)))
    rng = np.random.default_rng(2)
    for ab in tree["lora"].values():
        ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
            np.float32)
    lora = LoraModel(_port(np_params), rank=4)
    lora.load_state_dict(params_from_jax(tree))
    assert tree_signature(lora) == jax_tree_signature(tree)
    ids = _ids((2, 9))
    np.testing.assert_allclose(
        lora.apply(torch.as_tensor(ids)).detach().numpy(),
        np.asarray(jlora.apply(jax.tree.map(jnp.asarray, tree), ids)),
        atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="multiple of"):
        LlamaLM(**{**CFG, "num_kv_heads": 3}, device="cpu")


def test_llama_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is runnable")
    monkeypatch.delenv("MLAPI_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaLM(**CFG, seed=None)
    assert LlamaLM(**CFG, seed=None, device="cpu").device.type == "cpu"
