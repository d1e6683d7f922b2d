"""The port's many-adapter LoRA serving on the CPU, against the JAX
package.

The tiny float32 GPT and GQA Llama of the serving tests (vocab 260,
hidden 32, 2 layers, 4 heads; Llama's 4 query heads on 2 KV heads), one
numpy-seeded parameter tree each, rank-4 adapters drawn from numpy
seeds in the canonical serving form (``b`` pre-scaled).

- The wire format: ``serialize_adapter`` bytes (and ``save_adapter``
  files) identical across the packages, every corruption class of
  ``deserialize_adapter`` raising as in JAX, the id grammar equal.
- The slot path, for GPT and Llama x {none, int8} caches x {contiguous,
  paged 8}: a single tenant (grouped) and a mixed batch of two tenants
  and a base row (gathered BGMV) stream exactly JAX's greedy tokens; the
  tenant's stream equals the eagerly merged ``W + a @ b`` engine's; the
  mixed batch equals each row run solo; base streams are unchanged
  after adapter traffic.
- Residency against the JAX engine, exactly: installs, LRU evictions,
  ``AdapterSlotsExhausted`` with no hold leaked, ``adapter_resident_bytes
  == base + N x slot_bytes``, an unknown id refused, and the prefix
  decline (an adapter request folds its prefix into the prompt).
- The ``adapter_install`` fault leaves nothing half-installed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.models.llama import LlamaLM as JaxLlama
from mlapi_tpu.serving import adapter_store as jas
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.serving.requests import _SyncSink as JaxSink
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.models.llama import LlamaLM
from mlapi_tpu_torch.models.lora import DEFAULT_TARGETS, merge_adapter
from mlapi_tpu_torch.serving import adapter_store as tas
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
FAMILIES = {"gpt": (JaxGpt, GptLM, {}),
            "llama": (JaxLlama, LlamaLM, {"num_kv_heads": 2})}
BUCKETS = (16, 32)
RANK = 4
N_NEW = 8
MIXED = ((" q1", "t1"), (" hello", None), (" zz top", "t2"))


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


def _cfg(family):
    return {**CFG, **FAMILIES[family][2]}


def _draw(family, seed=0):
    jm = FAMILIES[family][0](**_cfg(family))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _mk_adapter(params, seed, rank=RANK, scale=0.3):
    """A canonical serving payload over every target ``params`` holds."""
    rng = np.random.default_rng(seed)
    payload: dict = {}
    for ln in sorted((k for k in params if k.startswith("layer_")),
                     key=lambda k: int(k.split("_")[1])):
        for t in DEFAULT_TARGETS:
            node = params[ln].get(t)
            kernel = node.get("kernel") if isinstance(node, dict) else node
            if kernel is None:
                continue
            d_in, d_out = kernel.shape
            payload.setdefault(ln, {})[t] = {
                "a": (scale * rng.standard_normal((d_in, rank))).astype(
                    np.float32),
                "b": (scale * rng.standard_normal((rank, d_out))).astype(
                    np.float32),
            }
    return payload


@pytest.fixture(scope="module")
def weights():
    return {f: _draw(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def adapters(weights):
    return {f: {f"t{i}": _mk_adapter(weights[f], seed=10 + i)
                for i in (1, 2, 3)} for f in FAMILIES}


def _jax(weights, family, kv_quant="none", slots=4):
    jm = FAMILIES[family][0](**_cfg(family), kv_quant=kv_quant)
    return JaxEngine(jm, jax.tree.map(jnp.asarray, weights[family]),
                     tokenizer=JaxByteTokenizer(), prompt_buckets=BUCKETS,
                     chunk=8, fused_single=False, kv_page_size=8,
                     adapter_slots=slots)


def _port(state, family, page=8, kv_quant="none", **kw):
    model = FAMILIES[family][1](**_cfg(family), seed=None, device="cpu")
    model.load_state_dict(state)
    model.configure(kv_quant=kv_quant, decode_attn_impl="flash")
    # The plain chunk, as the JAX engine here is pinned.
    return TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                prompt_buckets=BUCKETS, kv_page_size=page,
                                fused_single=False, **kw)


def _batch(eng, sink_cls, specs, prefix=None):
    """One formed batch of ``(text, adapter)``; returns streams, or the
    errors when any row failed."""
    outs = [[] for _ in specs]
    sinks = [sink_cls(eng._encode(text, N_NEW, 0.0, 0, None, prefix=prefix,
                                  adapter=ad), out)
             for (text, ad), out in zip(specs, outs)]
    eng._run_batch(sinks)
    errors = [s.error for s in sinks if s.error is not None]
    return errors if errors else outs


def _counters(eng):
    return {k: getattr(eng, k) for k in (
        "adapter_installs", "adapter_evictions", "adapter_slots_in_use",
        "adapter_grouped_batches", "adapter_gathered_batches",
        "adapter_slot_bytes", "adapter_resident_bytes", "prefix_fallbacks",
        "adapter_store_entries", "adapter_store_bytes_in_use")}


def test_wire_format_is_the_jax_packages(adapters, tmp_path):
    payload = adapters["llama"]["t1"]
    data = tas.serialize_adapter("t1", payload)
    assert data == jas.serialize_adapter("t1", payload)
    out, rank, nbytes = tas.deserialize_adapter("t1", data)
    assert (rank, nbytes) == (RANK, tas.adapter_bytes(payload))
    assert nbytes == jas.adapter_bytes(payload)
    for ln, layer in payload.items():
        for t, pair in layer.items():
            for ab in ("a", "b"):
                np.testing.assert_array_equal(out[ln][t][ab], pair[ab])
    head_line, _, rest = data.partition(b"\n")
    head = json.loads(head_line)
    head["leaves"][0][3] = [head["leaves"][0][3][0], RANK + 1]
    ragged = json.dumps(head).encode() + b"\n" + rest
    for aid, bad in (
        ("t1", b"garbage with no header"),
        ("t1", b"{}\n"),                                  # fields missing
        ("t1", data[: len(data) // 2]),                   # truncated
        ("t1", data + b"x"),                              # trailing bytes
        ("t1", data.replace(b'"nbytes": ', b'"nbytes": 9', 1)),
        ("other", data),                                  # wrong tenant
        ("t1", ragged),                                   # ragged rank
    ):
        with pytest.raises(ValueError) as want:
            jas.deserialize_adapter(aid, bad)
        with pytest.raises(ValueError) as got:
            tas.deserialize_adapter(aid, bad)
        assert str(got.value) == str(want.value)
    p = tmp_path / "t1.lora"
    assert tas.save_adapter(str(p), "t1", payload) == nbytes
    jas.save_adapter(str(tmp_path / "j.lora"), "t1", payload)
    assert p.read_bytes() == (tmp_path / "j.lora").read_bytes()
    aid, loaded, rank2, nbytes2 = tas.load_adapter(str(p))
    assert (aid, rank2, nbytes2) == ("t1", RANK, nbytes)
    for ok in ("t1", "tenant-42", "A.b_c-d", "x" * 64, "", "x" * 65, "a b",
               "a/b", "a\nb", "../etc", "ü"):
        assert bool(tas.ADAPTER_ID_RE.match(ok)) == bool(
            jas.ADAPTER_ID_RE.match(ok))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_slot_streams_equal_jax_and_the_merged_engine(weights, adapters,
                                                      family, kv_quant):
    ads = adapters[family]
    jeng = _jax(weights, family, kv_quant)
    for aid in ("t1", "t2"):
        jeng.register_adapter(aid, ads[aid])
    want_solo = _batch(jeng, JaxSink, MIXED[:1])
    want_mixed = _batch(jeng, JaxSink, MIXED)
    want = _counters(jeng)
    state = params_from_jax(weights[family])
    merged = _port(merge_adapter(state, ads["t1"]), family,
                   kv_quant=kv_quant)
    assert _batch(merged, _SyncSink, [(MIXED[0][0], None)]) == want_solo
    for page in (None, 8):
        eng = _port(state, family, page, kv_quant, adapter_slots=4)
        for aid in ("t1", "t2"):
            eng.register_adapter(aid, ads[aid])
        base = _batch(eng, _SyncSink, MIXED[1:2])
        assert _batch(eng, _SyncSink, MIXED[:1]) == want_solo, page
        assert _batch(eng, _SyncSink, MIXED) == want_mixed, page
        got = _counters(eng)
        assert got == want, page
        assert (got["adapter_grouped_batches"],
                got["adapter_gathered_batches"]) == (1, 1)
        # Each row of the mixed batch is its solo run; base traffic
        # after adapter traffic is unchanged.
        assert want_mixed[1] == base[0]
        assert _batch(eng, _SyncSink, MIXED[2:]) == want_mixed[2:]
        assert _batch(eng, _SyncSink, MIXED[1:2]) == base
        assert want_solo[0] != base[0]   # the adapter bites


def test_residency_counters_equal_the_jax_engines(weights, adapters):
    """Two slots, three tenants: installs, LRU evictions, exhaustion
    with no hold leaked, resident bytes in closed form, an unknown id,
    and the prefix decline, step by step against the JAX engine."""
    ads = adapters["gpt"]
    engines = {
        "jax": (_jax(weights, "gpt", slots=2), JaxSink, jas),
        "port": (_port(params_from_jax(weights["gpt"]), "gpt",
                       adapter_slots=2), _SyncSink, tas),
    }
    seen = {}
    for side, (eng, sink, mod) in engines.items():
        for aid in ("t1", "t2", "t3"):
            eng.register_adapter(aid, ads[aid])
        log = []
        for aid in ("t1", "t2", "t3", "t1"):   # t3 evicts t1, t1 evicts t2
            out = _batch(eng, sink, [(" q1", aid)])
            log.append((out, _counters(eng)))
        # Three tenants in one batch over two slots: refused at
        # formation, every hold rolled back.
        errs = _batch(eng, sink, [(" q1", "t1"), (" q2", "t2"),
                                  (" q3", "t3")])
        assert all(isinstance(e, mod.AdapterSlotsExhausted) for e in errs)
        log.append(_counters(eng))
        assert eng.adapters._holds == {a: 0 for a in eng.adapters._holds}
        log.append(_batch(eng, sink, [(" q2", "t2")]))
        with pytest.raises(mod.AdapterUnavailable):
            eng._encode(" q", N_NEW, 0.0, 0, None, adapter="nope")
        # An adapter request folds its prefix into the prompt.
        log.append(_batch(eng, sink, [(" q1", "t1")], prefix="You: "))
        log.append(_batch(eng, sink, [("You:  q1", "t1")]))
        log.append(_counters(eng))
        seen[side] = log
    assert seen["port"] == seen["jax"]
    port = engines["port"][0]
    assert port.adapter_evictions == 3 and port.prefix_fallbacks == 1
    base = sum(a.nbytes for a in jax.tree.leaves(weights["gpt"]))
    assert port.adapter_resident_bytes == base + 2 * port.adapter_slot_bytes


def test_adapter_install_fault_leaves_nothing_half_installed(weights,
                                                             adapters):
    eng = _port(params_from_jax(weights["gpt"]), "gpt", adapter_slots=2)
    eng.register_adapter("t1", adapters["gpt"]["t1"])
    faults.arm("adapter_install:raise")
    errs = _batch(eng, _SyncSink, [(" q1", "t1")])
    assert len(errs) == 1 and isinstance(errs[0], faults.InjectedFault)
    assert (eng.adapter_installs, eng.adapter_slots_in_use) == (0, 0)
    assert eng.adapters._free == [2, 1] and not eng.adapters._holds
    assert eng.kv_pages_in_use == 0
    faults.disarm()
    out = _batch(eng, _SyncSink, [(" q1", "t1")])
    assert isinstance(out[0], list) and len(out[0]) == N_NEW
    assert (eng.adapter_installs, eng.adapter_slots_in_use) == (1, 1)
