"""The port's tenants on the CPU, against the JAX package.

One deterministic scenario runs on a paged JAX engine and on the port's,
both at ``sched_max_batches=2`` with four adapter slots, the tiny
float32 GPT of the serving tests (numpy-seeded weights) and one
``TenantLedger`` each, built by ``build_app(..., tenants=...)``:

1. tenant ``a`` (adapter ``t1``) decodes in a lane, slowed by a decode
   delay, at a page quota equal to what that lane holds; a second group
   of ``a``, window-incompatible with the lane, defers on the quota,
   while tenant ``b``'s group starts a second lane and finishes;
2. tenant ``c`` holds adapter ``t1`` in a lane at a one-slot quota; its
   group naming ``t2`` defers on the slot quota;
3. tenant ``d`` at a live depth of a quarter of the queue has its budget
   clamped by the tenant brownout rung while the fleet ladder reads 0.

Every stream, the deferral and brownout counters, the ledger and the
``/metrics`` tenant block equal the JAX engine's. The ledger and
``parse_tenant_kv`` are held to the JAX package's directly, and the
HTTP surface: ``adapter`` and ``tenant`` over ``/generate``, 404 for an
unknown adapter, 503 with ``retry-after`` for exhausted slots.
"""

import asyncio
import json
import urllib.error
import urllib.request

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu.serving import faults as jfaults
from mlapi_tpu.serving import registry as jreg
from mlapi_tpu.serving.app import build_app as jax_build_app
from mlapi_tpu.serving.engine import TextGenerationEngine as JaxEngine
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu_torch.checkpoint import params_from_jax
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving import registry as treg
from mlapi_tpu_torch.serving.adapter_store import AdapterSlotsExhausted
from mlapi_tpu_torch.serving.app import _terminal_http, build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
SHORT = ("hello world", 40)     # bucket 16: a 10-page lane
LONG = ("x" * 100, 34)          # bucket 126: no window with SHORT's
QUOTAS = dict(quota_pages={"a": 10}, quota_slots={"c": 1},
              weights={"b": 2.0})
TARGETS = {"qkv": (32, 96), "attn_out": (32, 32), "ffn_up": (32, 128),
           "ffn_down": (128, 32)}


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def _draw(seed=0):
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _adapter(seed, rank=4):
    rng = np.random.default_rng(seed)
    return {f"layer_{n}": {t: {
        "a": (0.3 * rng.standard_normal((i, rank))).astype(np.float32),
        "b": (0.3 * rng.standard_normal((rank, o))).astype(np.float32),
    } for t, (i, o) in TARGETS.items()} for n in range(2)}


@pytest.fixture(scope="module")
def weights():
    return _draw()


def _port(weights, **kw):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights))
    model.configure(decode_attn_impl="flash")
    # The plain chunk, as the JAX engine here is pinned.
    eng = TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                               kv_page_size=8, max_wait_ms=0.0,
                               fused_single=False, **kw)
    for i in (1, 2):
        eng.register_adapter(f"t{i}", _adapter(i))
    return eng


def _jax(weights, **kw):
    eng = JaxEngine(JaxGpt(**CFG), jax.tree.map(jnp.asarray, weights),
                    tokenizer=JaxByteTokenizer(), chunk=8,
                    fused_single=False, kv_page_size=8, max_wait_ms=0.0,
                    **kw)
    for i in (1, 2):
        eng.register_adapter(f"t{i}", _adapter(i))
    return eng


async def _collect(req):
    out: list[int] = []
    while True:
        item = await req.queue.get()
        if item is None:
            return out, None
        if isinstance(item, Exception):
            return out, repr(item)
        out.extend(item["token_ids"])


async def _wait_for(pred, timeout_s: float = 60.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not pred():
        if loop.time() >= deadline:
            raise AssertionError("condition never became true")
        await asyncio.sleep(0.005)


COUNTERS = ("sched_tenant_pages_deferred", "sched_tenant_adapters_deferred",
            "sched_adapters_deferred", "sched_pages_deferred",
            "brownout_tenant_clamped", "brownout_tokens_clamped",
            "adapter_installs")


async def _scenario(eng, app, flt):
    led = app.state["tenants"]
    await eng.start()
    streams = []
    try:
        # 1. a page quota: a's second group defers, b starts a lane.
        flt.arm("decode:every=1:delay=0.02")
        ra1 = await eng.submit(SHORT[0], max_new_tokens=SHORT[1],
                               stream=True, adapter="t1", tenant="a")
        await _wait_for(lambda: eng.sched_batches_live == 1)
        assert eng.sched._lanes[0].tenant_pages == {"a": 10}
        ra2 = await eng.submit(LONG[0], max_new_tokens=LONG[1], stream=True,
                               tenant="a")
        await _wait_for(lambda: eng.sched_tenant_pages_deferred >= 1)
        rb = await eng.submit("y" * 100, max_new_tokens=LONG[1],
                              stream=True, tenant="b")
        streams.append(await _collect(rb))
        flt.disarm()
        streams += await asyncio.gather(_collect(ra1), _collect(ra2))
        # 2. a slot quota: c's group naming a second adapter defers.
        flt.arm("decode:every=1:delay=0.02")
        rc1 = await eng.submit(SHORT[0], max_new_tokens=SHORT[1],
                               stream=True, adapter="t1", tenant="c")
        await _wait_for(lambda: eng.sched_batches_live == 1)
        rc2 = await eng.submit(LONG[0], max_new_tokens=LONG[1], stream=True,
                               adapter="t2", tenant="c")
        await _wait_for(lambda: eng.sched_tenant_adapters_deferred >= 1)
        flt.disarm()
        streams += await asyncio.gather(_collect(rc1), _collect(rc2))
        # 3. the tenant brownout rung: d's depth is a quarter of the
        # queue, the fleet's is not.
        led.enter("d")
        led.enter("d")
        rd = await eng.submit(SHORT[0], max_new_tokens=64, tenant="d")
        assert rd.n_new == eng.default_max_new_tokens
        assert eng._brownout_level() == 0
        streams.append(await _collect(rd))
        led.exit("d")
        led.exit("d")
        await _wait_for(lambda: eng.kv_pages_in_use == 0)
    finally:
        flt.disarm()
        await eng.stop()
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as c:
        metrics = (await c.get("/metrics")).json()
    block = {k: v for kind in ("counters", "gauges")
             for k, v in metrics[kind].items() if k.startswith("tenant.")}
    return (streams, {k: getattr(eng, k) for k in COUNTERS},
            led.snapshot(), block)


def test_tenant_quotas_and_brownout_equal_the_jax_engines(weights):
    jeng = _jax(weights, sched_max_batches=2, max_queue=8, adapter_slots=4)
    japp = jax_build_app(jeng, tenants=jreg.TenantLedger(**QUOTAS))
    want = asyncio.run(_scenario(jeng, japp, jfaults))
    eng = _port(weights, sched_max_batches=2, max_queue=8, adapter_slots=4)
    app = build_app(eng, tenants=treg.TenantLedger(**QUOTAS))
    got = asyncio.run(_scenario(eng, app, faults))
    assert got == want
    streams, counters, snapshot, block = got
    assert all(err is None for _, err in streams)
    assert counters == {
        "sched_tenant_pages_deferred": 1, "sched_tenant_adapters_deferred": 1,
        "sched_adapters_deferred": 0, "sched_pages_deferred": 0,
        "brownout_tenant_clamped": 1, "brownout_tokens_clamped": 0,
        "adapter_installs": 2}
    assert block == {
        "tenant.a.deferrals": 1, "tenant.a.brownouts": 0, "tenant.a.depth": 0,
        "tenant.c.deferrals": 1, "tenant.c.brownouts": 0, "tenant.c.depth": 0,
        "tenant.d.deferrals": 0, "tenant.d.brownouts": 1, "tenant.d.depth": 0}


def test_ledger_and_parse_tenant_kv_are_the_jax_packages():
    for led in (treg.TenantLedger(**QUOTAS), jreg.TenantLedger(**QUOTAS)):
        led.enter("a")
        led.enter("a")
        led.exit("a")
        led.exit("b")        # never entered: clamps at zero
        led.note_deferral("c")
        led.note_brownout("a")
    t, j = (treg.TenantLedger(**QUOTAS), jreg.TenantLedger(**QUOTAS))
    for led in (t, j):
        led.enter("a")
        led.note_deferral("c")
    assert t.snapshot() == j.snapshot()
    assert (t.weight("b"), t.weight("z"), t.quota_pages_of("a"),
            t.quota_slots_of("a")) == (j.weight("b"), j.weight("z"),
                                       j.quota_pages_of("a"),
                                       j.quota_slots_of("a"))
    for pairs, cast in ((["a=4", " b =2"], int), (["a=1.5"], float)):
        assert treg.parse_tenant_kv(pairs, "--x", cast) == \
            jreg.parse_tenant_kv(pairs, "--x", cast)
    for bad in (["a4"], ["a=1", "a=2"]):
        with pytest.raises(ValueError) as want:
            jreg.parse_tenant_kv(bad, "--tenant-pages")
        with pytest.raises(ValueError) as got:
            treg.parse_tenant_kv(bad, "--tenant-pages")
        assert str(got.value) == str(want.value)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_generate_takes_adapter_and_tenant_over_http(weights):
    eng = _port(weights, adapter_slots=2)
    want = eng.generate_text(" q1", max_new_tokens=6, adapter="t1")
    led = treg.TenantLedger(quota_slots={"acme": 2})
    with BackgroundServer(build_app(eng, tenants=led)) as srv:
        got = _post(srv.port, {"text": " q1", "max_new_tokens": 6,
                               "adapter": "t1", "tenant": "acme"})
        assert got["token_ids"] == want["token_ids"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": " q1", "adapter": "nobody"})
        assert e.value.code == 404
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    c, g = metrics["counters"], metrics["gauges"]
    assert c["generate.adapter_installs"] == 1
    assert c["generate.adapter_fetch_hits"] == 0    # no fleet tier
    assert g["generate.adapter_slots_in_use"] == 1
    assert g["generate.adapter_resident_bytes"] == (
        sum(a.nbytes for a in jax.tree.leaves(weights))
        + g["generate.adapter_slot_bytes"])
    assert "tenant.acme.depth" not in g   # no history: not listed
    # Every slot held by live batches: the terminal frame is a 503 with
    # retry-after, as in the JAX app.
    err = _terminal_http(AdapterSlotsExhausted("all 2 slots held"))
    assert err.status == 503 and err.headers["retry-after"] == "1"
