"""The port's paged serving path on the CPU, against the JAX package and
the port's contiguous engine.

- Greedy streams are identical through paged flash, contiguous flash,
  paged einsum and the JAX package's ``GptLM.generate`` on the same
  weights (float32, tiny config), both cache formats, for a bucketed
  prompt and for one past the largest bucket (paged chunked prefill).
- Continuous admission (``tests/test_paged_kv.py``'s admission pin): a
  long stream, then two joiners after its first chunk; every stream
  equals JAX ``generate`` on its prompt alone and is token-identical
  between paged and contiguous engines, at least one joiner was
  admitted into the running batch, and every page returns.
- A joiner admitted into the row of a request that just finished
  streams its own tokens (the finished request's page release must not
  take the joiner's pages).
- A pool too small for a request answers 503 over HTTP and leaks no
  page; the ``table_install`` fault fails the joiner alone.
- ``/metrics`` and ``/healthz`` name the pool; ``--kv-pages`` needs
  ``--kv-page-size``.
"""

import asyncio
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.__main__ import parse_args
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.requests import _SyncSink
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer

CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
BUCKETS = (16, 32, 64)
LONG = "chunked prefill reads the cache it wrote. " * 3   # 126 bytes
# (prompt, max_new_tokens) of the admission scenarios.
ADMIT = (("the first long request", 48), ("joiner", 6),
         ("another joiner arrives", 6))
PAGE_NAMES = (
    "generate.admitted", "generate.growths", "generate.kv_pages_total",
    "generate.kv_pages_in_use", "generate.kv_page_utilization",
    "generate.kv_page_bytes",
)


@pytest.fixture(scope="module")
def weights():
    """Matrices drawn N(0, 0.3) from a seed, zero biases, unit LayerNorm
    scales: logits sharp enough that each prompt's greedy stream is its
    own, so a row that lost its prompt's K/V, or read another row's,
    streams other tokens."""
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        fill = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return np.full(s.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights))
    return save_checkpoint(
        tmp_path_factory.mktemp("ck") / "gpt", model,
        config={"model": "gpt_lm", "model_kwargs": CFG,
                "tokenizer": ByteTokenizer().fingerprint()},
    )


@pytest.fixture(scope="module")
def jax_alone(weights):
    """Each admission prompt's greedy stream from JAX ``generate``, 48
    tokens: one left-padded batch, whose pads are masked, so each row is
    the prompt's stream alone."""
    tok = ByteTokenizer()
    rows = [tok.token_ids(t) for t, _ in ADMIT]
    width = max(map(len, rows))
    pads = [width - len(r) for r in rows]
    return np.asarray(JaxGpt(**CFG).generate(
        jax.tree.map(jnp.asarray, weights),
        jnp.asarray([[0] * p + r for p, r in zip(pads, rows)], jnp.int32),
        max_new_tokens=max(n for _, n in ADMIT), pad_lens=pads,
    )).tolist()


def _engine(ckpt, **kw):
    return TextGenerationEngine.from_checkpoint(
        ckpt, device="cpu", prompt_buckets=BUCKETS, **kw
    )


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_greedy_streams_identical_across_layouts_and_jax(weights, ckpt, fmt):
    """A bucketed prompt and a 126-token one (bucket 128: two 64-token
    chunks through ``paged_extend_fn``) against one JAX ``generate`` of
    both, left-padded, on the same weights."""
    tok = ByteTokenizer()
    texts, n_new = ("hello serving", LONG), 12
    rows = [tok.token_ids(t) for t in texts]
    width = max(map(len, rows))
    pads = [width - len(r) for r in rows]
    want = np.asarray(JaxGpt(**CFG, kv_quant=fmt).generate(
        jax.tree.map(jnp.asarray, weights),
        jnp.asarray([[0] * p + r for p, r in zip(pads, rows)], jnp.int32),
        max_new_tokens=n_new, pad_lens=pads,
    )).tolist()
    for page, impl in ((8, "flash"), (None, "flash"), (16, "einsum")):
        eng = _engine(ckpt, kv_quant=fmt, decode_attn_impl=impl,
                      kv_page_size=page)
        got = [eng.generate_text(t, max_new_tokens=n_new)["token_ids"]
               for t in texts]
        assert got == want, (fmt, page, impl)
        assert eng.prefill_chunks == 2
        assert eng.kv_pages_in_use == 0


async def _collect(req) -> list[int]:
    out: list[int] = []
    while True:
        item = await req.queue.get()
        if item is None:
            return out
        if isinstance(item, Exception):
            raise item
        out.extend(item["token_ids"])


async def _wait_pages_returned(eng) -> None:
    """Pages return on the device thread after the terminal frames:
    wait for the count, bounded, instead of racing it."""
    deadline = asyncio.get_running_loop().time() + 60.0
    while eng.kv_pages_in_use != 0:
        assert asyncio.get_running_loop().time() < deadline, (
            eng.kv_pages_in_use
        )
        await asyncio.sleep(0.005)


async def _long_then_joiners(eng, joiners):
    """A long stream; once its first chunk arrived (its batch is then
    running), the joiners. Returns each request's outcome."""
    await eng.start()
    try:
        r1 = await eng.submit(ADMIT[0][0], max_new_tokens=ADMIT[0][1],
                              stream=True)
        head = await r1.queue.get()
        assert not isinstance(head, Exception)
        rest = [await eng.submit(t, max_new_tokens=n) for t, n in joiners]
        outs = await asyncio.gather(
            _collect(r1), *map(_collect, rest), return_exceptions=True
        )
        outs[0] = head["token_ids"] + outs[0]
        await _wait_pages_returned(eng)
        return outs
    finally:
        await eng.stop()


def test_admission_streams_match_contiguous(ckpt, jax_alone):
    want = [ref[:n] for ref, (_, n) in zip(jax_alone, ADMIT)]
    outs = {}
    for page in (None, 8):
        eng = _engine(ckpt, decode_attn_impl="flash", kv_page_size=page,
                      chunk=2, max_wait_ms=0.0)
        outs[page] = asyncio.run(_long_then_joiners(eng, ADMIT[1:]))
        assert eng.admitted >= 1 and eng.batch_calls <= 2
        assert eng.growths >= 1
        assert outs[page] == want, page
    assert outs[8] == outs[None]


@pytest.mark.parametrize("page", [None, 8])
def test_joiner_takes_a_finished_row(ckpt, jax_alone, page):
    """A batch of the long request and a 3-token one, with a joiner
    staged from the start: at max_batch 2 it waits until the short
    request has finished, then takes that request's row. Every stream is
    its prompt's stream alone, and every page returns."""
    # Plain chunks: a fused width would finish the long request in one
    # chunk after the short one ends, leaving no boundary to admit at.
    eng = _engine(ckpt, decode_attn_impl="flash", kv_page_size=page,
                  kv_pages=40 if page else None, chunk=2, max_batch=2,
                  fused_single=False)
    plan = [ADMIT[0], (ADMIT[1][0], 3), ADMIT[2]]
    outs: list = [[], [], []]
    sinks = [_SyncSink(eng._encode(t, n, 0.0, 0, None), out)
             for (t, n), out in zip(plan, outs)]
    eng._admit.append(sinks[2])
    eng._run_batch(sinks[:2], admit=True)
    assert [s.error for s in sinks] == [None] * 3
    assert eng.admitted == 1 and eng.growths == 0
    assert outs == [ref[:n] for ref, (_, n) in zip(jax_alone, plan)]
    assert eng.kv_pages_in_use == 0


def test_table_install_fault_fails_the_joiner_only(ckpt):
    eng = _engine(ckpt, decode_attn_impl="flash", kv_page_size=8, chunk=2,
                  max_wait_ms=0.0)
    want = eng.generate_text(ADMIT[0][0],
                             max_new_tokens=ADMIT[0][1])["token_ids"]
    with faults.active("table_install:raise"):
        stream, joiner = asyncio.run(
            _long_then_joiners(eng, ADMIT[1:2])
        )
        assert faults.injected_count() == 1
    assert isinstance(joiner, faults.InjectedFault)
    assert stream == want and eng.admitted == 0


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def test_tiny_pool_answers_503_and_leaks_nothing(ckpt):
    """Two usable pages of 8 tokens: a 12-token prompt maps two and its
    first decode chunk needs a third."""
    eng = _engine(ckpt, decode_attn_impl="flash", kv_page_size=8,
                  kv_pages=3)
    with BackgroundServer(build_app(eng)) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "does not fit", "max_new_tokens": 16})
        assert e.value.code == 503
        assert e.value.headers["retry-after"] == "1"
        assert "kv-pages" in json.loads(e.value.read())["detail"]
        deadline = time.monotonic() + 60.0
        while eng.kv_pages_in_use != 0:
            assert time.monotonic() < deadline, eng.kv_pages_in_use
            time.sleep(0.005)
        assert eng.pool.exhaustions == 1
        # What fits still serves.
        out = _post(srv.port, {"text": "hi", "max_new_tokens": 2})
        assert len(out["token_ids"]) == 2


def test_metrics_and_healthz_name_the_pool(ckpt):
    eng = _engine(ckpt, decode_attn_impl="flash", kv_page_size=8)
    with BackgroundServer(build_app(eng)) as srv:
        _post(srv.port, {"text": "count me", "max_new_tokens": 4})
        health = _get(srv.port, "/healthz")
        metrics = _get(srv.port, "/metrics")
    assert health["kv_page_size"] == 8
    assert health["kv_pages"] == eng.kv_pages_total > 0
    snap = {**metrics["counters"], **metrics["gauges"]}
    assert all(name in snap for name in PAGE_NAMES), sorted(snap)
    assert snap["generate.kv_pages_total"] == eng.kv_pages_total
    assert snap["generate.kv_page_bytes"] == eng.kv_page_bytes() > 0
    # The CPU ran the plain versions: no kernel launched.
    assert set(metrics["kernels"].values()) == {0}
    assert "paged_decode_attention" in metrics["kernels"]


def test_kv_pages_needs_kv_page_size(ckpt, capsys):
    with pytest.raises(SystemExit) as e:
        parse_args(["--checkpoint", str(ckpt), "--kv-pages", "64"])
    assert e.value.code == 2
    assert "--kv-pages requires --kv-page-size" in capsys.readouterr().err
    with pytest.raises(ValueError, match="kv_pages requires kv_page_size"):
        _engine(ckpt, kv_pages=64)
