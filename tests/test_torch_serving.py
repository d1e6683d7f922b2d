"""The port's serving path on the CPU: engine, HTTP, checkpoints, and the
package's boundaries.

- The engine's greedy ``generate_text`` equals the JAX package's
  ``GptLM.generate`` on the same weights (float32, tiny config), for a
  bucketed prompt and for one longer than the largest bucket, which the
  engine prefills in chunks through ``extend_core`` (flash, int8 cache).
- ``POST /generate`` (unary and NDJSON stream), ``/healthz`` and
  ``/metrics`` over real HTTP against an in-process server.
- Checkpoints round-trip; a wrong model is refused.
- No module of ``mlapi_tpu_torch`` nor ``chip_smoke.py`` imports JAX or
  the JAX package, and importing the serving stack loads no JAX.
- Entry points run on CUDA unless asked for the CPU: without a card and
  without such a request they raise.
"""

import ast
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlapi_tpu.models.gpt import GptLM as JaxGpt
from mlapi_tpu_torch.checkpoint import (
    load_checkpoint,
    params_from_jax,
    read_manifest,
    save_checkpoint,
)
from mlapi_tpu_torch.models.gpt import GptLM
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.server import BackgroundServer
from mlapi_tpu_torch.text import ByteTokenizer
from mlapi_tpu_torch.utils.platform import resolve_device

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=260, hidden_size=32, num_layers=2, num_heads=4,
           max_positions=160, compute_dtype="float32")
BUCKETS = (16, 32, 64)
LONG = "chunked prefill reads the cache it wrote. " * 3   # 126 bytes


@pytest.fixture(scope="module")
def weights():
    shapes = jax.eval_shape(lambda: JaxGpt(**CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes,
    )


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    model = GptLM(**CFG, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(weights))
    return save_checkpoint(
        tmp_path_factory.mktemp("ck") / "gpt", model, step=3,
        config={"model": "gpt_lm", "model_kwargs": CFG,
                "tokenizer": ByteTokenizer().fingerprint()},
    )


def _engine(ckpt, **kw):
    return TextGenerationEngine.from_checkpoint(
        ckpt, device="cpu", prompt_buckets=BUCKETS, **kw
    )


def test_engine_greedy_matches_jax_generate(weights, ckpt):
    """A bucketed prompt and a chunked-prefill one (126 tokens → bucket
    128 = 2 chunks of 64) through the engine with flash + int8, against
    the JAX model's plain generate of the raw prompt."""
    eng = _engine(ckpt, kv_quant="int8", decode_attn_impl="flash")
    jm = JaxGpt(**CFG, kv_quant="int8")
    jp = jax.tree.map(jnp.asarray, weights)
    tok = ByteTokenizer()
    for text, n_new, chunks in (("hello serving", 20, 0), (LONG, 12, 2)):
        before = eng.prefill_chunks
        got = eng.generate_text(text, max_new_tokens=n_new)
        assert eng.prefill_chunks - before == chunks
        ids = jnp.asarray([tok.token_ids(text)], jnp.int32)
        want = np.asarray(jm.generate(jp, ids, max_new_tokens=n_new))[0]
        assert got["token_ids"] == want.tolist()
        assert got["prompt_tokens"] == len(tok.token_ids(text))
        assert got["text"] == tok.decode(want)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def test_http_generate_stream_healthz_metrics(ckpt):
    eng = _engine(ckpt, decode_attn_impl="flash")
    want = eng.generate_text("over http", max_new_tokens=10)["token_ids"]
    with BackgroundServer(build_app(eng)) as srv:
        status, body = _post(srv.port, {"text": "over http",
                                        "max_new_tokens": 10})
        out = json.loads(body)
        assert status == 200 and out["token_ids"] == want
        status, body = _post(srv.port, {"text": "over http", "stream": True,
                                        "max_new_tokens": 10})
        lines = [json.loads(x) for x in body.decode().splitlines()]
        assert lines[-1]["done"] is True
        assert lines[-1]["token_ids"] == want       # the FULL list
        assert [t for x in lines[:-1] for t in x["token_ids"]] == want
        health = _get(srv.port, "/healthz")
        assert health["status"] == "ok" and health["backend"] == "cpu"
        assert health["decode_attn_impl"] == "flash"
        metrics = _get(srv.port, "/metrics")
        assert metrics["counters"]["generate.requests"] == 2
        assert metrics["counters"]["generate.prefill_chunks"] == 0
        assert metrics["kernels"] == {
            "decode_attention": 0, "extend_attention": 0,
            "paged_decode_attention": 0, "paged_extend_attention": 0,
        }   # the CPU ran the plain versions
        for bad, field in (({"max_new_tokens": 5}, "text"),
                           ({"text": "x", "top_k": "many"}, "top_k"),
                           # A prefix too long for the window (the
                           # field is served since the prefix slice);
                           # adapter and tenant of the wrong type.
                           ({"text": "x", "prefix": "p" * 4096}, "prefix"),
                           ({"text": "x", "adapter": 7}, "adapter"),
                           ({"text": "x", "tenant": ["t"]}, "tenant")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, bad)
            assert e.value.code == 422
            detail = json.loads(e.value.read())["detail"]
            assert detail[0]["loc"] == [field]
        # deadline_ms is a served field since the scheduler slice;
        # tenant and adapter since the adapter slice: a tenant alone is
        # served as the JAX engine serves it, an adapter on an engine
        # without adapter slots is the JAX engine's 404.
        status, body = _post(srv.port, {"text": "over http", "max_new_tokens":
                                        10, "deadline_ms": 60000})
        assert status == 200 and json.loads(body)["token_ids"] == want
        status, body = _post(srv.port, {"text": "over http", "max_new_tokens":
                                        10, "tenant": "t"})
        assert status == 200 and json.loads(body)["token_ids"] == want
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"text": "x", "adapter": "a"})
        assert e.value.code == 404


def test_stop_strings_and_window_incompatible_requests(ckpt):
    """A stop string cuts the text at its first match (unary and
    stream); two requests that cannot share one cache window are served
    in two batches, both complete."""
    import threading

    eng = _engine(ckpt)
    full = eng.generate_text("stop here", max_new_tokens=24)["text"]
    stop = full[6:8]
    cut = full.find(stop)
    with BackgroundServer(build_app(eng)) as srv:
        out = json.loads(_post(srv.port, {"text": "stop here", "stop": stop,
                                          "max_new_tokens": 24})[1])
        assert out["text"] == full[:cut] and out["stopped"] == stop
        lines = [json.loads(x) for x in _post(srv.port, {
            "text": "stop here", "stop": [stop], "stream": True,
            "max_new_tokens": 24})[1].decode().splitlines()]
        assert lines[-1]["done"] and lines[-1]["text"] == full[:cut]
        # 126-token prompt (bucket 128) + 30 tokens, and a short prompt +
        # 100 tokens: each fits the 160-slot window, together they don't.
        batches0 = eng.batch_calls
        outs = {}
        bodies = {"long": {"text": LONG, "max_new_tokens": 30},
                  "short": {"text": "hi", "max_new_tokens": 100}}
        threads = [
            threading.Thread(target=lambda k=k: outs.__setitem__(
                k, json.loads(_post(srv.port, bodies[k])[1])))
            for k in bodies
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert len(outs["long"]["token_ids"]) == 30
        assert len(outs["short"]["token_ids"]) == 100
        assert eng.batch_calls - batches0 == 2


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_decode_fault_is_delivered_then_engine_recovers(ckpt):
    eng = _engine(ckpt)
    with faults.active("decode:raise"):
        with pytest.raises(faults.InjectedFault):
            eng.generate_text("boom", max_new_tokens=10)
    assert len(eng.generate_text("fine", max_new_tokens=10)["token_ids"]) == 10


def test_checkpoint_round_trip(ckpt, weights, tmp_path):
    state, meta = load_checkpoint(ckpt, GptLM(**CFG, seed=None, device="cpu"))
    assert meta.step == 3 and meta.config["model"] == "gpt_lm"
    assert read_manifest(ckpt) == meta
    for key, arr in params_from_jax(weights).items():
        torch.testing.assert_close(state[key], arr, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(ckpt, GptLM(**{**CFG, "hidden_size": 64}, seed=None,
                                    device="cpu"))


def _port_files():
    return sorted((ROOT / "mlapi_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


# Modules of the training slice, which must be among those scanned.
TRAINING_SLICE = (
    "chip_smoke.py", "mlapi_tpu_torch/config.py",
    "mlapi_tpu_torch/datasets/__init__.py", "mlapi_tpu_torch/datasets/sst2.py",
    "mlapi_tpu_torch/models/bert.py",
    "mlapi_tpu_torch/ops/cuda/flash_attention.py",
    "mlapi_tpu_torch/text/tokenizer.py", "mlapi_tpu_torch/train/__init__.py",
    "mlapi_tpu_torch/train/__main__.py", "mlapi_tpu_torch/train/loop.py",
    "mlapi_tpu_torch/utils/vocab.py",
    # The Llama slice.
    "mlapi_tpu_torch/models/llama.py", "mlapi_tpu_torch/datasets/_corpus.py",
    "mlapi_tpu_torch/datasets/textlm.py",
    # The scheduler slice.
    "mlapi_tpu_torch/serving/scheduler.py",
)


def test_no_module_imports_jax_or_the_jax_package():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(TRAINING_SLICE) <= scanned, set(TRAINING_SLICE) - scanned
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mlapi_tpu", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_serving_stack_imports_without_jax():
    """Every module imports, and the docs_text loader and a Llama's
    greedy stream run, without loading JAX or the JAX package or opening
    any file under ``mlapi_tpu/``."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        f"jax_pkg = os.path.join({str(ROOT)!r}, 'mlapi_tpu') + os.sep\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], str) and "
        "os.path.abspath(args[0]).startswith(jax_pkg):\n"
        "        opened.append(args[0])\n"
        "sys.addaudithook(hook)\n"
        "import mlapi_tpu_torch\n"
        "for m in pkgutil.walk_packages(mlapi_tpu_torch.__path__, "
        "'mlapi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "from mlapi_tpu_torch.datasets import get_dataset\n"
        "from mlapi_tpu_torch.models import get_model\n"
        "splits = get_dataset('docs_text', seq_len=64)\n"
        "assert splits.extras['corpus'].startswith('frozen@')\n"
        "m = get_model('llama_lm', vocab_size=260, hidden_size=32, "
        "num_layers=1, num_heads=4, num_kv_heads=2, device='cpu')\n"
        "ids = torch.as_tensor(splits.x_test[:2, :8]).long()\n"
        "assert m.generate(ids, max_new_tokens=3).shape == (2, 3)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'mlapi_tpu' not in sys.modules\n"
        "assert not opened, opened\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_a_card_unless_asked_for_the_cpu(ckpt, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is runnable")
    monkeypatch.delenv("MLAPI_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextGenerationEngine.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GptLM(**CFG, seed=None)
    from mlapi_tpu_torch.serving.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--checkpoint", str(ckpt), "--port", "0"])
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("MLAPI_TPU_PLATFORM", "cpu")
    assert resolve_device().type == "cpu"
    assert GptLM(**CFG, seed=None).device.type == "cpu"
