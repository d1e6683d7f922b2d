"""The port's ``docs_text`` corpus and the decoder presets that train on
it, against the JAX package (CPU).

- ``docs_text`` gives the JAX package's arrays exactly (frozen snapshot,
  overlapping windows, the live docs), with the same extras and vocab;
  the port's snapshot is a byte-identical copy whose files hash to its
  ``MANIFEST.json``, and a corrupted copy refuses to pass as frozen.
- Three AdamW ``fit`` steps on ``docs-llama`` (batch cut to 8, full
  attention) stay within 1e-5 of JAX ``fit``: the loss, the held-out
  next-token accuracy and every parameter.
- The train CLI's ``run`` on ``docs-llama`` and ``docs-gpt`` writes a
  checkpoint that carries the byte tokenizer and serves ``/generate``
  through the engine with the trained model's greedy stream.
"""

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mlapi_tpu.datasets import get_dataset as jax_get_dataset
from mlapi_tpu.models import get_model as jax_get_model
from mlapi_tpu.text import ByteTokenizer as JaxByteTokenizer
from mlapi_tpu.train import fit as jax_fit
from mlapi_tpu_torch.checkpoint import params_from_jax, read_manifest
from mlapi_tpu_torch.config import get_preset, preset_names
from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.datasets._corpus import corpus_provenance
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.train import fit
from mlapi_tpu_torch.train.__main__ import run

ROOT = Path(__file__).resolve().parents[1]
PORT_SNAPSHOT = ROOT / "mlapi_tpu_torch" / "datasets" / "docs_corpus"
JAX_SNAPSHOT = ROOT / "mlapi_tpu" / "datasets" / "docs_corpus"


@pytest.mark.parametrize("kwargs", [
    dict(), dict(seq_len=64, stride=32), dict(seq_len=96, root="live"),
], ids=["frozen", "overlapping", "live"])
def test_docs_text_equals_the_jax_package(kwargs):
    got = get_dataset("docs_text", **kwargs)
    want = jax_get_dataset("docs_text", **kwargs)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        assert getattr(got, name).dtype == np.int32
    assert got.extras == want.extras
    assert got.extras["task"] == "lm" and got.source == want.source == "real"
    assert got.vocab.labels == want.vocab.labels == ("<lm>",)
    assert got.extras["tokenizer"] == JaxByteTokenizer().fingerprint()


def test_snapshot_is_the_jax_snapshot_and_matches_its_manifest(tmp_path):
    names = sorted(p.name for p in PORT_SNAPSHOT.iterdir())
    assert names == sorted(p.name for p in JAX_SNAPSHOT.iterdir())
    for name in names:
        assert (PORT_SNAPSHOT / name).read_bytes() == (
            JAX_SNAPSHOT / name).read_bytes(), name
    manifest = json.loads((PORT_SNAPSHOT / "MANIFEST.json").read_text())
    for name, meta in manifest["files"].items():
        data = (PORT_SNAPSHOT / name).read_bytes()
        assert hashlib.sha256(data).hexdigest() == meta["sha256"], name
        assert len(data) == meta["bytes"], name
    assert corpus_provenance(PORT_SNAPSHOT) == (
        f"frozen@{manifest['source_commit']}")
    # A corrupted copy raises; a directory whose manifest is not the
    # snapshot's is a user corpus.
    bad = tmp_path / "bad"
    shutil.copytree(PORT_SNAPSHOT, bad)
    (bad / "README.md").write_text("edited")
    with pytest.raises(ValueError, match="corrupted"):
        corpus_provenance(bad)
    (bad / "MANIFEST.json").write_text(json.dumps({"files": {}}))
    assert corpus_provenance(bad) == f"live:{bad}"


def test_three_adamw_fit_steps_match_jax():
    """docs-llama from the JAX package's own init of its seed, at its
    rate (3e-4), batch cut to 8, full attention: after three steps, the
    loss, the held-out next-token accuracy and every parameter.

    Adam divides by the root of its second moment, so an element whose
    first gradient sits at float32 noise moves by a fraction of the rate
    that the noise decides: from a numpy draw of the same distribution,
    one element of ``layer_0.wo`` had a step-1 gradient of 1.5e-9 (the
    median is 3.6e-3) and landed 3.3e-5 apart after three steps, every
    other element within 1e-6."""
    cfg = get_preset("docs-llama")
    jm = jax_get_model(cfg.model, **cfg.model_kwargs)
    params = jax.jit(jm.init)(jax.random.key(cfg.seed))
    model = get_model(cfg.model, **cfg.model_kwargs, seed=None, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    kw = dict(steps=3, batch_size=8, learning_rate=cfg.learning_rate,
              optimizer=cfg.optimizer, seed=cfg.seed)
    # jax fit donates init_params: the port model was loaded first.
    want = jax_fit(jm, jax_get_dataset(cfg.dataset, **cfg.dataset_kwargs),
                   init_params=params, **kw)
    got = fit(model, get_dataset(cfg.dataset, **cfg.dataset_kwargs), **kw)
    assert got.final_loss == pytest.approx(want.final_loss, abs=1e-5)
    assert got.test_accuracy == pytest.approx(want.test_accuracy, abs=1e-5)
    final = params_from_jax(jax.tree.map(np.asarray, want.params))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("preset", ["docs-llama", "docs-gpt"])
def test_cli_checkpoint_carries_the_tokenizer_and_serves(preset, tmp_path):
    assert preset in preset_names()
    cfg = dataclasses.replace(get_preset(preset), steps=2, batch_size=4)
    out = tmp_path / preset
    summary = run(cfg, str(out), device="cpu")
    assert np.isfinite(summary["final_loss"]) and summary["steps"] == 2
    meta = read_manifest(out)
    assert meta.config["model"] == cfg.model
    assert meta.config["tokenizer"] == JaxByteTokenizer().fingerprint()
    assert meta.config["max_len"] == cfg.dataset_kwargs["seq_len"]
    eng = TextGenerationEngine.from_checkpoint(out, device="cpu",
                                               decode_attn_impl="flash")
    text = "The engine batches requests"
    got = eng.generate_text(text, max_new_tokens=8)
    model = eng.model
    model.configure(decode_attn_impl="einsum")
    with torch.inference_mode():
        want = model.generate(
            torch.as_tensor([eng.tokenizer.token_ids(text)]),
            max_new_tokens=8,
        )[0].tolist()
    assert got["token_ids"] == want
