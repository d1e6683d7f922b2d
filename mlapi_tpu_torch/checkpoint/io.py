"""Checkpoint I/O: ``params.npz`` + the JAX package's ``MANIFEST.json``.

The JAX package stores params with orbax (``mlapi_tpu/checkpoint/io.py``);
orbax and safetensors are not on the machines the port serves from,
so the port writes one ``np.savez`` archive keyed by the JAX key paths
(``layer_0/qkv/kernel``, kernels ``[d_in, d_out]``) beside a manifest
of the same schema: format version, step, config + its hash, and the
structural tree signature (computed exactly as the JAX package does,
so the two packages agree on a parameter tree's signature). The
archive is written first and the manifest last, each through a
temporary name and a rename, so a manifest's presence means a complete
checkpoint.

A classifier's label vocab is stored in the manifest as the JAX package
stores it (``{"labels": [...]}``).

Layout::

    <dir>/MANIFEST.json
    <dir>/params.npz
    <dir>/opt_state.npz      # train state only

A train-state checkpoint (``train.loop.fit`` with ``save_every``) is a
``<root>/step_%08d/`` directory of this layout whose manifest config has
``"kind": "train_state"`` and whose ``opt_state.npz`` holds the
optimizer's moments keyed by moment name and JAX key path (``mu/…``,
``nu/…``, ``acc/…`` for rowwise AdaGrad) and the step ``count``. The
JAX package stores the same state with orbax; :func:`opt_state_from_jax`
carries it across.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mlapi_tpu_torch import __version__ as _framework_version
from mlapi_tpu_torch.utils.vocab import LabelVocab

FORMAT_VERSION = 1
_MANIFEST = "MANIFEST.json"
_PARAMS = "params.npz"
_OPT_STATE = "opt_state.npz"


def _stable_hash(obj: Any) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _flat_np(params) -> dict[str, np.ndarray]:
    """Any of: a module, a dotted state dict, a ``/``-keyed flat dict or
    a nested dict (a JAX pytree) → ``{"a/b/c": float ndarray}``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    flat: dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            path = f"{prefix}{str(key).replace('.', '/')}"
            if isinstance(val, dict):
                walk(val, path + "/")
            elif isinstance(val, torch.Tensor):
                t = val.detach().cpu()
                if t.dtype == torch.bfloat16:
                    t = t.to(torch.float32)  # numpy has no bfloat16
                flat[path] = t.numpy()
            else:
                flat[path] = np.asarray(val)

    walk(params, "")
    return flat


def _key_parts(paths) -> dict[str, tuple[str, ...]]:
    """Each flat path's pytree keys. A LoRA tree (top level ``base`` and
    ``lora``) keys its adapters by the JOINED kernel path
    (``lora/layer_0/qkv/a`` is ``['lora']['layer_0/qkv']['a']``); any
    other path splits at every ``/``."""
    paths = list(paths)
    lora = (any(p.startswith("lora/") for p in paths)
            and all(p.startswith(("base/", "lora/")) for p in paths))
    out = {}
    for path in paths:
        parts = tuple(path.split("/"))
        if lora and parts[0] == "lora" and len(parts) > 3:
            parts = ("lora", "/".join(parts[1:-1]), parts[-1])
        out[path] = parts
    return out


def tree_signature(params) -> str:
    """Structural signature: key paths + shapes + dtypes, hashed as
    ``mlapi_tpu.checkpoint.io.tree_signature`` hashes a pytree (same
    key-string format, same leaf order), quantized (``q``/``scale``
    leaves) and LoRA trees included."""
    flat = _flat_np(params)
    parts = _key_parts(flat)
    leaves = [
        ("".join(f"['{p}']" for p in parts[path]),
         tuple(flat[path].shape), str(flat[path].dtype))
        for path in sorted(flat, key=parts.__getitem__)
    ]
    return _stable_hash(leaves)


def params_from_jax(np_tree) -> dict[str, torch.Tensor]:
    """Carry the JAX package's parameters (a nested dict of numpy
    arrays, or a ``/``-keyed flat dict) into the port's state dict:
    ``layer_0/qkv/kernel`` becomes ``layer_0.qkv.kernel``; kernels keep
    their ``[d_in, d_out]`` orientation. A quantized tree's ``{q,
    scale}`` leaves become ``<path>.q`` / ``<path>.scale`` (a
    ``models/quantized.QuantizedModel``'s keys) and a LoRA tree's
    adapters ``lora.layer_0/qkv.a`` (a ``models/lora.LoraModel``'s)."""
    flat = _flat_np(np_tree)
    parts = _key_parts(flat)
    return {
        ".".join(parts[path]): torch.as_tensor(np.array(arr))
        for path, arr in flat.items()
    }


@dataclass(frozen=True)
class CheckpointMeta:
    """Everything about a checkpoint except the weights."""

    format_version: int
    framework_version: str
    step: int
    created_unix: float
    config: dict
    config_hash: str
    tree_signature: str
    vocab: LabelVocab | None = None

    def to_json(self) -> dict:
        return {
            "format_version": self.format_version,
            "framework_version": self.framework_version,
            "step": self.step,
            "created_unix": self.created_unix,
            "config": self.config,
            "config_hash": self.config_hash,
            "tree_signature": self.tree_signature,
            "vocab": self.vocab.to_json() if self.vocab else None,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "CheckpointMeta":
        return cls(
            format_version=obj["format_version"],
            framework_version=obj["framework_version"],
            step=obj["step"],
            created_unix=obj["created_unix"],
            config=obj["config"],
            config_hash=obj["config_hash"],
            tree_signature=obj["tree_signature"],
            vocab=(LabelVocab.from_json(obj["vocab"]) if obj.get("vocab")
                   else None),
        )


def _write_npz(path: Path, name: str, arrays: dict) -> None:
    tmp = path / f".{name}.tmp.npz"
    np.savez(tmp, **arrays)
    tmp.rename(path / name)


def save_checkpoint(path: str | os.PathLike, params, *, step: int = 0,
                    config: dict | None = None,
                    vocab: LabelVocab | None = None,
                    opt_state: dict | None = None) -> Path:
    """Write a complete checkpoint at ``path``: ``params`` (a module or
    state dict; bf16 leaves are stored as float32), ``config``
    (``{"model": ..., "model_kwargs": ..., "tokenizer": ...}``), the
    label ``vocab`` of a classifier and, for a train state, the flat
    ``opt_state`` (``{"mu/a/b": array, ..., "count": array}``)."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    config = dict(config or {})
    flat = _flat_np(params)
    _write_npz(path, _PARAMS, flat)
    if opt_state is not None:
        _write_npz(path, _OPT_STATE,
                   {k: np.asarray(v) for k, v in opt_state.items()})
    meta = CheckpointMeta(
        format_version=FORMAT_VERSION,
        framework_version=_framework_version,
        step=int(step),
        created_unix=time.time(),
        config=config,
        config_hash=_stable_hash(config),
        tree_signature=tree_signature(flat),
        vocab=vocab,
    )
    tmp = path / f".{_MANIFEST}.tmp"
    tmp.write_text(json.dumps(meta.to_json(), indent=2, sort_keys=True))
    tmp.rename(path / _MANIFEST)
    return path


def read_manifest(path: str | os.PathLike) -> CheckpointMeta:
    """A checkpoint's metadata, without reading the tensors."""
    manifest = Path(path) / _MANIFEST
    if not manifest.exists():
        raise FileNotFoundError(
            f"{path} is not a committed checkpoint (no {_MANIFEST})"
        )
    meta = CheckpointMeta.from_json(json.loads(manifest.read_text()))
    if meta.format_version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{meta.format_version} is newer than this "
            f"framework understands (v{FORMAT_VERSION})"
        )
    return meta


def load_checkpoint(path: str | os.PathLike, model=None):
    """``(state_dict, meta)`` from a checkpoint dir. With ``model``, the
    archive's tree signature must match the model's (as float32
    storage) — loading the wrong model's weights raises instead of
    serving garbage."""
    meta = read_manifest(path)
    with np.load(Path(path) / _PARAMS) as z:
        flat = {k: z[k] for k in z.files}
    if tree_signature(flat) != meta.tree_signature:
        raise ValueError(f"{path}: params.npz does not match its manifest")
    if model is not None:
        expect = {
            k: v.detach().to(torch.float32)
            for k, v in model.state_dict().items()
        }
        if tree_signature(expect) != meta.tree_signature:
            raise ValueError(
                "checkpoint/model mismatch: the model's parameter tree "
                f"differs from the checkpoint's (config {meta.config})"
            )
    return params_from_jax(flat), meta


def load_opt_state(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """The flat optimizer state of a committed train-state checkpoint."""
    read_manifest(path)
    with np.load(Path(path) / _OPT_STATE) as z:
        return {k: z[k] for k in z.files}


def _masked(node) -> bool:
    """optax's ``MaskedNode``: an empty named tuple where a masked
    partition holds no state."""
    return getattr(node, "_fields", None) == ()


def _np_leaves(tree, prefix: str):
    """``(key path, array)`` of a nested dict of arrays, masked leaves
    skipped."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _np_leaves(val, path + "/")
        elif not _masked(val):
            yield path, np.asarray(val)


def opt_state_from_jax(np_state) -> dict[str, np.ndarray]:
    """Carry the JAX package's optimizer state (an optax state as a tree
    of numpy arrays) into the port's flat train-state form (optax's
    ``masked`` state of a LoRA fine-tune included: its ``MaskedNode``
    holes, the frozen base, carry nothing): Adam/AdamW's
    ``ScaleByAdamState`` becomes ``count``, ``mu/<path>``, ``nu/<path>``;
    rowwise-AdaGrad accumulators become ``acc/<path>``, whether they sit
    in ``partitioned``'s ``"embedding"`` partition (``recsys-<base>``) or
    in the sparse step's ``{"base", "acc"}`` dict
    (``recsys-sparse-<base>``). SGD's empty state gives ``{}``. Reads
    the structure by its field names, so it needs no optax."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, acc: bool = False):
        fields = getattr(node, "_fields", None)
        if fields is not None and {"count", "mu", "nu"} <= set(fields):
            flat["count"] = np.asarray(node.count)
            for moment in ("mu", "nu"):
                for path, arr in _np_leaves(getattr(node, moment), ""):
                    flat[f"{moment}/{path}"] = arr
        elif fields is not None and "inner_states" in fields:
            for label, inner in node.inner_states.items():
                walk(inner, acc=label == "embedding")
        elif fields is not None and "inner_state" in fields:
            walk(node.inner_state, acc)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child, acc)
        elif isinstance(node, dict) and set(node) == {"base", "acc"}:
            walk(node["base"])
            walk(node["acc"], acc=True)
        elif isinstance(node, dict) and acc:
            for path, arr in _np_leaves(node, ""):
                flat[f"acc/{path}"] = arr
        elif isinstance(node, dict):
            raise ValueError(
                f"unrecognised optimizer state node with keys {sorted(node)}"
            )

    walk(np_state)
    return flat


def latest_step(root: str | os.PathLike) -> Path | None:
    """Newest committed ``step_*`` dir under ``root`` (resume point)."""
    root = Path(root)
    if not root.exists():
        return None
    newest = max(_committed_steps(root), default=None)
    return newest[1] if newest else None


def step_dir(root: str | os.PathLike, step: int) -> Path:
    return Path(root) / f"step_{step:08d}"


def _committed_steps(root: Path) -> list[tuple[int, Path]]:
    out = []
    for child in root.iterdir():
        if child.name.startswith("step_") and (child / _MANIFEST).exists():
            try:
                out.append((int(child.name.removeprefix("step_")), child))
            except ValueError:
                continue
    return out


def gc_checkpoints(root: str | os.PathLike, keep_last: int) -> list[Path]:
    """Delete all but the newest ``keep_last`` committed ``step_*`` dirs
    under ``root``; returns the deleted paths. An uncommitted dir (no
    manifest: a save in progress) is its writer's and is left alone.
    Deletion unlinks the manifest first, so a crash mid-delete never
    leaves a committed half-checkpoint."""
    import shutil

    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    root = Path(root)
    if not root.exists():
        return []
    committed = sorted(_committed_steps(root))
    doomed = [p for _, p in committed[:-keep_last]]
    for p in doomed:
        (p / _MANIFEST).unlink()
        shutil.rmtree(p, ignore_errors=True)
    return doomed
