"""Checkpoint I/O: ``params.npz`` plus the JAX package's manifest."""

from mlapi_tpu_torch.checkpoint.io import (
    CheckpointMeta,
    load_checkpoint,
    params_from_jax,
    read_manifest,
    save_checkpoint,
    tree_signature,
)

__all__ = [
    "CheckpointMeta",
    "load_checkpoint",
    "params_from_jax",
    "read_manifest",
    "save_checkpoint",
    "tree_signature",
]
