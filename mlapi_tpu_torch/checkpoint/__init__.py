"""Checkpoint I/O: ``params.npz`` plus the JAX package's manifest, and
train-state step directories."""

from mlapi_tpu_torch.checkpoint.io import (
    CheckpointMeta,
    gc_checkpoints,
    latest_step,
    load_checkpoint,
    load_opt_state,
    opt_state_from_jax,
    params_from_jax,
    read_manifest,
    save_checkpoint,
    step_dir,
    tree_signature,
)

__all__ = [
    "CheckpointMeta",
    "gc_checkpoints",
    "latest_step",
    "load_checkpoint",
    "load_opt_state",
    "opt_state_from_jax",
    "params_from_jax",
    "read_manifest",
    "save_checkpoint",
    "step_dir",
    "tree_signature",
]
