"""Typed training configs and the preset table (counterpart of
``mlapi_tpu/config.py``, the same fields and the same presets, copied
as data).

A preset shows up (``preset_names``, ``get_preset``) only once both its
model and its dataset are ported (:func:`preset_available`), as in the
JAX package. Every preset's model and dataset are ported. The train CLI
refuses ``docs-gpt-draft-distilled`` without ``--distill-from`` (as the
JAX CLI does); the presets' meshes run unsharded on one card (ROADMAP
Queue A item 8).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class TrainConfig:
    """One training run: model, data, optimization, parallelism."""

    name: str
    model: str
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    dataset: str = "iris"
    dataset_kwargs: dict[str, Any] = field(default_factory=dict)

    steps: int = 500
    batch_size: int | None = None  # None = full batch
    optimizer: str = "adam"
    learning_rate: float = 0.1
    weight_decay: float = 0.0
    seed: int = 0
    eval_every: int = 0

    # Device mesh over (data, model) or (data, fsdp, model); None = one
    # device. The port runs unsharded (ROADMAP Queue A item 8).
    mesh_shape: tuple[int, ...] | None = None

    checkpoint_dir: str | None = None

    # Knowledge distillation from a teacher checkpoint.
    distill_from: str | None = None
    distill_temperature: float = 2.0
    distill_alpha: float = 0.5
    distill_required: bool = False

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape) if self.mesh_shape else None
        return d

    @classmethod
    def from_json(cls, obj: dict) -> "TrainConfig":
        obj = dict(obj)
        if obj.get("mesh_shape") is not None:
            obj["mesh_shape"] = tuple(obj["mesh_shape"])
        return cls(**obj)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "TrainConfig":
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"reading {path} needs PyYAML, which is not installed; "
                "use --preset, or TrainConfig.from_json on a dict"
            ) from None
        with open(path) as f:
            return cls.from_json(yaml.safe_load(f))


_PRESETS: dict[str, TrainConfig] = {}


def register_preset(cfg: TrainConfig) -> TrainConfig:
    if cfg.name in _PRESETS:
        raise ValueError(f"preset {cfg.name!r} already registered")
    _PRESETS[cfg.name] = cfg
    return cfg


def preset_available(cfg: TrainConfig) -> bool:
    """True iff the preset's model and dataset are both ported."""
    from mlapi_tpu_torch.datasets import dataset_registered
    from mlapi_tpu_torch.models import model_registered

    return model_registered(cfg.model) and dataset_registered(cfg.dataset)


def get_preset(name: str) -> TrainConfig:
    try:
        cfg = _PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}"
        ) from None
    if not preset_available(cfg):
        raise ValueError(
            f"preset {name!r} needs model {cfg.model!r} and dataset "
            f"{cfg.dataset!r}, which are not both ported yet"
        )
    return cfg


def preset_names(*, only_available: bool = True) -> list[str]:
    if not only_available:
        return sorted(_PRESETS)
    return sorted(n for n, c in _PRESETS.items() if preset_available(c))


# --- the ladder (the JAX package's presets, as data) --------------------

register_preset(
    TrainConfig(
        name="iris-linear",
        model="linear",
        model_kwargs={"num_features": 4, "num_classes": 3},
        dataset="iris",
        steps=500,
        learning_rate=0.1,
        weight_decay=1e-3,
    )
)

register_preset(
    TrainConfig(
        name="mnist-softmax",
        model="linear",
        model_kwargs={"num_features": 784, "num_classes": 10},
        dataset="mnist",
        steps=2000,
        batch_size=256,
        learning_rate=1e-3,
        eval_every=500,
    )
)

register_preset(
    TrainConfig(
        name="fashion-mlp",
        model="mlp",
        model_kwargs={
            "num_features": 784,
            "num_classes": 10,
            "hidden_dims": [256, 128],
        },
        dataset="fashion_mnist",
        steps=3000,
        batch_size=256,
        learning_rate=1e-3,
        eval_every=500,
        mesh_shape=(8, 1),
    )
)

register_preset(
    TrainConfig(
        name="digits-softmax",
        model="linear",
        model_kwargs={"num_features": 64, "num_classes": 10},
        dataset="digits",
        steps=2000,
        batch_size=256,
        learning_rate=1e-3,
        eval_every=500,
    )
)

register_preset(
    TrainConfig(
        name="digits-mlp",
        model="mlp",
        model_kwargs={
            "num_features": 64,
            "num_classes": 10,
            "hidden_dims": [256, 128],
        },
        dataset="digits",
        steps=3000,
        batch_size=256,
        learning_rate=1e-3,
        eval_every=500,
        mesh_shape=(8, 1),
    )
)

register_preset(
    TrainConfig(
        name="criteo-widedeep",
        model="wide_deep",
        model_kwargs={
            "num_dense": 13,
            "vocab_sizes": [100_000] * 26,
            "embed_dim": 16,
            "hidden_dims": [256, 128],
            "num_classes": 2,
        },
        dataset="criteo",
        steps=2000,
        batch_size=1024,
        optimizer="recsys-sparse-adamw",
        learning_rate=1e-3,
        eval_every=500,
        mesh_shape=(2, 4),
    )
)

register_preset(
    TrainConfig(
        name="sst2-bert",
        model="bert_classifier",
        model_kwargs={
            "bert_preset": "bert-base-uncased", "num_classes": 2,
            "attention_impl": "flash",
        },
        dataset="sst2",
        steps=3000,
        batch_size=32,
        optimizer="adamw",
        learning_rate=2e-5,
        eval_every=500,
        mesh_shape=(2, 4),
    )
)

register_preset(
    TrainConfig(
        name="docsclf-bert",
        model="bert_classifier",
        model_kwargs={
            "vocab_size": 260, "hidden_size": 64, "num_layers": 2,
            "num_heads": 4, "intermediate_size": 128,
            "max_positions": 128, "num_classes": 4,
        },
        dataset="docs_clf",
        dataset_kwargs={"seq_len": 128},
        steps=300,
        batch_size=64,
        optimizer="adamw",
        learning_rate=1e-3,
        eval_every=100,
    )
)

register_preset(
    TrainConfig(
        name="docs-gpt",
        model="gpt_lm",
        model_kwargs={
            "vocab_size": 260, "hidden_size": 128, "num_layers": 2,
            "num_heads": 4, "max_positions": 256,
            "compute_dtype": "float32",
        },
        dataset="docs_text",
        dataset_kwargs={"seq_len": 128},
        steps=300,
        batch_size=64,
        optimizer="adamw",
        learning_rate=3e-4,
        eval_every=100,
    )
)

register_preset(
    TrainConfig(
        name="docs-gpt-draft",
        model="gpt_lm",
        model_kwargs={
            "vocab_size": 260, "hidden_size": 48, "num_layers": 1,
            "num_heads": 4, "max_positions": 256,
            "compute_dtype": "float32",
        },
        dataset="docs_text",
        dataset_kwargs={"seq_len": 128},
        steps=300,
        batch_size=64,
        optimizer="adamw",
        learning_rate=1e-3,
        eval_every=100,
    )
)

register_preset(
    TrainConfig(
        name="docs-gpt-draft-distilled",
        model="gpt_lm",
        model_kwargs={
            "vocab_size": 260, "hidden_size": 48, "num_layers": 1,
            "num_heads": 4, "max_positions": 256,
            "compute_dtype": "float32",
        },
        dataset="docs_text",
        dataset_kwargs={"seq_len": 128},
        steps=600,
        batch_size=64,
        optimizer="adamw",
        learning_rate=1e-3,
        eval_every=200,
        distill_temperature=2.0,
        distill_alpha=0.1,
        distill_required=True,
    )
)

register_preset(
    TrainConfig(
        name="docs-llama",
        model="llama_lm",
        model_kwargs={
            "vocab_size": 260, "hidden_size": 128, "num_layers": 2,
            "num_heads": 4, "num_kv_heads": 2, "max_positions": 256,
            "compute_dtype": "float32",
        },
        dataset="docs_text",
        dataset_kwargs={"seq_len": 128},
        steps=300,
        batch_size=64,
        optimizer="adamw",
        learning_rate=3e-4,
        eval_every=100,
    )
)
