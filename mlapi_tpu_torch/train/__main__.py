"""CLI: train a preset and write a serving-ready checkpoint.

    python -m mlapi_tpu_torch.train --preset sst2-bert [--steps N] \\
        [--out DIR]
    python -m mlapi_tpu_torch.train --preset docs-llama --out DIR
    python -m mlapi_tpu_torch.train --config run.yaml --out DIR

Counterpart of ``python -m mlapi_tpu.train``. Runs on the CUDA device
unless ``MLAPI_TPU_PLATFORM=cpu`` (``utils/platform``). The checkpoint
holds the parameters, the model config, the tokenizer fingerprint, the
sequence length and the label vocab, as the JAX package writes them;
a ``docs-gpt`` / ``docs-llama`` checkpoint serves ``/generate``
(``python -m mlapi_tpu_torch.serving --checkpoint DIR``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from mlapi_tpu_torch.config import TrainConfig, get_preset, preset_names
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("train.main")


def run(cfg: TrainConfig, out: str | None, *, device=None) -> dict:
    """Train ``cfg`` on ``device`` (default: CUDA, see
    ``utils/platform``) and write the checkpoint to ``out``. Returns the
    run's summary; ``step_ms`` lists each step's wall time."""
    from mlapi_tpu_torch.checkpoint import save_checkpoint
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.loop import fit

    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    if splits.source == "synthetic":
        _log.warning(
            "dataset %r is a synthetic stand-in (real files not present); "
            "accuracy numbers are not comparable to published results",
            cfg.dataset,
        )
    model = get_model(cfg.model, **cfg.model_kwargs, seed=cfg.seed,
                      device=device)
    if getattr(model, "input_kind", "tabular") == "text":
        # An id past the embedding table raises in a torch gather (JAX
        # clamps it); catch a tokenizer/model vocab mismatch here.
        max_id = int(splits.x_train.max())
        if max_id >= model.vocab_size:
            raise ValueError(
                f"dataset token ids go up to {max_id} but the model's "
                f"embedding table has only {model.vocab_size} rows — "
                "tokenizer and model vocab_size disagree"
            )
    if cfg.mesh_shape is not None:
        visible = (torch.cuda.device_count() if model.device.type == "cuda"
                   else 1)
        if math.prod(cfg.mesh_shape) <= visible:
            raise NotImplementedError(
                f"config wants mesh {cfg.mesh_shape}: sharded training is "
                "not ported (ROADMAP Queue A item 8)"
            )
        _log.warning(
            "config wants mesh %s but only %d device(s) visible; running "
            "unsharded", cfg.mesh_shape, visible,
        )

    result = fit(
        model, splits,
        steps=cfg.steps,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        optimizer=cfg.optimizer,
        seed=cfg.seed,
        eval_every=cfg.eval_every,
        distill_from=cfg.distill_from,
    )
    _log.info(
        "%s: %d steps in %.2fs, final_loss=%.4f, test_accuracy=%s",
        cfg.name, result.steps, result.wall_seconds, result.final_loss,
        result.test_accuracy,
    )
    if out:
        ckpt_config = {
            "model": cfg.model,
            "model_kwargs": cfg.model_kwargs,
            "feature_names": list(splits.feature_names),
            "train_config": cfg.to_json(),
        }
        if getattr(model, "input_kind", "tabular") == "text":
            # Serving must encode requests as training did.
            ckpt_config["max_len"] = int(splits.x_train.shape[1])
            if "tokenizer" in splits.extras:
                ckpt_config["tokenizer"] = splits.extras["tokenizer"]
        save_checkpoint(out, model, step=result.steps, config=ckpt_config,
                        vocab=splits.vocab)
        _log.info("checkpoint written to %s", out)
    return {
        "name": cfg.name,
        "steps": result.steps,
        "wall_seconds": result.wall_seconds,
        "first_loss": result.step_losses[0] if result.step_losses else None,
        "final_loss": result.final_loss,
        "test_accuracy": result.test_accuracy,
        "dataset_source": splits.source,
        "device": str(model.device),
        "checkpoint": out,
        "step_ms": result.step_ms,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("mlapi_tpu_torch.train")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--preset", choices=preset_names(),
                       help="a ported preset by name")
    group.add_argument("--config", help="path to a TrainConfig YAML")
    parser.add_argument("--out", help="checkpoint output dir")
    parser.add_argument("--steps", type=int, default=None,
                        help="override the config's steps")
    args = parser.parse_args(argv)
    if not args.preset and not args.config:
        parser.error("need --preset or --config")
    cfg = (get_preset(args.preset) if args.preset
           else TrainConfig.from_yaml(args.config))
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, steps=args.steps)
    if cfg.distill_required and cfg.distill_from is None:
        parser.error(
            f"preset {cfg.name!r} is a distillation config; distillation "
            "is not ported (ROADMAP Queue A item 4)"
        )
    summary = run(cfg, args.out)
    summary.pop("step_ms")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
