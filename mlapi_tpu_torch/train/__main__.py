"""CLI: train a preset and write a serving-ready checkpoint, or bench it.

    python -m mlapi_tpu_torch.train --preset sst2-bert [--steps N] \\
        [--out DIR] [--save-every N [--keep-last K] [--no-resume]]
    python -m mlapi_tpu_torch.train --preset docs-gpt-draft-distilled \\
        --distill-from TEACHER_DIR --out DIR
    python -m mlapi_tpu_torch.train --preset criteo-widedeep --out DIR
    python -m mlapi_tpu_torch.train --preset sst2-bert --init-from BASE \\
        --lora-rank 8 --out DIR
    python -m mlapi_tpu_torch.train --bench [--preset sst2-bert]
    python -m mlapi_tpu_torch.train --config run.yaml --out DIR

Counterpart of ``python -m mlapi_tpu.train``. Runs on the CUDA device
unless ``MLAPI_TPU_PLATFORM=cpu`` (``utils/platform``). The checkpoint
holds the parameters, the model config, the tokenizer fingerprint, the
sequence length and the label vocab, as the JAX package writes them;
a ``docs-gpt`` / ``docs-llama`` checkpoint serves ``/generate``
(``python -m mlapi_tpu_torch.serving --checkpoint DIR``). With
``--save-every`` the full train state goes to ``<out>_train_state`` (or
the config's ``checkpoint_dir``) and rerunning the same command resumes
from its newest committed step. ``--lora-rank R`` fine-tunes rank-R
LoRA adapters over the frozen model (``--init-from`` supplies the
pretrained base; without it the base is a fresh draw) and writes the
MERGED plain checkpoint, which serves like any other.

Refused, each naming why: ``--mesh-shape`` and ``--bench-attn ring``
(sharding, ROADMAP Queue A item 8) and ``--from-hf`` (it needs a
HuggingFace model directory, which is not in the repository).
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


def run(cfg: TrainConfig, out: str | None, *, save_every: int = 0,
        keep_last: int = 0, resume: bool = True,
        profile_dir: str | None = None, debug_checks: bool = False,
        init_from: str | None = None, lora_rank: int = 0,
        device=None) -> dict:
    """Train ``cfg`` on ``device`` (default: CUDA, see
    ``utils/platform``) and write the checkpoint to ``out``. Returns the
    run's summary; ``step_ms`` and ``step_losses`` list each step this
    process ran (from ``start_step``, past a resumed train state).
    ``lora_rank`` fine-tunes LoRA adapters over the frozen model (its
    ``init_from`` weights) and writes the merged plain tree."""
    from mlapi_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
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
    init_params = None
    if init_from:
        # The tree-signature check refuses another architecture.
        init_params, _ = load_checkpoint(init_from, model)
        _log.info("initialised from checkpoint %s", init_from)
    if lora_rank:
        from mlapi_tpu_torch.models.lora import LoraModel

        if init_params is not None:
            model.load_state_dict(init_params)
            init_params = None
        model = LoraModel(model, rank=lora_rank, seed=cfg.seed)
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
    train_state_dir = cfg.checkpoint_dir or (f"{out}_train_state" if out
                                             else None)
    if save_every and not train_state_dir:
        raise ValueError(
            "--save-every needs somewhere to write train state: pass --out "
            "or set checkpoint_dir in the config"
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
        checkpoint_dir=train_state_dir if save_every else None,
        save_every=save_every,
        keep_last=keep_last,
        resume=resume,
        profile_dir=profile_dir,
        debug_checks=debug_checks,
        init_params=init_params,
        distill_from=cfg.distill_from,
        distill_temperature=cfg.distill_temperature,
        distill_alpha=cfg.distill_alpha,
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
        # A LoRA run checkpoints the MERGED plain tree: serving needs
        # no LoRA awareness.
        save_checkpoint(out, model.merge_params() if lora_rank else model,
                        step=result.steps, config=ckpt_config,
                        vocab=splits.vocab)
        _log.info("checkpoint written to %s", out)
    return {
        "name": cfg.name,
        "steps": result.steps,
        "start_step": result.start_step,
        "wall_seconds": result.wall_seconds,
        "first_loss": result.step_losses[0] if result.step_losses else None,
        "final_loss": result.final_loss,
        "test_accuracy": result.test_accuracy,
        "dataset_source": splits.source,
        "device": str(model.device),
        "checkpoint": out,
        "step_ms": result.step_ms,
        "step_losses": result.step_losses,
        "opt_state_bytes": result.opt_state_bytes,
    }


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("mlapi_tpu_torch.train")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--preset", choices=preset_names(),
                       help="a ported preset by name")
    group.add_argument("--config", help="path to a TrainConfig YAML")
    parser.add_argument("--out", help="checkpoint output dir")
    parser.add_argument("--steps", type=int, default=None,
                        help="override the config's steps")
    parser.add_argument(
        "--bench", action="store_true",
        help="measure step time / examples/s / MFU instead of training "
             "(one JSON line per preset; with --preset, that one)")
    parser.add_argument("--bench-steps", type=int, default=10,
                        help="measured steps per preset in --bench mode")
    parser.add_argument("--bench-batch", type=int, default=None,
                        help="override the preset's batch size in --bench "
                             "mode")
    parser.add_argument("--bench-attn", choices=["full", "flash", "ring"],
                        default=None,
                        help="override the preset's attention_impl in "
                             "--bench mode (ring: not ported)")
    parser.add_argument("--mesh-shape", default=None,
                        help="a device mesh: not ported (ROADMAP Queue A "
                             "item 8)")
    parser.add_argument("--save-every", type=int, default=0,
                        help="checkpoint the full train state every N steps "
                             "(enables resume)")
    parser.add_argument("--keep-last", type=int, default=0,
                        help="keep only the newest N committed train-state "
                             "checkpoints (0 keeps all)")
    parser.add_argument("--no-resume", action="store_true",
                        help="ignore existing train-state checkpoints")
    parser.add_argument("--debug-checks", action="store_true",
                        help="raise at the first op that produces a NaN, or "
                             "on a non-finite loss, gradient or moment "
                             "(a host sync per step)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "training loop to DIR/trace.json")
    parser.add_argument("--init-from", default=None,
                        help="start from this checkpoint's weights (the "
                             "architecture must match)")
    parser.add_argument("--distill-from", default=None,
                        help="distill from this teacher checkpoint's "
                             "softened logits (e.g. --preset "
                             "docs-gpt-draft-distilled --distill-from "
                             "<docs-gpt checkpoint>)")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="LoRA fine-tune at this rank: only low-rank "
                             "adapters train (the frozen base keeps no "
                             "optimizer state); the checkpoint is the "
                             "merged plain tree, served unchanged. Combine "
                             "with --init-from to adapt a pretrained model")
    parser.add_argument("--from-hf", default=None,
                        help="a local HuggingFace BERT directory: not in the "
                             "repository, refused")
    return parser


def parse_args(argv=None) -> tuple[TrainConfig | None, dict]:
    """``(config, run keywords)`` of a training command line, or
    ``(None, bench keywords)`` for ``--bench``; the refusals raise as
    parser errors."""
    parser = _parser()
    args = parser.parse_args(argv)
    if args.mesh_shape:
        parser.error("--mesh-shape: sharded training is not ported (ROADMAP "
                     "Queue A item 8)")
    if args.bench_attn == "ring":
        parser.error("--bench-attn ring: ring attention is not ported "
                     "(ROADMAP Queue A item 8)")
    if args.from_hf:
        parser.error("--from-hf needs a local HuggingFace BERT directory "
                     "(config.json and weights), which is not in the "
                     "repository; use --init-from with a port checkpoint")
    if args.bench:
        from mlapi_tpu_torch.train.bench import DEFAULT_BENCH_PRESETS

        if args.config:
            targets = [TrainConfig.from_yaml(args.config)]
        elif args.preset:
            targets = [get_preset(args.preset)]
        else:
            targets = [get_preset(p) for p in DEFAULT_BENCH_PRESETS
                       if p in preset_names()]
        if args.bench_attn is not None:
            targets = [dataclasses.replace(
                t, model_kwargs={**t.model_kwargs,
                                 "attention_impl": args.bench_attn})
                for t in targets]
        return None, {"targets": targets, "bench_steps": args.bench_steps,
                      "batch_size": args.bench_batch}
    if not args.preset and not args.config:
        parser.error("need --preset, --config, or --bench")
    cfg = (get_preset(args.preset) if args.preset
           else TrainConfig.from_yaml(args.config))
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, steps=args.steps)
    if args.distill_from is not None:
        cfg = dataclasses.replace(cfg, distill_from=args.distill_from)
    if cfg.distill_required and cfg.distill_from is None:
        parser.error(
            f"preset {cfg.name!r} is a DISTILLATION config: running it "
            "without --distill-from <teacher checkpoint> would silently "
            "train a plain hard-label model under a 'distilled' name"
        )
    return cfg, {"out": args.out, "save_every": args.save_every,
                 "keep_last": args.keep_last, "resume": not args.no_resume,
                 "profile_dir": args.profile_dir,
                 "debug_checks": args.debug_checks,
                 "init_from": args.init_from, "lora_rank": args.lora_rank}


def main(argv=None) -> None:
    cfg, kwargs = parse_args(argv)
    if cfg is None:
        from mlapi_tpu_torch.train.bench import bench_train

        for t in kwargs["targets"]:
            print(json.dumps(bench_train(
                t, bench_steps=kwargs["bench_steps"],
                batch_size=kwargs["batch_size"])))
        return
    summary = run(cfg, kwargs.pop("out"), **kwargs)
    summary.pop("step_ms")
    summary.pop("step_losses")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
