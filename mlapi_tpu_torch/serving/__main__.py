"""``python -m mlapi_tpu_torch.serving``: serve checkpoints over HTTP.

Counterpart of ``mlapi_tpu/serving/__main__.py``::

    python -m mlapi_tpu_torch.serving --checkpoint DIR \\
        [--model ID=CHECKPOINT ...] [--max-batch N] [--max-wait-ms MS] \\
        [--kv-quant int8] [--decode-attn-impl flash] \\
        [--kv-page-size 16 [--kv-pages N]] \\
        [--kv-tier-bytes B [--kv-tier-disk-dir DIR]] [--sched-max-batches 2] \\
        [--default-deadline-ms MS] [--no-admission-control] \\
        [--drain-timeout-s S] [--quantize int8] \\
        [--draft-checkpoint DIR [--spec-sample]] \\
        [--adapter-slots N [--adapter ID=PATH ...] \\
         [--adapter-store-bytes B] [--adapter-disk-dir DIR]] \\
        [--tenant-pages T=N ...] [--tenant-slots T=N ...] \\
        [--tenant-weight T=W ...] [--host H] [--port P] [--device cpu]
    python -m mlapi_tpu_torch.serving --demo-iris

A classifier checkpoint (``linear``, ``mlp``, ``wide_deep``,
``bert_classifier``) serves ``POST /predict`` and ``/files/``; a
``gpt_lm`` / ``llama_lm`` one ``POST /generate``. ``--demo-iris``
trains the ``iris-linear`` preset in process and serves it. Each
``--model ID=CHECKPOINT`` adds an entry served at
``/models/ID/{predict|generate}`` in the same process; the
``--checkpoint`` (or demo) model stays the default, and a classifier's
batches run as score units on the default generative engine's
scheduler. The cache and scheduler flags configure the default model.

It runs on the CUDA device unless ``--device cpu`` (or
``MLAPI_TPU_PLATFORM=cpu``) asks for the CPU, and fails when there is
no card and no such request. SIGTERM or SIGINT drain the server (new
requests 503, ``/healthz`` draining, in-flight work gets
``--drain-timeout-s`` to finish) and stop it. ``--quantize int8``
serves int8 weights; ``--draft-checkpoint`` speculates with a smaller
same-tokenizer checkpoint as the draft (solo greedy rows and freshly
formed all-greedy batches; ``--spec-sample`` adds sampled solo rows);
``--adapter-slots`` serves per-tenant LoRA adapters
(``--adapter ID=PATH`` preloads one from its wire-format file), and the
tenant flags set per-tenant quotas and weights. ``--kv-tier-bytes``
keeps evicted prefix KV in host memory (``--kv-tier-disk-dir``: in
``.npz`` files) and restores it with no prefill. ``--workers`` and
``--router`` are refused with the ROADMAP item that will bring them.
"""

from __future__ import annotations

import argparse
import asyncio
import re
import signal
import tempfile

from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import GENERATIVE_MODELS, InferenceEngine
from mlapi_tpu_torch.serving.server import Server
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.main")

# Flags of the JAX CLI that the port does not serve yet, by ROADMAP
# Queue A item: refused, never ignored.
_REFUSED = {
    "workers": ("--workers", 7),
    "router": ("--router", 7),
}


def build_engine(checkpoint, *, device=None, kv_quant=None,
                 decode_attn_impl=None, max_batch=None, kv_page_size=None,
                 kv_pages=None, sched_max_batches=None, quantize=None,
                 draft_checkpoint=None, spec_sample=False, kv_tier_bytes=0,
                 kv_tier_disk_dir=None, **kwargs):
    """The engine the CLI serves from a checkpoint dir: a generative
    engine with the CLI's cache, host-tier, scheduler, speculation and
    adapter options (``None`` keeps the engine's default), or a
    classifier's engine, which refuses the cache, tier and adapter
    options and ignores the speculation ones, as the JAX package does
    (``InferenceEngine.from_checkpoint``). ``quantize="int8"`` serves
    either with int8 weights."""
    from mlapi_tpu_torch.checkpoint import read_manifest

    if read_manifest(checkpoint).config.get("model") in GENERATIVE_MODELS:
        if max_batch is not None:
            kwargs["max_batch"] = max_batch
        if sched_max_batches is not None:
            kwargs["sched_max_batches"] = sched_max_batches
        if draft_checkpoint is not None:
            kwargs["draft_checkpoint"] = draft_checkpoint
            kwargs["spec_sample"] = bool(spec_sample)
    if kv_tier_bytes or kv_tier_disk_dir:
        kwargs["kv_tier_bytes"] = kv_tier_bytes
        kwargs["kv_tier_disk_dir"] = kv_tier_disk_dir
    return InferenceEngine.from_checkpoint(
        checkpoint, device=device, kv_quant=kv_quant,
        decode_attn_impl=decode_attn_impl, kv_page_size=kv_page_size,
        kv_pages=kv_pages, quantize=quantize, **kwargs,
    )


def register_adapters(parser, engine, specs) -> None:
    """Preload each ``--adapter ID=PATH`` into the engine's host store
    (device slots install at the tenant's first request); the file's
    embedded id must be ``ID`` (``parser.error`` otherwise)."""
    from mlapi_tpu_torch.serving.adapter_store import load_adapter

    for spec in specs or ():
        aid, _, path = spec.partition("=")
        if not aid or not path:
            parser.error(f"--adapter {spec!r}: expected ID=PATH")
        try:
            file_aid, payload, rank, nbytes = load_adapter(path)
        except (OSError, ValueError) as e:
            parser.error(f"--adapter {spec!r}: {e}")
        if file_aid != aid:
            parser.error(
                f"--adapter {spec!r}: file embeds adapter id "
                f"{file_aid!r} — ids must match (rename the export, "
                "not the flag)"
            )
        engine.register_adapter(aid, payload)
        _log.info("preloaded adapter %r (rank %d, %d bytes)", aid, rank,
                  nbytes)


def build_tenants(parser, args):
    """The ``TenantLedger`` of the tenant flags, or None when none is
    given (``parser.error`` on a malformed or duplicate entry)."""
    if not (args.tenant_pages or args.tenant_slots or args.tenant_weight):
        return None
    from mlapi_tpu_torch.serving.registry import TenantLedger, parse_tenant_kv

    try:
        return TenantLedger(
            quota_pages=parse_tenant_kv(args.tenant_pages, "--tenant-pages"),
            quota_slots=parse_tenant_kv(args.tenant_slots, "--tenant-slots"),
            weights=parse_tenant_kv(args.tenant_weight, "--tenant-weight",
                                    cast=float),
        )
    except ValueError as e:
        parser.error(str(e))


def demo_iris_checkpoint(device=None) -> str:
    """Train the ``iris-linear`` preset on ``device`` and write its
    checkpoint to a new temporary directory; returns the path."""
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.train.__main__ import run

    path = tempfile.mkdtemp(prefix="mlapi_tpu_torch_iris_")
    summary = run(get_preset("iris-linear"), path, device=device)
    _log.info("demo Iris trained: test_accuracy=%.4f",
              summary["test_accuracy"])
    return path


def parse_model_specs(parser, specs) -> list[tuple[str, str, str]]:
    """``(spec, id, checkpoint)`` of each ``--model ID=CHECKPOINT``,
    checked as the JAX CLI checks them (``parser.error`` on a bad one)."""
    out: list[tuple[str, str, str]] = []
    for spec in specs or ():
        mid, _, mpath = spec.partition("=")
        mid = mid.strip()
        if not mid or not mpath:
            parser.error(f"--model {spec!r}: expected ID=CHECKPOINT")
        if not re.fullmatch(r"[A-Za-z0-9._-]+", mid):
            parser.error(f"--model {spec!r}: id must be URL-path-safe "
                         "([A-Za-z0-9._-]+)")
        if mid == "default" or mid in {m for _, m, _ in out}:
            parser.error(f"--model {spec!r}: duplicate model id")
        out.append((spec, mid, mpath))
    return out


def build_models(parser, model_specs, device=None) -> dict:
    """The extra registry entries, one engine per checked
    ``--model`` spec; a checkpoint that fails to load is a
    ``parser.error``."""
    engines = {}
    for spec, mid, mpath in model_specs:
        try:
            engines[mid] = InferenceEngine.from_checkpoint(mpath,
                                                           device=device)
        except (OSError, ValueError) as e:
            parser.error(f"--model {spec!r}: {e}")
    return engines


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("mlapi_tpu_torch.serving")
    parser.add_argument("--checkpoint",
                        help="a checkpoint dir (MANIFEST.json + "
                             "params.npz): a classifier or a gpt_lm / "
                             "llama_lm")
    parser.add_argument("--demo-iris", action="store_true",
                        help="train the iris-linear preset now and serve "
                             "it")
    parser.add_argument(
        "--model", action="append", metavar="ID=CHECKPOINT",
        help="multi-model serving (repeatable): add model ID from "
             "CHECKPOINT, served at /models/ID/{predict|generate}; the "
             "--checkpoint model stays the default (id 'default', the "
             "/predict or /generate route). A classifier's batches run "
             "as score units on the default generative engine's unit "
             "scheduler",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-wait-ms", type=float, default=0.2,
                        help="the scoring micro-batch window")
    parser.add_argument(
        "--kv-quant", choices=["int8"], default=None,
        help="store KV caches as int8 payload + per-token-per-head f32 "
             "scales (about half the cache bytes)",
    )
    parser.add_argument(
        "--decode-attn-impl", choices=["einsum", "flash"], default=None,
        help="cache-read attention: 'einsum' (the reference; dequantizes "
             "an int8 cache at the read) or 'flash' (the CUDA split-K "
             "kernels, which read the stored cache in-kernel)",
    )
    parser.add_argument(
        "--kv-page-size", type=int, default=None,
        help="paged KV cache: a device pool of pages of this many tokens "
             "plus per-row page tables, instead of one contiguous cache "
             "per batch (flash reads pages in place)",
    )
    parser.add_argument(
        "--kv-pages", type=int, default=None,
        help="with --kv-page-size: pool pages, the null page included "
             "(default: max_batch slots at the default cache tier). A "
             "full pool answers 503 with retry-after",
    )
    parser.add_argument(
        "--kv-tier-bytes", type=int, default=0,
        help="hierarchical KV tier: keep up to this many bytes of "
             "EVICTED prefix KV page sets in host RAM (LRU), in their "
             "stored format (--kv-quant int8 halves the spill "
             "bandwidth) — a re-arrival restores them with zero prefill "
             "FLOPs instead of paying a cold prefill; streams are "
             "token-identical across evict+restore vs never-evicted. "
             "0 (default) disables the tier: evictions discard. Watch "
             "generate.kv_prefix_restore_hits / kv_tier_bytes_in_use on "
             "/metrics. Generative checkpoints only",
    )
    parser.add_argument(
        "--kv-tier-disk-dir", default=None,
        help="with --kv-tier-bytes: back the tier's blob payloads with "
             ".npz files under this directory (only the index stays in "
             "RAM; the bytes budget then bounds disk use). Files are "
             "per-process and inert across restarts — a stale blob that "
             "no longer matches the live pool geometry is dropped, never "
             "restored wrong",
    )
    parser.add_argument(
        "--sched-max-batches", type=int, default=2,
        help="how many batches may be live at once (lanes of the unit "
             "scheduler, their units interleaved); 1 runs one batch at a "
             "time on the same machinery. A paged engine also starts a "
             "lane only if its worst-case pages fit beside the live "
             "lanes' (generate.sched_pages_deferred counts waits)",
    )
    parser.add_argument(
        "--default-deadline-ms", type=float, default=None,
        help="wall-clock budget of requests that name no deadline_ms: "
             "expiry at any dispatch boundary ends the request with a "
             "deadline_exceeded frame (504 unary). Default: none",
    )
    parser.add_argument(
        "--admission-control", action=argparse.BooleanOptionalAction,
        default=True,
        help="shed deadlined requests the latency reservoirs say cannot "
             "finish in time (503 + retry-after), and under queue "
             "pressure clamp max_new_tokens and evict idle prefix pages "
             "(brownout); --no-admission-control turns both off "
             "(deadlines still expire)",
    )
    parser.add_argument(
        "--drain-timeout-s", type=float, default=10.0,
        help="graceful drain on SIGTERM/SIGINT: new requests shed 503 "
             "and /healthz reads draining while in-flight streams "
             "finish; what is still live after this many seconds ends "
             "with a draining frame",
    )
    parser.add_argument(
        "--quantize", choices=["int8"], default=None,
        help="weight-only int8: store every weight matrix as per-channel "
             "symmetric int8 with f32 scales (about a quarter of the f32 "
             "bytes), dequantized at each use; composes with --kv-quant",
    )
    parser.add_argument(
        "--draft-checkpoint", default=None,
        help="speculative decoding: a smaller same-tokenizer checkpoint "
             "whose proposals the target verifies in one block a round "
             "(solo greedy rows and freshly formed all-greedy batches; "
             "generate.spec_* on /metrics)",
    )
    parser.add_argument(
        "--spec-sample", action="store_true",
        help="with --draft-checkpoint: also speculate SAMPLED solo rows "
             "by acceptance-rejection (the target's distribution exactly; "
             "a stream interleaved with admission churn is not "
             "byte-reproducible per seed, a solo run is)",
    )
    parser.add_argument(
        "--adapter-slots", type=int, default=0,
        help="many-adapter LoRA serving: a device slot pool of this many "
             "tenants' (A, B) pairs over the ONE resident base (device "
             "bytes: base + N x generate.adapter_slot_bytes). Requests "
             "name a tenant in the 'adapter' field; mixed-tenant batches "
             "apply per-row deltas by gathered BGMV. 0 (default) turns "
             "the subsystem off. Generative checkpoints only",
    )
    parser.add_argument(
        "--adapter-store-bytes", type=int, default=0,
        help="with --adapter-slots: the host adapter store's LRU byte "
             "budget (default 256 MiB); evicted slots refill from it",
    )
    parser.add_argument(
        "--adapter-disk-dir", default=None,
        help="with --adapter-slots: spill directory of the host adapter "
             "store (pid-scoped files, stale ones swept at start)",
    )
    parser.add_argument(
        "--adapter", action="append", default=None, metavar="ID=PATH",
        help="preload an adapter into the host store at startup "
             "(repeatable): PATH is an adapter file in the wire format "
             "(serving/adapter_store.save_adapter) registered under ID; "
             "the file's embedded id must match",
    )
    parser.add_argument(
        "--tenant-pages", action="append", metavar="TENANT=N",
        help="per-tenant KV page quota (repeatable; paged engines): a "
             "tenant holding reservations may not grow past N pages; "
             "further group starts defer (generate."
             "sched_tenant_pages_deferred, tenant.<t>.deferrals) until "
             "its own pages free. Unlisted tenants are unquotaed",
    )
    parser.add_argument(
        "--tenant-slots", action="append", metavar="TENANT=N",
        help="per-tenant adapter-slot quota (repeatable; with "
             "--adapter-slots): the same deferral over device adapter "
             "slots",
    )
    parser.add_argument(
        "--tenant-weight", action="append", metavar="TENANT=W",
        help="per-tenant scheduling weight (repeatable; default 1.0): "
             "deadline slack divides by W in the unit scheduler's pick, "
             "so a weight-2 tenant's requests look twice as urgent at "
             "equal slack",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default=None,
        help="where to run (default: cuda; MLAPI_TPU_PLATFORM=cpu also "
             "selects the CPU)",
    )
    for dest, (flag, _) in _REFUSED.items():
        parser.add_argument(flag, dest=dest, default=None,
                            action=("store_true" if flag in ("--router",)
                                    else "store"),
                            help=argparse.SUPPRESS)
    return parser


def parse_args(argv=None, parser=None):
    """The CLI's arguments, checked (``parser.error`` on a refused or
    inconsistent flag, or a malformed ``--model``)."""
    parser = parser or make_parser()
    args = parser.parse_args(argv)
    for dest, (flag, item) in _REFUSED.items():
        if getattr(args, dest) not in (None, False):
            parser.error(f"{flag} is not ported (ROADMAP Queue A item "
                         f"{item})")
    if bool(args.checkpoint) == bool(args.demo_iris):
        parser.error("need exactly one of --checkpoint and --demo-iris")
    if args.kv_pages is not None and args.kv_page_size is None:
        parser.error("--kv-pages requires --kv-page-size")
    if args.sched_max_batches < 1:
        parser.error("--sched-max-batches must be >= 1")
    if args.kv_tier_disk_dir and not args.kv_tier_bytes:
        parser.error("--kv-tier-disk-dir requires --kv-tier-bytes > 0")
    if (args.adapter_store_bytes or args.adapter_disk_dir
            or args.adapter) and not args.adapter_slots:
        parser.error("--adapter-store-bytes/--adapter-disk-dir/--adapter "
                     "require --adapter-slots > 0")
    args.model_specs = parse_model_specs(parser, args.model)
    return args


def main(argv=None) -> int:
    from mlapi_tpu_torch.serving.registry import ModelRegistry

    parser = make_parser()
    args = parse_args(argv, parser)
    checkpoint = args.checkpoint or demo_iris_checkpoint(args.device)
    engine = build_engine(
        checkpoint, device=args.device, kv_quant=args.kv_quant,
        decode_attn_impl=args.decode_attn_impl, max_batch=args.max_batch,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
        sched_max_batches=args.sched_max_batches, quantize=args.quantize,
        draft_checkpoint=args.draft_checkpoint, spec_sample=args.spec_sample,
        kv_tier_bytes=args.kv_tier_bytes,
        kv_tier_disk_dir=args.kv_tier_disk_dir,
        **({"adapter_slots": args.adapter_slots,
            "adapter_store_bytes": args.adapter_store_bytes,
            "adapter_disk_dir": args.adapter_disk_dir}
           if args.adapter_slots else {}),
    )
    register_adapters(parser, engine, args.adapter)
    extra = build_models(parser, args.model_specs, device=args.device)
    app = build_app(
        models=ModelRegistry({"default": engine, **extra}),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        default_deadline_ms=args.default_deadline_ms,
        drain_timeout_s=args.drain_timeout_s,
        admission_control=args.admission_control,
        tenants=build_tenants(parser, args),
    )
    server = Server(app, host=args.host, port=args.port)

    async def _run() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await server.start()
        try:
            await stop.wait()
        finally:
            await server.stop()

    asyncio.run(_run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
