"""``python -m mlapi_tpu_torch.serving``: serve a ``gpt_lm`` or
``llama_lm`` checkpoint.

The generative subset of ``mlapi_tpu/serving/__main__.py``::

    python -m mlapi_tpu_torch.serving --checkpoint DIR \\
        [--kv-quant int8] [--decode-attn-impl flash] \\
        [--kv-page-size 16 [--kv-pages N]] [--sched-max-batches 2] \\
        [--default-deadline-ms MS] [--no-admission-control] \\
        [--drain-timeout-s S] \\
        [--max-batch N] [--host H] [--port P] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` (or
``MLAPI_TPU_PLATFORM=cpu``) asks for the CPU, and fails when there is
no card and no such request. SIGTERM or SIGINT drain the server (new
requests 503, ``/healthz`` draining, in-flight streams get
``--drain-timeout-s`` to finish) and stop it.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from mlapi_tpu_torch.serving.app import build_app
from mlapi_tpu_torch.serving.engine import TextGenerationEngine
from mlapi_tpu_torch.serving.server import Server


def build_engine(checkpoint, *, device=None, kv_quant=None,
                 decode_attn_impl=None, max_batch=None, kv_page_size=None,
                 kv_pages=None, sched_max_batches=None, **kwargs):
    """The engine the CLI serves, from a checkpoint dir and the CLI's
    options (``None`` keeps the checkpoint's / engine's default)."""
    if max_batch is not None:
        kwargs["max_batch"] = max_batch
    if kv_page_size is not None:
        kwargs["kv_page_size"] = kv_page_size
    if kv_pages is not None:
        kwargs["kv_pages"] = kv_pages
    if sched_max_batches is not None:
        kwargs["sched_max_batches"] = sched_max_batches
    return TextGenerationEngine.from_checkpoint(
        checkpoint, device=device, kv_quant=kv_quant,
        decode_attn_impl=decode_attn_impl, **kwargs,
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser("mlapi_tpu_torch.serving")
    parser.add_argument("--checkpoint", required=True,
                        help="a gpt_lm or llama_lm checkpoint dir "
                             "(MANIFEST.json + params.npz)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=None)
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
        "--device", choices=["cuda", "cpu"], default=None,
        help="where to run (default: cuda; MLAPI_TPU_PLATFORM=cpu also "
             "selects the CPU)",
    )
    args = parser.parse_args(argv)
    if args.kv_pages is not None and args.kv_page_size is None:
        parser.error("--kv-pages requires --kv-page-size")
    if args.sched_max_batches < 1:
        parser.error("--sched-max-batches must be >= 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    engine = build_engine(
        args.checkpoint, device=args.device, kv_quant=args.kv_quant,
        decode_attn_impl=args.decode_attn_impl, max_batch=args.max_batch,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
        sched_max_batches=args.sched_max_batches,
    )
    app = build_app(
        engine, default_deadline_ms=args.default_deadline_ms,
        drain_timeout_s=args.drain_timeout_s,
        admission_control=args.admission_control,
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
