"""``python -m mlapi_tpu_torch.serving``: serve a ``gpt_lm`` or
``llama_lm`` checkpoint.

The generative subset of ``mlapi_tpu/serving/__main__.py``::

    python -m mlapi_tpu_torch.serving --checkpoint DIR \\
        [--kv-quant int8] [--decode-attn-impl flash] \\
        [--kv-page-size 16 [--kv-pages N]] \\
        [--max-batch N] [--host H] [--port P] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` (or
``MLAPI_TPU_PLATFORM=cpu``) asks for the CPU, and fails when there is
no card and no such request. SIGTERM or SIGINT stop the server.
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
                 kv_pages=None, **kwargs):
    """The engine the CLI serves, from a checkpoint dir and the CLI's
    options (``None`` keeps the checkpoint's / engine's default)."""
    if max_batch is not None:
        kwargs["max_batch"] = max_batch
    if kv_page_size is not None:
        kwargs["kv_page_size"] = kv_page_size
    if kv_pages is not None:
        kwargs["kv_pages"] = kv_pages
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
        "--device", choices=["cuda", "cpu"], default=None,
        help="where to run (default: cuda; MLAPI_TPU_PLATFORM=cpu also "
             "selects the CPU)",
    )
    args = parser.parse_args(argv)
    if args.kv_pages is not None and args.kv_page_size is None:
        parser.error("--kv-pages requires --kv-page-size")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    engine = build_engine(
        args.checkpoint, device=args.device, kv_quant=args.kv_quant,
        decode_attn_impl=args.decode_attn_impl, max_batch=args.max_batch,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
    )
    server = Server(build_app(engine), host=args.host, port=args.port)

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
