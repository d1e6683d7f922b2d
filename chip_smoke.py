#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels build from
``mlapi_tpu_torch/csrc`` at first use). It imports nothing of JAX or of
the JAX package. Phases, each fatal on failure:

1. device — the card's name, count, and ``nvidia-smi`` name + power
   limit;
2. build — ``nvcc`` for ``sm_90a``, printing ``ptxas -v`` and seconds;
3. kernels — flash-decode (B1) and flash-extend (B2), bf16 and int8
   caches, at the shapes the serving phase gives them and at the full
   1024-token window: each wrapper against its plain PyTorch version
   (max abs error on live rows <= 2e-2), timed beside the plain
   version, ``scaled_dot_product_attention`` (a yardstick the port
   never calls) and the card's bound for the same work. ``ms`` is
   device time (each call captured in a CUDA graph, graphs replayed in
   turn over enough input copies to defeat the L2, CUDA events);
   ``eager_ms`` is the wrapper called eagerly, host launch costs
   included;
4. serving — for each cache format (none, int8): a seeded GPT-2-small
   checkpoint served with ``--decode-attn-impl flash`` through the
   CLI's engine factory and the HTTP server, sent 8 concurrent short
   prompts (one batch), one NDJSON stream and one prompt longer than the
   largest bucket (chunked prefill); launch counters are zeroed just
   before the requests and read just after. Then an 8-step decode
   chunk at B = 8: wall time per step over five runs without the
   profiler, and one run under ``torch.profiler`` for device time per
   step, kernels per step, the flash-decode kernel's share and the
   device's busy share;
5. correctness — a small float32 model's greedy streams are identical
   through the flash kernels and the einsum oracle, and the
   teacher-forced top-1 agreement of flash with einsum at GPT-2 small
   is reported (floor 0.9).

Stdout: one JSON line per kernel case and per serving run, then the
``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a card, or outside the repo,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # dense tensor-core bf16 peak
TOLERANCE = 2e-2                # bf16, live rows
GPT2_SMALL = dict(                # openai-community/gpt2
    vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
    max_positions=1024, compute_dtype="bfloat16",
)
REPLACES = {
    "decode_attention": "mlapi_tpu/ops/pallas/decode_attention.py:104",
    "extend_attention": "mlapi_tpu/ops/pallas/decode_attention.py:178",
}
SOURCE = "mlapi_tpu_torch/csrc/decode_attention.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _events_ms(step, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        step(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(calls, iters: int = 30) -> float:
    """Eager time per call, host launch costs included: the calls (one
    per input set, in turn) back to back after a warm-up, from CUDA
    events."""
    for f in calls:
        f()
    return _events_ms(lambda i: calls[i % len(calls)](), iters)


def graph_ms(calls, iters: int = 30) -> float:
    """Device time per call: each call is captured once in a CUDA graph
    and the graphs are replayed in turn, so host launch costs drop out;
    CUDA events around the replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for f in calls:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            f()
        graphs.append(g)
    for g in graphs:
        g.replay()
    return _events_ms(lambda i: graphs[i % len(graphs)].replay(), iters)


# -- phase 3: kernels ---------------------------------------------------

def kernel_case(kernel, fmt, b, u, length, pos, seed):
    """Inputs at one serving shape: GPT-2-small heads, a cache holding
    ragged left pads (per-row ``n_pad``), the decode token (or the
    extend span's first token) at slot ``pos``, masks built by the
    model's own mask helpers."""
    import torch

    from mlapi_tpu_torch.models.gpt import (
        decode_valid_and_shift, extend_positions_and_mask,
    )
    from mlapi_tpu_torch.ops.quant import kv_quantize

    h = kvh = 12
    d = 64
    g = torch.Generator().manual_seed(seed)
    dev = "cuda"
    q = torch.randn(b, u, h, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(b, length, kvh, d, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(b, length, kvh, d, generator=g).to(dev, torch.bfloat16)
    n_pad = torch.randint(0, max(1, length // 8), (b,), generator=g).to(dev)
    if kernel == "decode_attention":
        valid, _ = decode_valid_and_shift(length, pos, n_pad)
        mask = valid[:, 0, 0, :]
    else:
        _, valid = extend_positions_and_mask(length, u, pos, n_pad)
        mask = valid[:, 0]
    if fmt == "int8":
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        k, v = {"q": kq, "scale": ks}, {"q": vq, "scale": vs}
    return q, k, v, mask


def case_bytes_flops(q, k, v, mask):
    """The least the function must move and compute on THESE inputs:
    q, the K/V rows of keys some query of the batch row attends (with
    their scales for int8), the mask and the output, each once; 4*D
    FLOPs per (query head, attended key)."""
    b, u, h, d = q.shape
    if isinstance(k, dict):
        kvh = k["q"].shape[2]
        per_key = 2 * kvh * (d * 1 + 4)
    else:
        kvh = k.shape[2]
        per_key = 2 * kvh * d * k.element_size()
    m3 = mask.reshape(b, -1, mask.shape[-1])
    live_keys = int(m3.any(dim=1).sum())
    pairs = int(m3.sum())
    nbytes = (2 * q.numel() * q.element_size() + live_keys * per_key
              + mask.numel() * mask.element_size())
    flops = 4 * d * h * pairs
    return nbytes, flops


def sdpa_fn(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call computing the same
    function (bf16 caches only): a yardstick, never used by the port."""
    import torch
    import torch.nn.functional as F

    b, u, h, d = q.shape
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    m4 = mask.reshape(b, 1, u, mask.shape[-1]).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)


def check_kernels(power):
    import torch

    from mlapi_tpu_torch.ops import cuda as kern

    plain = {
        "decode_attention": kern.decode_attention_plain,
        "extend_attention": kern.extend_attention_plain,
    }
    # (kernel, B, U, L, slot of the first query token): every shape the
    # serving phase gives a kernel, and the full window at B = 8. Short
    # prompts decode at B = 8 in tier 48 (bucket 16 + 32 tokens); the
    # stream decodes alone (B = 1) in tier 48; the long prompt (bucket
    # 384, tier 416) prefills in three 128-token chunks at slots 0, 128,
    # 256 and decodes 16 tokens at slots 384-399, alone. B = 1 gets its
    # own split layout (one 32-key tile per split at L = 416).
    shapes = [
        ("decode_attention", 8, 1, 48, 47),
        ("decode_attention", 1, 1, 48, 47),
        ("decode_attention", 1, 1, 416, 399),
        ("decode_attention", 8, 1, 1024, 1023),
        ("extend_attention", 1, 128, 416, 0),
        ("extend_attention", 1, 128, 416, 256),
        ("extend_attention", 8, 128, 1024, 768),
    ]
    results = []
    for i, (name, b, u, length, pos) in enumerate(shapes):
        for fmt in ("bf16", "int8"):
            q, k, v, mask = kernel_case(name, fmt, b, u, length, pos, seed=i)
            fn = getattr(kern, name)
            out = fn(q, k, v, mask)
            torch.cuda.synchronize()
            ref = plain[name](q, k, v, mask)
            live = mask.reshape(b, -1, length).any(dim=-1)   # [B, U]
            err = float(
                (out.float() - ref.float()).abs()[live].max()
            )
            finite = bool(torch.isfinite(out).all())
            nbytes, flops = case_bytes_flops(q, k, v, mask)
            # Rotate through copies of the inputs so that a launch does
            # not find the previous one's cache in the 50 MB L2 (in
            # serving each layer reads its own cache); at most 8 sets,
            # so the smallest tier's cases stay partly L2-resident.
            sets = [(q, k, v, mask)]
            for s in range(1, min(8, max(2, math.ceil(160e6 / nbytes)))):
                sets.append(kernel_case(name, fmt, b, u, length, pos,
                                        seed=1000 + 10 * i + s))
            calls = [(lambda a=a: fn(*a)) for a in sets]
            kernel_ms = graph_ms(calls)
            eager_ms = cuda_ms(calls)
            plain_ms = graph_ms([(lambda a=a: plain[name](*a)) for a in sets])
            library_ms = None
            if fmt == "bf16":
                library_ms = graph_ms([sdpa_fn(*a) for a in sets])
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            row = {
                "case": "kernel", "kernel": name, "format": fmt,
                "B": b, "U": u, "L": length, "pos": pos,
                "H": 12, "KVH": 12, "D": 64,
                "max_abs_err": err, "finite": finite,
                "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops, "card": power,
            }
            emit(row)
            if not finite or err > TOLERANCE:
                raise SystemExit(
                    f"{name} {fmt} B={b} U={u} L={length}: kernel disagrees "
                    f"with its plain version (max abs err {err}, finite "
                    f"{finite}, tolerance {TOLERANCE})"
                )
            results.append(row)
            del sets
            torch.cuda.empty_cache()
    return results


# -- phase 4: serving ---------------------------------------------------

def make_checkpoint(path: Path) -> Path:
    """A GPT-2-small checkpoint with weights drawn from seed 0."""
    from mlapi_tpu_torch.checkpoint import save_checkpoint
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.text import ByteTokenizer

    # Drawn on the host and written straight to disk; the engine loads it
    # onto the card.
    model = GptLM(**GPT2_SMALL, seed=0, device="cpu")
    return save_checkpoint(path, model, config={
        "model": "gpt_lm", "model_kwargs": GPT2_SMALL,
        "tokenizer": ByteTokenizer().fingerprint(),
    })


def post(port: int, body: dict, timeout: float = 300.0) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise SystemExit(f"/generate answered {r.status}")
        return r.read()


def get(port: int, path: str) -> dict:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=60
    ) as r:
        return json.loads(r.read())


SHORT_PROMPTS = [
    "the quick brown fox", "serving engines batch", "checkpoints commit",
    "kernels read the cache", "the draft proposes", "a card has memory",
    "decode reads the cache", "quantize the kv cache",
]
LONG_PROMPT = ("a prompt longer than the largest bucket prefills in "
               "chunks; ") * 6   # 336 bytes -> bucket 384, 3 chunks


def serve_run(ckpt: Path, kv_quant):
    """One serving run: returns its summary row and the engine."""
    from mlapi_tpu_torch.ops import cuda as kern
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.server import BackgroundServer

    # The CLI's own engine factory (python -m mlapi_tpu_torch.serving
    # --checkpoint ... [--kv-quant int8] --decode-attn-impl flash); a
    # wider batch window so 8 concurrent arrivals form one batch.
    engine = build_engine(ckpt, kv_quant=kv_quant, decode_attn_impl="flash",
                          max_wait_ms=50.0)
    n_new = 32
    with BackgroundServer(build_app(engine)) as srv:
        kern.decode_attention.launches = 0
        kern.extend_attention.launches = 0
        batches0 = engine.batch_calls
        t0 = time.perf_counter()
        outs: list = [None] * len(SHORT_PROMPTS)
        errors: list = []
        barrier = threading.Barrier(len(SHORT_PROMPTS))

        def one(i):
            try:
                barrier.wait()
                outs[i] = json.loads(post(srv.port, {
                    "text": SHORT_PROMPTS[i], "max_new_tokens": n_new,
                }))
            except BaseException as e:  # reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(SHORT_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        batch_s = time.perf_counter() - t0
        if errors or any(o is None for o in outs):
            raise SystemExit(f"concurrent requests failed: {errors}")
        short_batches = engine.batch_calls - batches0
        stream = post(srv.port, {"text": "stream this", "stream": True,
                                 "max_new_tokens": n_new}).decode()
        chunks0 = engine.prefill_chunks
        long_out = json.loads(post(srv.port, {"text": LONG_PROMPT,
                                              "max_new_tokens": 16}))
        long_chunks = engine.prefill_chunks - chunks0
        launches = {
            "decode_attention": kern.decode_attention.launches,
            "extend_attention": kern.extend_attention.launches,
        }
        metrics = get(srv.port, "/metrics")
        health = get(srv.port, "/healthz")

    vocab = GPT2_SMALL["vocab_size"]
    for o in outs + [long_out]:
        ids = o["token_ids"]
        if not all(0 <= t < vocab for t in ids):
            raise SystemExit(f"token id out of range in {ids}")
    if [len(o["token_ids"]) for o in outs] != [n_new] * len(outs):
        raise SystemExit("a short prompt did not get its tokens")
    if short_batches != 1:
        raise SystemExit(f"8 concurrent prompts took {short_batches} batches")
    lines = [json.loads(x) for x in stream.splitlines() if x.strip()]
    if not lines or not lines[-1].get("done"):
        raise SystemExit(f"stream did not end with a done line: {lines[-1:]}")
    streamed = [t for x in lines[:-1] for t in x["token_ids"]]
    if streamed != lines[-1]["token_ids"] or len(streamed) != n_new:
        raise SystemExit("NDJSON chunks disagree with the done line")
    if len(long_out["token_ids"]) != 16 or long_chunks != 3:
        raise SystemExit(
            f"long prompt: {len(long_out['token_ids'])} tokens, "
            f"{long_chunks} prefill chunks (want 16, 3)"
        )
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if metrics["counters"]["generate.prefill_chunks"] < 3:
        raise SystemExit("/metrics lost the prefill chunks")
    row = {
        "case": "serving", "kv_quant": kv_quant or "none",
        "decode_attn_impl": "flash", "device": health["device"],
        "short_batch_s": batch_s, "short_batches": short_batches,
        "stream_lines": len(lines), "long_prefill_chunks": long_chunks,
        "launches": launches,
        "decode_bytes_per_step": metrics["gauges"][
            "generate.decode_bytes_per_step"],
    }
    return row, engine


# -- phase 5: correctness -----------------------------------------------

def check_small_f32():
    """A small float32 model: greedy streams through the flash kernels
    equal the einsum oracle's, for both cache formats."""
    import torch

    from mlapi_tpu_torch.models.gpt import GptLM

    model = GptLM(vocab_size=260, hidden_size=128, num_layers=2,
                  num_heads=2, max_positions=256, compute_dtype="float32",
                  seed=1, device="cuda")
    with torch.no_grad():   # sharper logits than the 0.02 init
        for p in model.parameters():
            if p.ndim == 2:
                p.mul_(10.0)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(4, 260, (4, 40), generator=g).cuda()
    pads = [0, 3, 11, 25]
    streams = {}
    for kvq in ("none", "int8"):
        for impl in ("einsum", "flash"):
            model.configure(kv_quant=kvq, decode_attn_impl=impl)
            with torch.inference_mode():
                out = model.generate(ids, max_new_tokens=48, pad_lens=pads)
            streams[(kvq, impl)] = out.cpu().tolist()
    same = {
        kvq: streams[(kvq, "einsum")] == streams[(kvq, "flash")]
        for kvq in ("none", "int8")
    }
    emit({"case": "f32_greedy_identity", "flash_equals_einsum": same})
    if not all(same.values()):
        raise SystemExit(f"flash and einsum greedy streams differ: {same}")


def agreement(engine, kv_quant):
    """Teacher-forced top-1 agreement of flash (this cache format) with
    the einsum oracle on the full-precision cache, GPT-2 small bf16."""
    import torch

    from mlapi_tpu_torch.ops.quant import kv_greedy_agreement

    tok = engine.tokenizer
    width = max(len(tok.token_ids(p)) for p in SHORT_PROMPTS)
    rows, pads = [], []
    for p in SHORT_PROMPTS:
        ids = tok.token_ids(p)
        rows.append([tok.pad_id] * (width - len(ids)) + ids)
        pads.append(width - len(ids))
    prompt = torch.as_tensor(rows, device=engine.device)
    model = engine.model
    model.configure(decode_attn_impl="einsum")
    agr = kv_greedy_agreement(
        model, prompt, 65, pad_lens=pads,
        quant_overrides={"kv_quant": kv_quant or "none",
                         "decode_attn_impl": "flash"},
    )
    emit({"case": "agreement", "kv_quant": kv_quant or "none",
          "vs": "einsum, kv none", "tokens": 64, "rows": len(rows),
          "top1_agreement": agr})
    if agr < 0.9:
        raise SystemExit(f"flash top-1 agreement {agr} below 0.9")


def profile_decode(engine, runs: int = 5) -> None:
    """Where one serving decode step's time goes: an 8-step decode chunk
    at B = 8 (bucket 16, default tier) through the engine's model. Wall
    time per step without the profiler (``runs`` chunks, each timed
    alone with ``perf_counter`` and a device sync: min, median, max);
    then one chunk under ``torch.profiler`` for the device time of its
    CUDA kernels, their count and the flash-decode kernel's share. The
    device's busy share is profiled device time over unprofiled wall
    time, given for the median and for the extremes of the runs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.models.gpt import decode_chunk_fn, prefill_fn

    model, b, steps = engine.model, 8, 8
    total = engine._cache_len(16, engine.default_max_new_tokens)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(4, 260, (b, 16), generator=g).to(engine.device)
    n_pad = torch.zeros(b, dtype=torch.long, device=engine.device)
    host = dict(temps=np.zeros(b, np.float32), seeds=np.zeros(b, np.int64),
                top_k=np.zeros(b, np.int64), top_p=np.ones(b, np.float32))

    def chunk(cache, tok, pos):
        return decode_chunk_fn(
            model, cache, tok, pos, n_pad, host["temps"], host["seeds"],
            np.ones(b, np.int64), host["top_k"], host["top_p"], chunk=steps,
        )

    with torch.inference_mode():
        tok, cache = prefill_fn(model, prompt, host["seeds"], host["temps"],
                                n_pad, host["top_k"], host["top_p"],
                                total_len=total)
        _, cache, tok = chunk(cache, tok, 16)        # warm
        torch.cuda.synchronize()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            chunk(cache, tok, 16 + steps)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(cache, tok, 16 + steps)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels)
    attn_us = sum(e.device_time_total for e in kernels
                  if "splitk" in e.name)
    walls.sort()
    dev_ms = dev_us / 1e3 / steps
    emit({
        "case": "profile", "B": b, "L": total, "steps": steps,
        "kv_quant": engine.kv_quant, "decode_attn_impl": "flash",
        "wall_ms_per_step": {"min": walls[0], "median": walls[runs // 2],
                             "max": walls[-1], "runs": runs},
        "profiled_wall_ms_per_step": prof_wall,
        "device_ms_per_step": dev_ms if dev_us else "not measured",
        "device_busy_share": {
            "median": dev_ms / walls[runs // 2],
            "min": dev_ms / walls[-1], "max": dev_ms / walls[0],
        } if dev_us else "not measured",
        "kernels_per_step": len(kernels) / steps,
        "flash_decode_share_of_device": (attn_us / dev_us) if dev_us
        else "not measured",
    })


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mlapi_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (mlapi_tpu_torch "
              "not found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    power = smi[0] if smi else "not measured"
    emit({"case": "device", "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvidia_smi": power})

    # 2. build
    from mlapi_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build()
    for b in built.values():
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(line, flush=True)
    emit({"case": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(built)})

    # 3. kernels against their plain versions
    rows = check_kernels(power)

    # 4. serving, 5. correctness
    # Launches per serving path, each path's counts zeroed just before
    # its requests: {kernel: {"none": N, "int8": N}}.
    launches = {"decode_attention": {}, "extend_attention": {}}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ckpt = make_checkpoint(Path(tmp) / "gpt2_small_seed0")
        for kv_quant in (None, "int8"):
            row, engine = serve_run(ckpt, kv_quant)
            emit(row)
            for k in launches:
                launches[k][row["kv_quant"]] = row["launches"][k]
            profile_decode(engine)
            agreement(engine, kv_quant)
            del engine
            torch.cuda.empty_cache()
    check_small_f32()

    summary = []
    for name in ("decode_attention", "extend_attention"):
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine
                        if r["format"] == "bf16" and r["L"] == 1024)
        summary.append({
            # launches: the bf16-cache serving run (the main path); the
            # int8 run's count stands beside it.
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name]["none"],
            "launches_per_path": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        })
    emit({"kernels": summary})
    print(power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
