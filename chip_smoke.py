#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on an
NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels build from
``mlapi_tpu_torch/csrc`` at first use). It imports nothing of JAX or of
the JAX package. Phases, each fatal on failure:

1. device — the card's name, count, and ``nvidia-smi`` name + power
   limit;
2. build — ``nvcc`` for ``sm_90a``, one process per source, printing
   ``ptxas -v`` and seconds; the build row gives each kernel's registers
   and spill bytes;
3. kernels — flash-decode (B1), flash-extend (B2) and their paged
   twins (B3, B4: 16-token pages behind a shuffled page table, pages no
   query attends on the null page), bf16 and int8 caches, at the shapes
   the serving phase gives them and at the full 1024-token window, and
   for B2/B4 a GQA row (16 query heads on 4 KV heads) and a ragged one
   (U = 100, L = 1000, 8-token pages), for B1/B3 a GQA row, and B1-B4
   rows at Llama-class widths (32 query heads on 8 KV heads of 128),
   docs-gpt's (4 heads of 32; B1/B3 in f32 too), head dims 160,
   256, 320 and 512 (8 query heads on 4 KV heads; B1/B3 at 256 in f32
   too; past 256 every B1-B4 call runs the CUDA-core split-K body in
   256-wide column chunks) and TinyLlama-1.1B's geometry (32 query heads
   on 4 KV heads of 64, a group of 8: B1/B3 at B = 8, L = 2048; B2/B4
   at B = 8, U = 128, L = 2048): each wrapper against
   its plain PyTorch version (max abs error on live rows <= 2e-2, 1e-5
   in f32, exact zeros on rows with no valid key), each paged kernel
   against its contiguous twin over the same bytes (bit for bit); each
   row names the body that ran, read from the wrapper's counters
   (``decode``: the cluster memory pipeline, every B1/B3 call; ``mma``:
   tensor cores; ``fma``), and its share of the bound. Then flash
   attention for training — forward (B5), dq (B6), dk/dv (B7) — at (a)
   the sst2-bert batch (B = 32, L = 128, 12 heads, bf16, its own key
   mask with the last row fully masked), (b) GPT-2 small causal (B = 8,
   L = 1024, bf16), (c) a GQA sliding window in float32, (d) docs-gpt's
   batch (head dim 32, float32, causal), (e) Llama-class causal GQA
   (head dim 128, bf16), causal bf16 rows at head dims 256 and 512
   (8 heads) and 160 and 320 (8 on 4 KV heads; 320 and 512 in two
   256-wide column chunks) and (f) TinyLlama-1.1B's geometry (32 query
   heads on 4 KV heads of 64, causal, B = 4, L = 2048): each against
   its plain version
   (<= 2e-2 bf16, <= 1e-4 f32 on live rows, exact zeros where nothing
   is attended), each row naming the body that ran (``mma``: tensor
   cores, every bf16 call at D <= 128; ``fma``) as the C entry
   point reports it to the wrapper's counters, held to the wrapper's
   mirror of that dispatch. Every kernel
   is timed beside its plain version,
   ``scaled_dot_product_attention`` (a yardstick the port never calls;
   on the gathered contiguous copy for B3/B4; forward + backward minus
   forward for B6/B7, eager as ``library_ms`` and CUDA-graph captured as
   ``library_graph_ms``) and the card's bound for the same work. ``ms`` is
   device time (each call captured in a CUDA graph, graphs replayed in
   turn over enough input copies to defeat the L2, CUDA events: it
   includes the gap between two replays); B1-B4 rows add ``device_ms``,
   the kernels' own durations under ``torch.profiler`` (B5-B7: the
   flash kernels alone, without the wrapper's mask conversion or head-dim
   padding); ``eager_ms`` is the wrapper called eagerly, host launch
   costs included;
4. training — ``python -m mlapi_tpu_torch.train --preset sst2-bert``'s
   ``run`` at full width (BERT-base, batch 32, 128 tokens, AdamW 2e-5,
   random weights from the preset's seed) for 30 steps and its test-set
   evaluation, with the launch counters zeroed just before and read
   just after: B5 exactly 12 per step and per eval batch, B6 and B7 12
   per step, B1-B4 none, every B5, B6 and B7 launch on the tensor-core
   body; the checkpoint it writes
   must read back (tree signature and label vocab). Then one step's
   loss and gradients with flash against full attention from the same
   weights on the same batch, and one profiled step (device time,
   kernels per step, the B5-B7 share, the device's busy share against
   unprofiled wall time);
5. serving — for each cache format (none, int8) and each layout
   (contiguous, then paged with ``--kv-page-size 16``): a seeded
   GPT-2-small checkpoint served with ``--decode-attn-impl flash``
   through the CLI's engine factory and the HTTP server, sent 8
   concurrent short prompts (one batch), one NDJSON stream, one prompt
   longer than the largest bucket (chunked prefill), an admission
   leg (a 96-token stream, then 4 short prompts sent once its first
   chunk arrived, which must join the running batch), and a
   prefill-heavy leg: 8 concurrent streams of 512-880-byte prompts, one
   batch of seven 128-token chunks at B = 8, each request's time to its
   first NDJSON line reported. Launch counters are zeroed just before
   the requests and read just after: flash-extend exactly 12 per chunk
   (one per layer), all on the tensor-core body, and flash-decode exactly
   12 per decode step; a paged run (its pool
   sized for 8 full windows) must launch B3 and B4 and never B1 or B2
   (and never B5-B7), and end with every page back in the pool. Then
   one 896-token prefill at B = 8 through the engine's layout (wall ms,
   device ms, flash-extend's share, kernels per chunk) and an 8-step
   decode chunk at
   B = 8 through the engine's layout: wall time per step over five runs
   without the profiler, and one run under ``torch.profiler`` for
   device time per step, kernels per step, the flash-decode kernel's
   share and the device's busy share. The profile row also gives the
   host's side: one layer's cache append and the page coordinates
   (time to enqueue), the host syncs per step, the ops with the most host
   time, and for a paged engine the contiguous layout's step timed in
   alternation;
6. correctness — a small float32 model's greedy streams are identical
   through paged flash, contiguous flash and the einsum oracle, at two
   heads of 64 and at docs-gpt's four heads of 32; a
   joiner admitted into the row of a request that just finished streams
   what its prompt streams alone, on both layouts; and the
   teacher-forced top-1 agreement of flash with einsum at GPT-2 small
   is reported (floor 0.9);
7. Llama — a TinyLlama-1.1B-width checkpoint (22 layers, 32 query
   heads on 4 KV heads of 64, bf16, weights from seed 0; the seconds of
   the host draw, of the write and of each read reported) served as in
   phase 5 in two runs, contiguous bf16 and paged 16 int8: flash-extend
   exactly 22 launches per prefill chunk, all ``mma``, flash-decode 22
   per decode step; ``/metrics``
   cache bytes equal to the shapes' (4 KV heads: a 16-token int8 page
   is 191,488 B); the ``profile`` and ``prefill_profile`` rows of each
   engine and flash's top-1 agreement with einsum on the contiguous one
   (floor 0.9). Then one docs_text batch (B = 2, L = 1024) at that
   width: the LM loss and gradients with flash against full attention
   (phase 4's bounds), every B5-B7 launch on ``mma``; small f32 Llamas'
   greedy streams through paged flash, contiguous flash and einsum
   (docs-llama's 4 heads on 2 KV heads of 32, and 8 heads on 1 KV head
   of 64); and ``--preset docs-llama`` through the train CLI's ``run``
   with flash attention, 30 steps and its test evaluation, with exact
   B5-B7 launch counts, its checkpoint read back and served (greedy
   streams through flash equal einsum's);
8. shared prefixes (``"prefix"`` on ``/generate``), on the GPT-2
   contiguous bf16 and paged 16 int8 engines of phase 5 and both
   TinyLlama engines of phase 7: a cold round of 8 concurrent streams
   naming a 768-byte system prompt (one build, the rest wait for it), a
   warm round (8 hits), a 500-byte prompt's build, and a cross-prefix
   round of 4 rows of each in one batch; launch counters zeroed just
   before and read just after (one flash-extend a layer per formation,
   on ``mma``, one flash-decode a layer per decode step, no other
   kernel); the prefix counters as the JAX engine counts the trace,
   shared pages while a paged batch runs, pages settling at the entries'
   pages, adopted bytes equal to the entries' cache bytes; TTFT p50 of
   each round; one warm formation's wall and device ms next to the same
   prompts as plain ``prefix + text``; flash's teacher-forced top-1
   agreement with einsum through the prefix path, both over the
   engine's cache format (floor 0.98 in bf16, 0.9 in int8). Small f32
   models (GPT 2 heads of 64, Llama 4 on 2 KV heads of 32): every prefix
   stream equals its ``prefix + text`` stream on both layouts, a
   window-edge entry copying its group-end page on write (2 COW copies)
   and a cross-prefix batch on the copy fallback, whose private pages
   evict the other entry's idle page set. Phase 3 holds B1-B4 at
   the masks this phase sends (a prefix region, its left pad and each
   row's pad hole, a scalar ``lo`` with shared pages and a per-row one
   with a dummy row, GPT-2 and TinyLlama geometries, B2/B4 at U = 128
   and 256) within 7.8e-3 of their plain versions. Each disagreeing
   position of the agreement readings is listed with the einsum logits'
   top-1 - top-2 margin and the largest flash - einsum logit difference
   there (``all_ties``: every margin below its difference);
9. sampled tokens and the unit scheduler, at ``--sched-max-batches 2``
   (the default). On the GPT-2 contiguous bf16 and paged 16 int8
   engines, sampled requests (``temperature``, ``top_k``, ``top_p``):
   the same seed gives the same stream, a row's stream is the same in
   another batch slot and beside other batch mates, and a ``stop``
   string ends unary and NDJSON answers where the text says. Then, on
   those two engines and the TinyLlama paged 16 int8 one, launch
   counters zeroed just before and read just after: two window-
   incompatible groups (8 short rows, one sampled, and one prompt of
   ``max_positions - 128`` bytes) live at once, their units interleaved,
   every stream the same as at ``--sched-max-batches 1``; a long joiner
   prefilled in 2 chunks between another lane's decode chunks (paged;
   a contiguous batch admits it in one prefill); 8 rows whose worst
   case holds the whole pool expire at ``deadline_ms`` with
   ``deadline_exceeded`` frames while a group the page budget defers
   waits and then completes; a drain with two lanes live ends every
   stream; flash-decode exactly one launch per layer per decode step
   and flash-extend one per layer per prefill chunk, summed over lanes;
   pages settle at the prefix entries' pages. An informational row per
   engine gives the two-group load's TTFT p50 of the short group,
   inter-token p50 and device-busy share at 1 and at 2;
10. the scoring path (``/predict``, ``/files/``), run inside phase 5's
    checkpoint directory: ``iris-linear`` trained on the card through
    the train CLI's ``run`` (test accuracy >= 0.9667, the reference's)
    and served by ``python -m mlapi_tpu_torch.serving --checkpoint`` as
    a subprocess (``--max-wait-ms 20``): the 30 test rows one at a time
    and all at once, labels equal to the checkpoint's plain forward on
    the CPU and probabilities within 1e-5, the burst in at most
    ceil(30 / 512) + 1 device calls, a ``/files/`` round trip,
    ``/healthz`` and a 422; then a closed-loop ``/predict`` load at
    batch 1 (16 clients, 2000 requests, req/s, p50/p99) on a server at
    the default window. Phase 4's sst2-bert checkpoint served through
    a TextClassificationEngine and the HTTP app: 64 concurrent texts,
    B5 exactly 12 launches per device call, all ``mma``, no other
    attention kernel; labels equal to the same weights with full
    attention on the card (near ties reported), max-probabilities
    within 2e-2; one 64-row batch's wall and profiled device time. A
    Wide&Deep checkpoint at the criteo-widedeep preset's widths (seed
    0): 256 criteo rows through ``/predict``, held to the plain forward
    on the card (probabilities within 2e-2). One server process with
    GPT-2 small (flash, paged 16) as the default and sst2-bert as
    ``--model clf=...``: 8 greedy streams alone, then with 64
    ``/models/clf/predict`` texts at once: the same streams, and
    ``generate.sched_units_score`` > 0 and equal to the classifier's
    ``sched_dispatches`` and ``device_calls``, 12 B5 launches per
    scoring batch. B5 at the serving shapes (B = 1, 64, 512, L = 128,
    12 heads of 64, bf16, sst2 key masks, a quarter of bucket-padding
    rows dead): kernel, device, plain and SDPA ms beside the bound, max
    error on live rows, exact zeros on dead ones.
11. the rest of training, launch counters zeroed just before and read
    just after each run. (a) ``python -m mlapi_tpu_torch.train --preset
    sst2-bert --steps 30 --save-every 10 --keep-last 2`` as a subprocess,
    SIGKILLed once ``step_00000020`` has committed, then the same command
    again (in this process): it resumes at step 20; B5 12 launches per
    step and per eval batch, B6 and B7 12 per step, all ``mma``; test
    accuracy equal to phase 4's uninterrupted run, step losses 21-30
    within 1e-2 and parameters within 1e-3 of it (bf16; the largest gaps
    and whether the two are bitwise equal printed); two committed steps
    left. (b) ``docs-gpt`` (the teacher), ``docs-gpt-draft`` and
    ``docs-gpt-draft-distilled --distill-from`` the teacher, all with
    flash attention: per distilled step the teacher's B5 twice (2 layers,
    head dim 32) and the student's B5, B6 and B7 once (head dim 12), all
    ``fma``; the distilled draft's mean KL to the teacher on the test
    split below the hard-label draft's. (c) ``criteo-widedeep`` at its
    published widths (26 tables of 100,000 × 16, batch 1024) on
    ``recsys-sparse-adamw`` for 500 steps (test accuracy); from one init
    20 sparse steps against 20 dense ``recsys-adamw`` steps: parameters
    within 1e-4, rows no batch touched bit-equal to the init, wall and
    profiled device ms per step both ways. (d) ``--bench`` rows for
    sst2-bert and criteo-widedeep (step ms, examples/s, FLOPs with B5-B7
    counted from their shapes, MFU against 989 TFLOP/s). Then
    ``debug_checks`` raising at step 1 on a batch with a NaN feature and
    passing a clean flash run, and a ``profile_dir`` trace that names
    the flash kernels.
12. int8 weights, adapters and tenants, LoRA. (a) At GPT-2 small and
    TinyLlama-1.1B widths (inside phases 5 and 7, on their
    checkpoints): the CLI's engine factory with ``--quantize int8``,
    contiguous bf16 and paged 16 int8 (one quantized model): its weight
    bytes on the card (``torch.cuda.memory_allocated`` around the load)
    between ``quantized_bytes`` and the caching allocator's rounding of
    it; B1-B4 launches exact for 8 short rows and one chunked prompt;
    teacher-forced top-1 agreement with the float engine (each
    disagreement's margin listed) at least ``INT8_AGREE``, with two
    wrong-scale controls under it; decode wall/device ms and kernels per
    step beside the float engine's profile row. (b) ``--adapter-slots 4``
    and three rank-8 seeded adapters through ``--adapter ID=PATH`` files
    on a paged 16 bf16 engine: slot bytes and resident bytes in closed
    form, the first install's pool allocation, decode launches per step
    with adapters equal to those without, a grouped and a mixed batch
    beside each row's solo stream, base streams unchanged after adapter
    traffic, every adapter row of the mixed batch apart from its base
    stream, top-1 agreement with the eagerly merged engine (margins
    listed) at least ``SLOTS_AGREE`` while the engine without the
    adapter and with another stay under it; at GPT-2, one ``/generate``
    naming ``adapter`` and ``tenant`` over HTTP and an unknown adapter
    answering 404; small f32
    GPT and Llama: slot-path streams equal the merged engine's, a mixed
    batch its rows' solo streams, exactly. (c) ``--preset sst2-bert
    --init-from <phase 4's checkpoint> --lora-rank 8`` for 10 steps with
    flash: B5 12 a step and a test batch, B6/B7 11 a step (layer 0's
    attention inputs need no gradient), all ``mma``; every leaf without
    an adapter bit-equal to the init, each adapted kernel the init plus
    a rank-8 matrix; adapter moments exactly twice the adapters' f32
    bytes; wall and device ms per step beside phase 4's; the merged
    checkpoint on ``/predict`` through B5. (d) sst2-bert with
    ``--quantize int8`` on ``/predict`` through B5, labels beside the
    float engine's.
13. speculative decoding, engines from the CLI's factory with
    ``--draft-checkpoint`` (``spec_k`` 4). (a) GPT-2 small (seed 0) in
    f32, contiguous f32 and paged 16 int8, with itself and with a
    DistilGPT2-width draft (seed 1) as drafts: two solo streams and two
    4-row batches (budgets whose gaps make the paged handoff a table
    shift and a repack) equal the target-only engine's token for token;
    the draft == target engine accepts every proposal and realigns both
    ways; launches exact (each target decode step and verify block, and
    each draft step, one launch a layer). (b) The same in bf16 with
    draft == target, four solo streams, each first divergence held to
    fault C3's rule (the target-only run's top-1 - top-2 margin below
    the largest |verify - decode| logit difference there). (d) On the
    bf16 spec engine at 2 lanes: a spec row yields to a second lane at a
    round boundary and re-engages; at brownout rung 1 a run speculates
    not at all, counted once. (c) After phase 11: ``docs-gpt`` with its
    trained drafts (``--spec-sample``): greedy streams equal the
    target-only engine's, a sampled run the same for one seed twice and
    another for another seed; acceptance, tokens a round, wall and
    device ms per emitted token beside the target alone, at batch 1.
    (e) With phase 3's rows: B2/B4 at U = 5 (B = 1 and 4, rows at their
    own slots, L = 1024), B1 at the draft's decode shape.
    ``--only-spec`` runs phases 1, 2 and 13 alone (training the docs-gpt
    pair itself) and prints no result line.
14. fused widths and the host KV tier, on the GPT-2 contiguous bf16 and
    paged 16 int8 engines after phase 9. (a) The 8 short prompts at
    budgets 65 and 129 (above ``fused_max_new``) in one formed batch,
    in fused widths and pinned to the plain chunk: the same streams, one
    fused run, the chunk counts the width rule works out from the
    budgets (2 against 16), one flash-decode launch a layer a decode
    step and the same total; budgets 33 and 129, which compact at
    different steps in the two modes, reported, with no divergence
    before the short rows end; a non-streaming pair with a streaming
    joiner (widths 8, 8, then 48); wall ms and host syncs a token, fused
    against plain (``torch.cuda.set_sync_debug_mode``), reported. (b) A
    host tier attached after a restart's state, ``PREFIX_A`` over HTTP:
    cold, warm, its pages evicted (paged) and restored, its entry
    dropped by the prefix LRU and rebuilt from the blob; restored
    streams equal the cold one, ``prefix_builds`` flat, spill and
    restore bytes ``n_pages x kv_page_bytes``, one flash-extend a layer
    and one flash-decode a layer a step a restored request; the
    ``tier_spill`` / ``tier_restore`` faults counted with pages
    conserved; one restore timed beside pinned and pageable
    host-to-device copies of its bytes; a ``--kv-tier-disk-dir`` round
    trip from the CLI's factory; TTFT cold, warm and restored. At
    TinyLlama's width (paged 16 int8, after phase 12 there): one
    restore, 191,488-B pages.

Stdout: one JSON line per kernel case, per training and serving run,
then the run's seconds, the ``{"kernels": [...]}`` summary (B1-B7; each
kernel's ``launches_per_path`` holds the GPT and Llama paths, the
scheduler phase's, phase 12's and phase 13's included, B5's the
scoring legs', and B5-B7's the phase 11 and 12 runs), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Without a card, or
outside the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
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
TOLERANCE = {"bf16": 2e-2, "int8": 2e-2, "f32": 1e-5}   # live rows
GPT2_SMALL = dict(                # openai-community/gpt2
    vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
    max_positions=1024, compute_dtype="bfloat16",
)
TINYLLAMA = dict(                 # TinyLlama/TinyLlama-1.1B-intermediate-
    vocab_size=32000, hidden_size=2048, num_layers=22,  # step-1431k-3T,
    num_heads=32, num_kv_heads=4, intermediate_size=5632,  # config.json
    max_positions=2048, rope_theta=10000.0, compute_dtype="bfloat16",
)
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
# B5-B7 on live rows: absolute, and relative to the largest reference
# value, so that small gradients cannot pass by being small.
FLASH_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}
REPLACES = {
    "decode_attention": "mlapi_tpu/ops/pallas/decode_attention.py:104",
    "extend_attention": "mlapi_tpu/ops/pallas/decode_attention.py:178",
    "paged_decode_attention": "mlapi_tpu/ops/pallas/decode_attention.py:514",
    "paged_extend_attention": "mlapi_tpu/ops/pallas/decode_attention.py:643",
    "flash_forward": "mlapi_tpu/ops/pallas/flash_attention.py:130",
    "flash_backward_dq": "mlapi_tpu/ops/pallas/flash_attention.py:357",
    "flash_backward_dkv": "mlapi_tpu/ops/pallas/flash_attention.py:423",
}
KERNELS = tuple(REPLACES)
FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
SERVING = tuple(k for k in KERNELS if k not in FLASH)
PAGE = 16                       # the serving page size
SOURCES = {
    **{k: "mlapi_tpu_torch/csrc/decode_attention.cu" for k in SERVING},
    **{k: "mlapi_tpu_torch/csrc/flash_attention.cu" for k in FLASH},
}
SST2_STEPS = 30                 # training steps of the sst2-bert run
DOCS_LLAMA_STEPS = 30           # ... and of the docs-llama run


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


def zero_counters() -> None:
    """Every wrapper's launch count and per-body counts to 0."""
    from mlapi_tpu_torch.ops import cuda as kern

    for name in KERNELS:
        getattr(kern, name).launches = 0
    for name in FLASH:
        getattr(kern, name).bodies = {"mma": 0, "fma": 0}
    for name in SERVING:
        getattr(kern, name).bodies = {"mma": 0, "fma": 0, "decode": 0}


def read_counters(group=None) -> tuple[dict, dict]:
    """(launches of every kernel, per-body counts of ``group``'s
    kernels; FLASH by default)."""
    from mlapi_tpu_torch.ops import cuda as kern

    return ({name: getattr(kern, name).launches for name in KERNELS},
            {name: dict(getattr(kern, name).bodies)
             for name in (group or FLASH)})


def profiled_kernels(calls, iters: int = 12) -> dict:
    """The calls (in turn, after a warm-up) under ``torch.profiler``:
    ``{kernel name: [events, device us]}`` of the CUDA kernels and copies
    they launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in calls:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    out: dict = {}
    for e in device_kernels(prof):
        n, us = out.setdefault(e.name, [0, 0.0])
        out[e.name] = [n + 1, us + e.device_time_total]
    return out


def profiled_ms(calls, iters: int = 12, only: str = "") -> float:
    """Device time per call: the durations of the kernels the calls
    launched under :func:`profiled_kernels` (those whose name holds
    ``only``) summed and divided by the calls -- the kernels alone,
    without the gap that separates two graph replays."""
    us = sum(t for name, (_, t) in profiled_kernels(calls, iters).items()
             if only in name)
    return us / 1e3 / iters


# -- phase 3: kernels ---------------------------------------------------

def kernel_case(kernel, fmt, b, u, length, pos, seed, h=12, kvh=12,
                page=PAGE, d=64):
    """Inputs at one serving shape: GPT-2-small heads and head dim unless
    ``h`` / ``kvh`` / ``d`` say otherwise, bf16 queries over a bf16 or
    int8 cache (``fmt`` ``f32``: f32 throughout), a cache holding ragged
    left pads (per-row ``n_pad``), the decode token (or the extend span's
    first token) at slot ``pos``, masks built by the model's own mask
    helpers. A paged kernel gets the same cache in ``page``-token pool
    pages (:func:`to_pages`) and, for the comparisons, the contiguous
    cache beside it."""
    import torch

    from mlapi_tpu_torch.models.gpt import (
        decode_valid_and_shift, extend_positions_and_mask,
    )
    from mlapi_tpu_torch.ops.quant import kv_quantize

    dev = "cuda"
    # Drawn on the card: a row times several input sets, and host draws
    # of the long-window sets cost more than the timing itself.
    g = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(pos, list):   # one slot a row (a verify at its row's)
        pos = torch.as_tensor(pos, device=dev)
    dt = torch.float32 if fmt == "f32" else torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    q = randn(b, u, h, d)
    k = randn(b, length, kvh, d)
    v = randn(b, length, kvh, d)
    n_pad = torch.randint(0, max(1, length // 8), (b,), generator=g,
                          device=dev)
    if kernel.endswith("decode_attention"):
        valid, _ = decode_valid_and_shift(length, pos, n_pad)
        mask = valid[:, 0, 0, :]
    else:
        _, valid = extend_positions_and_mask(length, u, pos, n_pad)
        mask = valid[:, 0]
    if fmt == "int8":
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        k, v = {"q": kq, "scale": ks}, {"q": vq, "scale": vs}
    if not kernel.startswith("paged_"):
        return q, k, v, mask
    pk, table = to_pages(k, mask, seed, page)
    pv, _ = to_pages(v, mask, seed, page)
    return q, pk, pv, table, mask, k, v


def to_pages(cache, mask, seed, page=PAGE):
    """A contiguous ``[B, L, KVH, D]`` cache (or int8 pair) copied into
    ``page``-token pool pages behind a shuffled page table; pages no
    query attends map to the null page 0, which holds finite garbage."""
    import torch

    leaves = cache if isinstance(cache, dict) else {"t": cache}
    some = next(iter(leaves.values()))
    b, length = some.shape[:2]
    n_tiles = length // page
    n_pages = b * n_tiles + 1
    g = torch.Generator().manual_seed(seed)
    ids = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(b, n_tiles)
    gd = torch.Generator(device="cuda").manual_seed(seed)
    live = mask.reshape(b, -1, n_tiles, page).any(dim=(1, 3)).cpu()
    table = torch.where(live, ids, 0).to("cuda", torch.int32)
    pools = {}
    for name, leaf in leaves.items():
        pool = torch.randn((n_pages, page) + tuple(leaf.shape[2:]),
                           generator=gd, device="cuda").abs().to(leaf.dtype)
        tiles = leaf.reshape((b, n_tiles, page) + tuple(leaf.shape[2:]))
        on = table != 0
        pool[table[on].long()] = tiles[on]
        pools[name] = pool
    return (pools if isinstance(cache, dict) else pools["t"]), table


def case_bytes_flops(q, k, v, mask, table=None, page=PAGE):
    """The least the function must move and compute on THESE inputs:
    q, the K/V rows of keys some query of the batch row attends (with
    their scales for int8), the mask and the output, each once; 4*D
    FLOPs per (query head, attended key). With a page ``table`` (a
    paged case), a key is its pool slot: rows whose tables share pages
    read those slots once, so keys count once per distinct (page,
    offset) that some live query reads, and the table is read once."""
    b, u, h, d = q.shape
    if isinstance(k, dict):
        kvh = k["q"].shape[2]
        per_key = 2 * kvh * (d * 1 + 4)
    else:
        kvh = k.shape[2]
        per_key = 2 * kvh * d * k.element_size()
    m3 = mask.reshape(b, -1, mask.shape[-1])
    attended = m3.any(dim=1)                        # [B, L]
    if table is None:
        live_keys = int(attended.sum())
        table_bytes = 0
    else:
        slot = attended.nonzero()
        tile, off = slot[:, 1] // page, slot[:, 1] % page
        pool_slot = table[slot[:, 0], tile].long() * page + off
        live_keys = int(pool_slot.unique().numel())
        table_bytes = table.numel() * table.element_size()
    pairs = int(m3.sum())
    nbytes = (2 * q.numel() * q.element_size() + live_keys * per_key
              + mask.numel() * mask.element_size() + table_bytes)
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
    gqa = h != k.shape[2]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4,
                                                  enable_gqa=gqa)


def check_kernels(power):
    # (kernel, B, U, L, slot of the first query token): every shape the
    # serving phase gives a kernel, and the full window at B = 8. Short
    # prompts decode at B = 8 in tier 48 (bucket 16 + 32 tokens); the
    # stream decodes alone (B = 1) in tier 48; the long prompt (bucket
    # 384, tier 416) prefills in three 128-token chunks at slots 0, 128,
    # 256 and decodes 16 tokens at slots 384-399, alone. B = 1 gets its
    # own split layout (one 32-key tile per split at L = 416). The paged
    # twins read 16-token pages: NP = 3 (L = 48), 26 (L = 416), 64
    # (L = 1024), 9 (L = 144: the admission leg's batch at B = 8). The
    # prefill-heavy leg's chunks are B = 8 at L = 928 (the full-window row
    # stands for them). Beyond the serving shapes, B2 and B4 get a GQA row
    # (16 query heads on 4 KV heads) and a ragged one (U = 100, L = 1000,
    # 8-token pages: 1000 is no multiple of 16 or 64); B1 and B3 a GQA
    # row; and B1-B4 rows at Llama-class widths (32 query heads on 8 KV
    # heads, head dim 128), at docs-gpt's (4 heads of 32, its 256
    # positions; B1/B3 in f32 too, the preset's dtype) and at head dims
    # 160, 256, 320 and 512 (8 query heads on 4 KV heads, L = 512).
    shapes = [
        ("decode_attention", 8, 1, 48, 47),
        ("decode_attention", 1, 1, 48, 47),
        ("decode_attention", 1, 1, 416, 399),
        ("decode_attention", 8, 1, 1024, 1023),
        ("extend_attention", 1, 128, 416, 0),
        ("extend_attention", 1, 128, 416, 256),
        ("extend_attention", 8, 128, 1024, 768),
        ("paged_decode_attention", 8, 1, 48, 47),
        ("paged_decode_attention", 8, 1, 144, 143),
        ("paged_decode_attention", 1, 1, 416, 399),
        ("paged_decode_attention", 8, 1, 1024, 1023),
        ("paged_extend_attention", 1, 128, 416, 256),
        ("paged_extend_attention", 8, 128, 1024, 768),
    ]
    gqa = dict(h=16, kvh=4)
    for name in ("extend_attention", "paged_extend_attention"):
        shapes.append((name, 4, 128, 1024, 768, gqa))
        shapes.append((name, 2, 100, 1000, 850, dict(page=8)))
    for name in ("decode_attention", "paged_decode_attention"):
        shapes.append((name, 8, 1, 1024, 1023, gqa))
    llama = dict(h=32, kvh=8, d=128)
    docs_gpt = dict(h=4, kvh=4, d=32)
    for name in SERVING:
        decode = name.endswith("decode_attention")
        shapes.append((name, 8, 1 if decode else 128, 1024,
                       1023 if decode else 768, llama))
        shapes.append((name, 8, 1 if decode else 128, 256,
                       255 if decode else 128, docs_gpt))
        if decode:
            shapes.append((name, 8, 1, 256, 255, dict(docs_gpt, f32=True)))
        # Head dims past 128: the CUDA-core bodies (decode, fma; past 256
        # fma in column chunks for every entry point).
        for d in (160, 256, 320, 512):
            shapes.append((name, 2, 1 if decode else 64, 512,
                           511 if decode else 448, dict(h=8, kvh=4, d=d)))
        if decode:
            shapes.append((name, 2, 1, 512, 511,
                           dict(h=8, kvh=4, d=256, f32=True)))
    # TinyLlama-1.1B's geometry, a group of 8 at D = 64 (32 query heads on
    # 4 KV heads): B1/B3 at B = 8 over its 2048-token window, B2/B4 at
    # B = 8, U = 128, the window's last chunk.
    tiny = dict(h=32, kvh=4, d=64)
    for name in SERVING:
        decode = name.endswith("decode_attention")
        shapes.append((name, 8, 1 if decode else 128, 2048,
                       2047 if decode else 1920, tiny))
    results = []
    for i, (name, b, u, length, pos, *extra) in enumerate(shapes):
        shape = dict(extra[0]) if extra else {}
        fmts = ("f32",) if shape.pop("f32", False) else ("bf16", "int8")
        for fmt in fmts:
            def make(seed, name=name, fmt=fmt, b=b, u=u, length=length,
                     pos=pos, shape=shape):
                return kernel_case(name, fmt, b, u, length, pos, seed=seed,
                                   **shape)

            results.append(kernel_row(name, fmt, b, u, length, pos, shape,
                                      make, i, power, TOLERANCE[fmt]))
    return results


def kernel_row(name, fmt, b, u, length, pos, shape, make, i, power, tol,
               extra=None):
    """One kernel case: the wrapper against its plain version (max abs
    error on live rows within ``tol``, exact zeros on rows with no valid
    key, the body the geometry names), a paged wrapper against its
    contiguous twin on the same bytes (bit for bit), and its times beside
    the plain version's, SDPA's and the card's bound. ``make(seed)``
    builds the inputs (``kernel_case``'s layout); fatal on a failure."""
    import importlib

    import torch

    from mlapi_tpu_torch.ops import cuda as kern

    wrappers = importlib.import_module(
        "mlapi_tpu_torch.ops.cuda.decode_attention")
    plain = getattr(kern, name + "_plain")
    twin = {"paged_decode_attention": kern.decode_attention,
            "paged_extend_attention": kern.extend_attention}
    h, kvh = shape.get("h", 12), shape.get("kvh", 12)
    d = shape.get("d", 64)
    args = make(i)
    fn = getattr(kern, name)
    paged = name.startswith("paged_")
    dtype = torch.float32 if fmt == "f32" else torch.bfloat16
    geo = wrappers._geometry(
        "mlapi_" + name, dtype, b, u, h, kvh, length, d,
        wrappers._sm_count(0), fmt == "int8")
    q, mask = args[0], args[-3 if paged else -1]
    contiguous = (q, *args[-2:], mask) if paged else args
    before = dict(fn.bodies)
    out = fn(*args[:5] if paged else args)
    torch.cuda.synchronize()
    ran = [k for k in fn.bodies if fn.bodies[k] != before[k]]
    ref = plain(*args[:5] if paged else args)
    same = None
    if paged:
        # The same bytes in a contiguous cache: bit for bit.
        same = bool(torch.equal(out, twin[name](*contiguous)))
    live = mask.reshape(b, -1, length).any(dim=-1)   # [B, U]
    err = float(
        (out.float() - ref.float()).abs()[live].max()
    )
    finite = bool(torch.isfinite(out).all())
    dead_zero = not bool(out[~live].any())
    nbytes, flops = case_bytes_flops(
        *contiguous, *((args[3], shape.get("page", PAGE)) if paged else ()))
    # Rotate through copies of the inputs so that a launch does not find
    # the previous one's cache in the 50 MB L2 (in serving each layer
    # reads its own cache); at most 8 sets, so the smallest tier's cases
    # stay partly L2-resident.
    sets = [args]
    for s in range(1, min(8, max(2, math.ceil(160e6 / nbytes)))):
        sets.append(make(1000 + 10 * i + s))
    ops = [a[:5] if paged else a for a in sets]
    calls = [(lambda a=a: fn(*a)) for a in ops]
    kernel_ms = graph_ms(calls)
    device_ms = profiled_ms(calls)
    eager_ms = cuda_ms(calls)
    plain_ms = graph_ms([(lambda a=a: plain(*a)) for a in ops])
    library_ms = None
    if fmt != "int8":
        # SDPA on the (gathered) contiguous cache: a yardstick.
        library_ms = graph_ms([
            sdpa_fn(a[0], *a[-2:], a[-3]) if paged else sdpa_fn(*a)
            for a in sets
        ])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    row = {
        "case": "kernel", "kernel": name, "format": fmt,
        "B": b, "U": u, "L": length, "pos": pos,
        "H": h, "KVH": kvh, "D": d,
        "page": shape.get("page", PAGE) if paged else None,
        **(extra or {}),
        "body": ran[0] if len(ran) == 1 else ran,
        "splits": geo.splits, "tiles_per_split": geo.tiles_per_split,
        "equals_contiguous": same,
        "max_abs_err": err, "tolerance": tol, "finite": finite,
        "dead_rows_exact_zero": dead_zero,
        "ms": kernel_ms, "device_ms": device_ms, "eager_ms": eager_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound, "bound_share": bound / kernel_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "card": power,
    }
    emit(row)
    if ran != [geo.body] or (u == 1 and d <= 256 and ran != ["decode"]):
        raise SystemExit(
            f"{name} {fmt} B={b} U={u} L={length} D={d}: ran the "
            f"bodies {ran}, the geometry says {geo.body}"
        )
    if not finite or err > tol or not dead_zero:
        raise SystemExit(
            f"{name} {fmt} B={b} U={u} L={length} D={d}: kernel "
            f"disagrees with its plain version (max abs err {err}, "
            f"finite {finite}, tolerance {tol}, exact "
            f"zeros on dead rows {dead_zero})"
        )
    if same is False:
        raise SystemExit(
            f"{name} {fmt} B={b} U={u} L={length}: the paged kernel "
            "differs from its contiguous twin on the same bytes"
        )
    del sets
    torch.cuda.empty_cache()
    return row


# -- the prefix phase's kernel rows ------------------------------------

PREFIX_TOLERANCE = 2 ** -7      # 7.8e-3: B1-B4 at prefix masks, bf16 cache


def prefix_kernel_case(kernel, fmt, b, u, p, bucket, per_row, seed, h=12,
                       kvh=12, d=64):
    """Inputs behind a ``p``-slot shared-prefix region, as a prefix batch
    gives them: slots ``[lo, p)`` the prefix, ``[p, p + n_pad)`` each
    row's suffix pad hole, then the suffix block of ``bucket`` slots and
    room to decode; masks from the model's own helpers with ``prefix_len
    = p``. A scalar ``lo``: the same prefix bytes in every row, and a
    paged case points every row's prefix tiles at the same pages (a
    shared entry). A per-row ``lo`` (a cross-prefix batch): each row its
    own prefix, and the last row a dummy with an empty region and a hole
    over everything (no valid key). Extend: the suffix block at slot
    ``p`` (U = ``bucket``); decode: the token after it. Returns
    :func:`kernel_case`'s layout."""
    import torch

    from mlapi_tpu_torch.models.gpt import (
        decode_valid_and_shift, extend_positions_and_mask,
    )
    from mlapi_tpu_torch.ops.quant import kv_quantize

    length = p + bucket + 32
    dev, dt = "cuda", (torch.float32 if fmt == "f32" else torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed)   # as kernel_case
    q = torch.randn(b, u, h, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, length, kvh, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, length, kvh, d, generator=g, device=dev).to(dt)
    n_pad = torch.randint(0, bucket, (b,), generator=g, device=dev)
    if per_row:
        lo = torch.randint(0, p, (b,), generator=g, device=dev)
        lo[-1], n_pad[-1] = p, length
    else:
        lo = int(torch.randint(1, p // 2, (1,), generator=g, device=dev))
        k[:, :p], v[:, :p] = k[:1, :p], v[:1, :p]
    if kernel.endswith("decode_attention"):
        valid, _ = decode_valid_and_shift(length, p + bucket + 7, n_pad, p,
                                          lo)
        mask = valid[:, 0, 0, :]
    else:
        _, valid = extend_positions_and_mask(length, u, p, n_pad, p, lo)
        mask = valid[:, 0]
    if fmt == "int8":
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        k, v = {"q": kq, "scale": ks}, {"q": vq, "scale": vs}
    if not kernel.startswith("paged_"):
        return q, k, v, mask
    pk, table = to_pages(k, mask, seed)
    pv, _ = to_pages(v, mask, seed)
    if not per_row:
        tiles = p // PAGE
        head = table[:, :tiles]
        table[:, :tiles] = torch.where(head != 0, head[:1], head)
    return q, pk, pv, table, mask, k, v


def check_prefix_kernels(power):
    """B1-B4 at the masks the prefix phase sends them: a 768-slot prefix
    region behind its own left pad, each row's suffix pad hole, the
    128-slot suffix block (B2/B4) and the decode token after it (B1/B3),
    with a scalar ``lo`` (one entry, its pages shared by every row) and a
    per-row ``lo`` (a cross-prefix batch with a dummy row), at GPT-2
    small's heads and TinyLlama-1.1B's group of 8, bf16 and int8 caches;
    and B2/B4 over a 256-slot suffix block (a suffix past the largest
    bucket runs as one block) behind a 512-slot prefix. Tolerance
    ``PREFIX_TOLERANCE`` on live rows, exact zeros on the dummy row,
    paged equal to contiguous bit for bit."""
    geometries = (("gpt2-small", dict(h=12, kvh=12)),
                  ("tinyllama-1.1b", dict(h=32, kvh=4)))
    cases = []
    for label, geo in geometries:
        for name in SERVING:
            decode = name.endswith("decode_attention")
            cases.append((name, label, geo, 8, 768, 128))
            if not decode:
                cases.append((name, label, geo, 4, 512, 256))
    rows = []
    for i, (name, label, geo, b, p, bucket) in enumerate(cases):
        u = 1 if name.endswith("decode_attention") else bucket
        length = p + bucket + 32
        for per_row in (False, True):
            for fmt in ("bf16", "int8"):
                def make(seed, name=name, fmt=fmt, b=b, u=u, p=p,
                         bucket=bucket, per_row=per_row, geo=geo):
                    return prefix_kernel_case(name, fmt, b, u, p, bucket,
                                              per_row, seed, **geo)

                rows.append(kernel_row(
                    name, fmt, b, u, length, p, geo, make,
                    500 + 4 * i + 2 * per_row + (fmt == "int8"), power,
                    PREFIX_TOLERANCE,
                    {"masks": "prefix", "model": label, "prefix_len": p,
                     "suffix_bucket": bucket,
                     "lo": "per-row" if per_row else "scalar"},
                ))
    return rows


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
    status, out = http(port, "POST", "/generate", json.dumps(body).encode(),
                       timeout=timeout)
    if status != 200:
        raise SystemExit(f"/generate answered {status}: {out[:300]!r}")
    return out


def get(port: int, path: str) -> dict:
    status, out = http(port, "GET", path, timeout=60)
    if status != 200:   # an OSError, as urllib raised it: spawn_server waits
        raise OSError(f"GET {path} answered {status}")
    return json.loads(out)


def http(port: int, method: str, path: str, body: bytes | None = None,
         ctype: str = "application/json",
         timeout: float = 300.0) -> tuple[int, bytes]:
    """(status, body) of one request; an HTTP error status is returned,
    not raised."""
    import urllib.error

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"content-type": ctype} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def at_once(fn, items, workers: int | None = None,
            what: str = "concurrent requests") -> list:
    """``fn(item)`` for every item, all released together by a barrier
    (``workers`` threads at most, each taking items in turn)."""
    n = len(items)
    workers = min(workers or n, n)
    outs: list = [None] * n
    errors: list = []
    barrier = threading.Barrier(workers)

    def run(w):
        barrier.wait()
        for i in range(w, n, workers):
            try:
                outs[i] = fn(items[i])
            except BaseException as e:  # reported below
                errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(w,))
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"{what} failed: {errors[:3]}")
    return outs


SHORT_PROMPTS = [
    "the quick brown fox", "serving engines batch", "checkpoints commit",
    "kernels read the cache", "the draft proposes", "a card has memory",
    "decode reads the cache", "quantize the kv cache",
]
LONG_PROMPT = ("a prompt longer than the largest bucket prefills in "
               "chunks; ") * 6   # 336 bytes -> bucket 384, 3 chunks
ADMIT_STREAM, ADMIT_JOIN = 96, 16
JOINERS = ["join the batch", "admitted mid-run", "a row of its own",
           "pages on demand"]
# The prefill-heavy leg: 8 concurrent prompts of 512-880 bytes (one token
# a byte), drawn from seed 0, the longest set to 880, 16 new tokens each:
# bucket 896 (7 chunks of 128), window 928 <= GPT-2's 1024 positions. A
# prompt over 896 bytes would round to a 1024 bucket and overflow them.
LONG_LEG_BYTES, LONG_LEG_NEW, LONG_LEG_BUCKET = (512, 880), 16, 896


def long_leg_prompts() -> list:
    import numpy as np

    lo, hi = LONG_LEG_BYTES
    sizes = np.random.default_rng(0).integers(lo, hi + 1, 8)
    sizes[int(np.argmax(sizes))] = hi
    text = ("a long prompt pays its prefill in time to first token; "
            "every chunk of it reads the cache written so far. ") * 20
    return [text[i:i + int(n)] for i, n in enumerate(sizes)]


def long_leg(port: int):
    """The 8 long prompts as concurrent NDJSON streams: per request the
    wall ms to its first line (TTFT) and its done line."""
    prompts = long_leg_prompts()
    ttft, done = concurrent_streams(
        port, [{"text": p, "max_new_tokens": LONG_LEG_NEW} for p in prompts],
        "prefill-heavy leg")
    return [len(p) for p in prompts], ttft, done


def concurrent_streams(port: int, bodies: list, what: str):
    """The request bodies sent at once as NDJSON streams: per request the
    wall ms to its first line (TTFT) and its done line."""

    def one(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({**body, "stream": True}).encode(),
            headers={"content-type": "application/json"},
        )
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            lines = [json.loads(r.readline())]
            ttft = (time.perf_counter() - t0) * 1e3
            lines += [json.loads(x) for x in r.read().decode().splitlines()
                      if x.strip()]
        streamed = [t for x in lines[:-1] for t in x["token_ids"]]
        if not lines[-1].get("done") or streamed != lines[-1]["token_ids"]:
            raise ValueError("NDJSON chunks disagree with the done line")
        return ttft, lines[-1]

    outs = at_once(one, bodies, what=what)
    return [o[0] for o in outs], [o[1] for o in outs]


def admission_leg(port: int):
    """A 96-token NDJSON stream; once its first chunk arrived (its batch
    is then running), 4 short prompts sent at once, which the running
    batch must admit. Returns (stream ids, done line, joiner outputs)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps({
            "text": "a long stream admits joiners", "stream": True,
            "max_new_tokens": ADMIT_STREAM,
        }).encode(), headers={"content-type": "application/json"},
    )
    outs: list = [None] * len(JOINERS)
    errors: list = []

    def one(i):
        try:
            outs[i] = json.loads(post(port, {
                "text": JOINERS[i], "max_new_tokens": ADMIT_JOIN,
            }))
        except BaseException as e:  # reported below
            errors.append(repr(e))

    with urllib.request.urlopen(req, timeout=300) as r:
        lines = [json.loads(r.readline())]
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(JOINERS))]
        for t in threads:
            t.start()
        lines += [json.loads(x) for x in r.read().decode().splitlines()
                  if x.strip()]
    for t in threads:
        t.join(600)
    if errors or any(o is None for o in outs):
        raise SystemExit(f"admission leg: joiners failed: {errors}")
    streamed = [t for x in lines[:-1] for t in x["token_ids"]]
    return streamed, lines[-1], outs


def kv_bytes(cfg, tokens: int, kv_quant) -> int:
    """Bytes of ``tokens`` cached tokens across every layer from the
    configuration's shapes alone: K and V of each KV head, in the
    compute dtype or as int8 payload plus one f32 scale."""
    kvh = cfg.get("num_kv_heads") or cfg["num_heads"]
    d = cfg["hidden_size"] // cfg["num_heads"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    per_head = d + 4 if kv_quant == "int8" else d * item
    return cfg["num_layers"] * 2 * tokens * kvh * per_head


def serve_run(ckpt: Path, kv_quant, page, cfg=GPT2_SMALL, model="gpt2-small"):
    """One serving run of the checkpoint of ``cfg`` (``page``: the KV
    page size, None for the contiguous cache): returns its summary row
    and the engine."""
    import statistics

    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.server import BackgroundServer

    # The CLI's own engine factory (python -m mlapi_tpu_torch.serving
    # --checkpoint ... [--kv-quant int8] --decode-attn-impl flash
    # [--kv-page-size 16]); a wider batch window so 8 concurrent arrivals
    # form one batch.
    # The paged runs size the pool for the prefill-heavy leg: 8 rows of a
    # full window (GPT-2's 1024 tokens; the leg's 928 need 8 * 58 + 1 =
    # 465 pages), where the default covers the largest short bucket only.
    kv_pages = None
    if page:
        kv_pages = 8 * -(-cfg["max_positions"] // page) + 1
    t0 = time.perf_counter()
    engine = build_engine(ckpt, kv_quant=kv_quant, decode_attn_impl="flash",
                          kv_page_size=page, kv_pages=kv_pages,
                          max_wait_ms=50.0)
    load_s = time.perf_counter() - t0
    window = engine._cache_len(LONG_LEG_BUCKET, LONG_LEG_NEW)
    if page and kv_pages < 8 * -(-window // page) + 1:
        raise SystemExit(f"{kv_pages} pages cannot hold 8 x {window} tokens")
    n_new = 32
    # Decode steps of the run, counted where the engine's decode chunks
    # take them (one launch of flash-decode per layer per step).
    steps = [0]
    decode_step = engine.model.decode_step

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return decode_step(*args, **kwargs)

    engine.model.decode_step = counted_step
    with BackgroundServer(build_app(engine)) as srv:
        zero_counters()
        steps[0] = 0
        all_chunks0 = engine.prefill_chunks
        batches0 = engine.batch_calls
        t0 = time.perf_counter()
        outs = at_once(lambda text: json.loads(post(srv.port, {
            "text": text, "max_new_tokens": n_new})), SHORT_PROMPTS)
        batch_s = time.perf_counter() - t0
        short_batches = engine.batch_calls - batches0
        stream = post(srv.port, {"text": "stream this", "stream": True,
                                 "max_new_tokens": n_new}).decode()
        chunks0 = engine.prefill_chunks
        long_out = json.loads(post(srv.port, {"text": LONG_PROMPT,
                                              "max_new_tokens": 16}))
        long_chunks = engine.prefill_chunks - chunks0
        admitted0 = engine.admitted
        t0 = time.perf_counter()
        admit_ids, admit_done, joined = admission_leg(srv.port)
        admit_s = time.perf_counter() - t0
        admitted = engine.admitted - admitted0
        chunks0, batches0 = engine.prefill_chunks, engine.batch_calls
        t0 = time.perf_counter()
        leg_bytes, leg_ttft, leg_done = long_leg(srv.port)
        leg_s = time.perf_counter() - t0
        leg_chunks = engine.prefill_chunks - chunks0
        leg_batches = engine.batch_calls - batches0
        all_chunks = engine.prefill_chunks - all_chunks0
        launches, bodies = read_counters(SERVING)
        decode_steps = steps[0]
        # Pages go back on the device thread after the terminal frames.
        deadline = time.monotonic() + 60.0
        while engine.kv_pages_in_use and time.monotonic() < deadline:
            time.sleep(0.01)
        metrics = get(srv.port, "/metrics")
        health = get(srv.port, "/healthz")
    del engine.model.decode_step            # the class's method again

    vocab = cfg["vocab_size"]
    for o in outs + [long_out] + joined:
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
    if (not admit_done.get("done") or admit_ids != admit_done["token_ids"]
            or len(admit_ids) != ADMIT_STREAM
            or [len(o["token_ids"]) for o in joined]
            != [ADMIT_JOIN] * len(JOINERS)):
        raise SystemExit("admission leg: a token was not delivered")
    if admitted < 1:
        raise SystemExit("admission leg: no joiner joined the running batch")
    mine = (("paged_decode_attention", "paged_extend_attention") if page
            else ("decode_attention", "extend_attention"))
    if min(launches[k] for k in mine) <= 0 or any(
        launches[k] for k in KERNELS if k not in mine
    ):
        raise SystemExit(
            f"kernels of the path: want {mine} launched and no other, "
            f"got {launches}"
        )
    # Flash-extend: exactly one launch per layer per 128-token prefill
    # chunk (the long prompt's 3, the prefill-heavy leg's 7), every one on
    # the tensor-core body.
    layers = cfg["num_layers"]
    extend = mine[1]
    if (leg_chunks != LONG_LEG_BUCKET // 128 or all_chunks != 3 + leg_chunks
            or launches[extend] != layers * all_chunks):
        raise SystemExit(
            f"{extend}: {launches[extend]} launches for {all_chunks} prefill "
            f"chunks ({leg_chunks} in the prefill-heavy leg), want "
            f"{layers} per chunk and {LONG_LEG_BUCKET // 128} leg chunks"
        )
    if bodies[extend]["mma"] != launches[extend]:
        raise SystemExit(f"{extend}: bodies {bodies[extend]}, want all mma")
    # Flash-decode: exactly one launch per layer per decode step, every
    # one on the decode body (one launch a call).
    if launches[mine[0]] != layers * decode_steps:
        raise SystemExit(
            f"{mine[0]}: {launches[mine[0]]} launches for {decode_steps} "
            f"decode steps, want {layers} a step")
    if bodies[mine[0]]["decode"] != launches[mine[0]]:
        raise SystemExit(
            f"{mine[0]}: bodies {bodies[mine[0]]}, want all decode")
    if leg_batches != 1:
        raise SystemExit(f"8 long prompts took {leg_batches} batches")
    if [len(d["token_ids"]) for d in leg_done] != [LONG_LEG_NEW] * 8:
        raise SystemExit("prefill-heavy leg: a request missed its tokens")
    if metrics["counters"]["generate.prefill_chunks"] < 3:
        raise SystemExit("/metrics lost the prefill chunks")
    g = metrics["gauges"]
    if g["generate.kv_pages_in_use"] != 0:
        raise SystemExit(f"{g['generate.kv_pages_in_use']} pages leaked")
    # The cache's sizes on /metrics against the shape arithmetic of the
    # configuration (a GQA model's KV heads): a page, and a slot at the
    # default tier.
    slot = engine._cache_len(engine.prompt_buckets[-1],
                             engine.default_max_new_tokens)
    want_bytes = {"generate.kv_cache_bytes_per_slot":
                  kv_bytes(cfg, slot, kv_quant),
                  "generate.kv_page_bytes": kv_bytes(cfg, page or 0, kv_quant)}
    if {k: g[k] for k in want_bytes} != want_bytes:
        raise SystemExit(
            f"/metrics cache bytes {[g[k] for k in want_bytes]}, the shapes "
            f"give {list(want_bytes.values())}")
    row = {
        "case": "serving", "model": model, "load_s": load_s,
        "kv_quant": kv_quant or "none",
        "kv_page_size": health["kv_page_size"], "kv_pages": health["kv_pages"],
        "decode_attn_impl": "flash", "device": health["device"],
        "short_batch_s": batch_s, "short_batches": short_batches,
        "stream_lines": len(lines), "long_prefill_chunks": long_chunks,
        "admission_s": admit_s, "admitted": admitted,
        "prefill_leg": {
            "prompt_bytes": leg_bytes, "max_new_tokens": LONG_LEG_NEW,
            "bucket": LONG_LEG_BUCKET, "window": window,
            "chunks": leg_chunks, "batches": leg_batches, "seconds": leg_s,
            "ttft_ms": leg_ttft,
            "ttft_ms_p50": statistics.median(leg_ttft),
            "ttft_ms_max": max(leg_ttft),
        },
        "prefill_chunks": all_chunks, "decode_steps": decode_steps,
        "bodies": bodies,
        "growths": metrics["counters"]["generate.growths"],
        "compactions": metrics["counters"]["generate.compactions"],
        "kv_pages_in_use_at_end": g["generate.kv_pages_in_use"],
        "kv_page_bytes": g["generate.kv_page_bytes"],
        "kv_cache_bytes_per_slot": g["generate.kv_cache_bytes_per_slot"],
        "launches": launches,
        "decode_bytes_per_step": g["generate.decode_bytes_per_step"],
    }
    return row, engine


# -- phase 5: correctness -----------------------------------------------

def paged_generate(model, ids, pads, n_new):
    """Greedy generation through a paged cache: every row's pages are
    drawn from a fresh pool in shuffled order, then the page-native
    prefill and the decode chunk write and read them through the
    table."""
    import numpy as np
    import torch

    from mlapi_tpu_torch.models.gpt import decode_chunk_fn, paged_prefill_fn
    from mlapi_tpu_torch.ops.quant import paged_cache_tree
    from mlapi_tpu_torch.serving.paged_pool import PagePool

    b, p = ids.shape
    npv = -(-(p + n_new) // PAGE)
    pool = PagePool(model, page_size=PAGE, num_pages=b * npv + 1)
    pages = np.random.default_rng(3).permutation(pool.alloc(b * npv))
    cache = paged_cache_tree(pool.layers, pages.reshape(b, npv))
    n_pad = torch.as_tensor(pads, device=ids.device)
    temps, seeds = np.zeros(b, np.float32), np.zeros(b, np.int64)
    top_k, top_p = np.zeros(b, np.int64), np.ones(b, np.float32)
    first, cache = paged_prefill_fn(model, cache, ids, 0, seeds, temps,
                                    n_pad, top_k, top_p)
    rest, _, _ = decode_chunk_fn(model, cache, first, p, n_pad, temps, seeds,
                                 1, top_k, top_p, chunk=n_new - 1)
    return torch.cat([first[:, None], rest], dim=1)


def check_small_f32(num_heads: int, family: str = "gpt_lm",
                    kv_heads=None, hidden: int = 128):
    """A small float32 model: greedy streams through the flash kernels,
    contiguous and paged, equal the einsum oracle's, for both cache
    formats. GPT: two heads of 64; four heads of 32 are docs-gpt's widths
    (``mlapi_tpu/config.py``: hidden 128, 4 heads, 256 positions). Llama:
    docs-llama's widths (4 heads on 2 KV heads of 32) and a group of 8
    (8 heads on 1 KV head of 64). The two-head GPT also drives the
    admission check."""
    import torch

    from mlapi_tpu_torch.models import get_model

    kw = {} if kv_heads is None else {"num_kv_heads": kv_heads}
    model = get_model(family, vocab_size=260, hidden_size=hidden,
                      num_layers=2, num_heads=num_heads, max_positions=256,
                      compute_dtype="float32", seed=1, device="cuda", **kw)
    with torch.no_grad():   # sharper logits than the 0.02 init
        for p in model.parameters():
            if p.ndim == 2:
                p.mul_(10.0 * math.sqrt(128 / hidden))
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
        model.configure(decode_attn_impl="flash")
        with torch.inference_mode():
            streams[(kvq, "paged flash")] = paged_generate(
                model, ids, pads, 48
            ).cpu().tolist()
    same = {
        f"{kvq}, {impl}": streams[(kvq, "einsum")] == streams[(kvq, impl)]
        for kvq in ("none", "int8") for impl in ("flash", "paged flash")
    }
    emit({"case": "f32_greedy_identity", "model": family,
          "num_heads": num_heads, "kv_heads": model.kv_heads,
          "head_dim": model.head_dim, "equals_einsum": same})
    if not all(same.values()):
        raise SystemExit(f"{family}: greedy streams differ from einsum at "
                         f"{num_heads} heads on {model.kv_heads}: {same}")
    if family == "gpt_lm" and num_heads == 2:
        check_admission_f32(model)


ADMIT_F32 = (("the first long request", 48), ("joiner", 3),
             ("another joiner arrives", 6))


def check_admission_f32(model):
    """Continuous admission, deterministic, on both layouts: a batch of
    a 48-token and a 3-token request, and a joiner staged from the
    start, which ``max_batch`` 2 holds back until the short request has
    finished and then admits into that row (``tests/test_torch_paged_
    serving.py``'s scenario, on the card; plain chunks, as there). Each stream must equal the
    einsum oracle's stream of its prompt alone, and a paged engine must
    end with every page back in its pool."""
    import torch

    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.serving.requests import _SyncSink
    from mlapi_tpu_torch.text import ByteTokenizer

    tok = ByteTokenizer()
    model.configure(kv_quant="none", decode_attn_impl="einsum")
    with torch.inference_mode():
        want = [model.generate(
            torch.as_tensor([tok.token_ids(t)], device=model.device),
            max_new_tokens=n,
        )[0].tolist() for t, n in ADMIT_F32]
    model.configure(decode_attn_impl="flash")
    for page in (None, PAGE):
        eng = TextGenerationEngine(model, tokenizer=tok, max_batch=2,
                                   chunk=2, prompt_buckets=(16, 32, 64),
                                   kv_page_size=page)
        outs: list = [[] for _ in ADMIT_F32]
        sinks = [_SyncSink(eng._encode(t, n, 0.0, 0, None), o)
                 for (t, n), o in zip(ADMIT_F32, outs)]
        eng._admit.append(sinks[2])
        # Plain chunks: a fused width would finish the long request in
        # one chunk after the short one ends, leaving no boundary to
        # admit the joiner at.
        eng._run_batch(sinks[:2], admit=True, fused_ok=False)
        row = {"case": "f32_admission", "kv_page_size": page,
               "admitted": eng.admitted, "equals_alone": outs == want,
               "errors": [repr(s.error) for s in sinks if s.error],
               "kv_pages_in_use_at_end": eng.kv_pages_in_use}
        emit(row)
        if (row["errors"] or row["admitted"] != 1 or not row["equals_alone"]
                or row["kv_pages_in_use_at_end"]):
            raise SystemExit(f"admission into a finished row failed: {row}")


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
    served = model.decode_attn_impl
    model.configure(decode_attn_impl="einsum")
    try:
        agr = kv_greedy_agreement(
            model, prompt, 65, pad_lens=pads,
            quant_overrides={"kv_quant": kv_quant or "none",
                             "decode_attn_impl": "flash"},
        )
    finally:
        # The engine serves on after this (the prefix phase).
        model.configure(decode_attn_impl=served)
    emit({"case": "agreement", "model": type(model).__name__,
          "kv_quant": kv_quant or "none",
          "vs": "einsum, kv none", "tokens": 64, "rows": len(rows),
          "top1_agreement": agr})
    if agr < 0.9:
        raise SystemExit(f"flash top-1 agreement {agr} below 0.9")


def device_kernels(prof):
    """The device-side events of a ``torch.profiler`` run that are
    kernels or copies: GPU ranges of user annotations (such as
    ``Optimizer.step#AdamW.step``) span kernels already counted."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# Every profile_decode row of the run, by (model class, width, cache
# format, page size): phase 12 sets the int8-weight engines' beside the
# float engines' of phases 5 and 7.
PROFILES: dict = {}


def profile_decode(engine, runs: int = 5, lora=None) -> dict:
    """Where one serving decode step's time goes: an 8-step decode chunk
    at B = 8 (bucket 16, default tier) through the engine's model and
    cache layout (a paged engine's rows map pages of its pool). Wall
    time per step without the profiler (``runs`` chunks, each timed
    alone with ``perf_counter`` and a device sync: min, median, max);
    then one chunk under ``torch.profiler`` for the device time of its
    CUDA kernels, their count and the flash-decode kernel's share. The
    device's busy share is profiled device time over unprofiled wall
    time, given for the median and for the extremes of the runs. A paged
    engine's runs alternate with the same chunk on a contiguous cache of
    the same model (one order, then the other), so the two layouts'
    host times compare within one window. ``lora`` (an adapter engine's
    ``adapters.batch_params(...)``) runs every step with that adapter
    context; ``lora_mode`` names it in the row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.models.gpt import (
        decode_chunk_fn, paged_prefill_fn, prefill_fn,
    )
    from mlapi_tpu_torch.ops.quant import (
        kv_cache_append, kv_cache_coords, paged_cache_tree,
    )

    model, b, steps = engine.model, 8, 8
    total = engine._cache_len(16, engine.default_max_new_tokens)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(4, 260, (b, 16), generator=g).to(engine.device)
    n_pad = torch.zeros(b, dtype=torch.long, device=engine.device)
    host = dict(temps=np.zeros(b, np.float32), seeds=np.zeros(b, np.int64),
                top_k=np.zeros(b, np.int64), top_p=np.ones(b, np.float32))
    pool, pages = engine.pool, None
    # Passed only when given: mlapi_tpu_torch/tools/parent_ab.py runs
    # this against a parent tree whose functions take no ``lora``.
    adapter = {} if lora is None else {"lora": lora}

    def chunk(cache, tok, pos):
        return decode_chunk_fn(
            model, cache, tok, pos, n_pad, host["temps"], host["seeds"],
            np.ones(b, np.int64), host["top_k"], host["top_p"], chunk=steps,
            **adapter,
        )

    def timed(cache, tok) -> float:
        t0 = time.perf_counter()
        chunk(cache, tok, 16 + steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    with torch.inference_mode():
        contiguous = None
        tok, cache = prefill_fn(model, prompt, host["seeds"], host["temps"],
                                n_pad, host["top_k"], host["top_p"],
                                total_len=total, **adapter)
        if pool is not None:
            contiguous = (cache, chunk(cache, tok, 16)[2])   # warm
            pages = pool.alloc(b * -(-total // pool.page))
            cache = paged_cache_tree(pool.layers, pages.reshape(b, -1))
            tok, cache = paged_prefill_fn(
                model, cache, prompt, 0, host["seeds"], host["temps"],
                n_pad, host["top_k"], host["top_p"], **adapter,
            )
        _, cache, tok = chunk(cache, tok, 16)        # warm
        torch.cuda.synchronize()
        walls, beside = [], []
        for i in range(runs):
            if contiguous is not None and i % 2:
                beside.append(timed(*contiguous))
            walls.append(timed(cache, tok))
            if contiguous is not None and not i % 2:
                beside.append(timed(*contiguous))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(cache, tok, 16 + steps)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / steps
        # The host's side of one layer's cache append at this step's
        # shape (slot 40, inside the tier): the time to issue the call,
        # no device sync inside the loop, mean of 48 calls; and the page
        # coordinates, which a step computes once for all layers.
        kv = torch.zeros(b, 1, model.kv_heads, model.head_dim,
                         dtype=model.cdt, device=engine.device)
        layer, slot, reps = cache["layer_0"], 16 + 3 * steps, 48
        coords = kv_cache_coords(cache, slot, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            kv_cache_append(layer, kv, kv, slot, model.cdt, coords)
        append_ms = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            kv_cache_coords(cache, slot, 1)
        coords_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    if pages is not None:
        pool.release(pages)
    kernels = device_kernels(prof)
    dev_us = sum(e.device_time_total for e in kernels)
    attn_us = sum(e.device_time_total for e in kernels
                  if "decode_kernel" in e.name)
    # Where the host's time goes: the ops with the most self CPU time
    # under the profiler (which inflates each), per step.
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    host_top = [{"op": a.key, "self_cpu_ms_per_step":
                 a.self_cpu_time_total / 1e3 / steps,
                 "calls_per_step": a.count / steps} for a in host[:10]]
    syncs = sum(a.count for a in host if a.key in (
        "aten::_local_scalar_dense", "cudaStreamSynchronize",
        "cudaDeviceSynchronize")) / steps
    walls.sort()
    beside.sort()
    dev_ms = dev_us / 1e3 / steps
    row = {
        "case": "profile", "model": type(model).__name__, "B": b,
        "L": total, "steps": steps,
        "kv_quant": engine.kv_quant, "decode_attn_impl": "flash",
        "lora_mode": None if lora is None else (
            "gathered" if "rows" in lora["layer_0"] else "grouped"),
        "kv_page_size": pool.page if pool is not None else None,
        "wall_ms_per_step": {"min": walls[0], "median": walls[runs // 2],
                             "max": walls[-1], "runs": runs},
        "contiguous_interleaved_wall_ms_per_step": {
            "min": beside[0], "median": beside[runs // 2],
            "max": beside[-1], "runs": runs,
        } if beside else None,
        "profiled_wall_ms_per_step": prof_wall,
        "device_ms_per_step": dev_ms if dev_us else "not measured",
        "device_busy_share": {
            "median": dev_ms / walls[runs // 2],
            "min": dev_ms / walls[-1], "max": dev_ms / walls[0],
        } if dev_us else "not measured",
        "kernels_per_step": len(kernels) / steps,
        "flash_decode_share_of_device": (attn_us / dev_us) if dev_us
        else "not measured",
        "append_host_ms_per_layer": append_ms,
        "page_coords_host_ms": coords_ms if coords is not None else None,
        "host_syncs_per_step": syncs,
        "host_top_ops": host_top,
    }
    emit(row)
    if lora is None:
        PROFILES[(type(model).__name__, model.hidden_size,
                  engine.kv_quant, row["kv_page_size"])] = row
    return row


def profile_prefill(engine, runs: int = 5) -> None:
    """Where one long prefill's time goes: an 896-token prompt at B = 8
    (the prefill-heavy leg's bucket, 7 chunks of 128) through the
    engine's layout -- ``extend_chunk_fn`` on a contiguous cache,
    ``paged_extend_fn`` through pool pages. Wall ms per prefill without
    the profiler (``runs`` prefills, each timed alone with a device sync),
    then one under ``torch.profiler``: device ms, flash-extend's share
    (the B2/B4 kernel and, with several splits, its merge) and kernels per
    chunk."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.models.gpt import extend_chunk_fn, paged_extend_fn
    from mlapi_tpu_torch.ops.quant import paged_cache_tree

    model, b, cp = engine.model, 8, engine.prompt_buckets[-1]
    bucket = LONG_LEG_BUCKET
    total = engine._cache_len(bucket, LONG_LEG_NEW)
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(4, 260, (b, bucket), generator=g).to(engine.device)
    n_pad = torch.zeros(b, dtype=torch.long, device=engine.device)
    pool = engine.pool
    pages = None
    if pool is not None:
        pages = pool.alloc(b * -(-total // pool.page))

    def prefill():
        if pool is None:
            cache, fn = model.init_cache(b, total), extend_chunk_fn
        else:
            cache = paged_cache_tree(pool.layers, pages.reshape(b, -1))
            fn = paged_extend_fn
        for c0 in range(0, bucket, cp):
            cache, _ = fn(model, cache, prompt[:, c0:c0 + cp], c0, n_pad)

    def timed() -> float:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        timed()                                     # warm
        walls = sorted(timed() for _ in range(runs))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill()
            torch.cuda.synchronize()
    if pages is not None:
        pool.release(pages)
    kernels = device_kernels(prof)
    dev_us = sum(e.device_time_total for e in kernels)
    ext_us = sum(e.device_time_total for e in kernels
                 if "extend_mma" in e.name or "splitk" in e.name)
    chunks = bucket // cp
    emit({
        "case": "prefill_profile", "model": type(model).__name__, "B": b,
        "bucket": bucket, "L": total,
        "chunks": chunks, "kv_quant": engine.kv_quant,
        "kv_page_size": pool.page if pool is not None else None,
        "through": "extend_chunk_fn" if pool is None else "paged_extend_fn",
        "wall_ms": {"median": statistics.median(walls), "min": walls[0],
                    "max": walls[-1], "runs": runs},
        "device_ms": dev_us / 1e3 if dev_us else "not measured",
        "flash_extend_ms": ext_us / 1e3 if dev_us else "not measured",
        "flash_extend_share_of_device": ext_us / dev_us if dev_us
        else "not measured",
        "kernels_per_chunk": len(kernels) / chunks,
    })


# -- phase 8: shared-prefix serving --------------------------------------

# A system prompt of 768 bytes (one token a byte: the entry's bucket is the
# page-aligned 768) and a second of 500 (bucket 500, 512 page-aligned),
# 8 suffixes of 16-120 bytes drawn from seed 0, 32 new tokens, greedy.
PREFIX_A = ("You answer questions about the serving engine from its "
            "documentation, quote what you can, and say so when you "
            "cannot. " * 8)[:768]
PREFIX_B = ("Summarize the request in one line, then answer it in the "
            "fewest words that are still correct. " * 8)[:500]
PREFIX_NEW = 32


def prefix_suffixes() -> list:
    import numpy as np

    sizes = np.random.default_rng(0).integers(16, 121, 8)
    text = ("how does the engine batch requests that share a system "
            "prompt, and what does each of them pay for it? ") * 3
    return [f"{i} " + text[7 * i:7 * i + int(n) - 2]
            for i, n in enumerate(sizes)]


def prefix_leg(engine, cfg, model: str, power) -> dict:
    """The prefix phase on a served engine (the CLI's factory, flash):
    a cold round of 8 concurrent streams naming ``PREFIX_A`` (one build,
    the other 7 wait for it), a warm round of the same (8 hits), one
    request naming ``PREFIX_B`` (its build), and a cross-prefix round, 4
    rows of each prefix in one batch (right-aligned to the 768-slot
    region: shifts of 268 slots, 16 pages in a paged pool). Launch
    counters zeroed just before and read just after: one flash-extend
    launch per layer per formation (the suffix block), all on the
    tensor-core body, one flash-decode per layer per decode step, no
    other kernel. Counters as the JAX engine counts this trace, shared
    pages while a paged batch runs, pages settling at the entries'
    pages, adopted bytes equal to the entries' cache bytes from
    ``init_cache`` shapes. Then one warm formation against the same
    prompts as plain ``prefix + text`` (wall and device ms), and flash's
    top-1 agreement with einsum over the cold round's prompts."""
    import statistics

    from mlapi_tpu_torch.ops.quant import kv_tree_bytes
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.server import BackgroundServer

    page = engine.kv_page_size or None
    layers = cfg["num_layers"]
    mine = (("paged_decode_attention", "paged_extend_attention") if page
            else ("decode_attention", "extend_attention"))
    suffixes = prefix_suffixes()
    steps, shared = [0], [0]
    decode_step = engine.model.decode_step

    def counted_step(*args, **kwargs):
        steps[0] += 1
        shared[0] = max(shared[0], engine.kv_pages_shared)
        return decode_step(*args, **kwargs)

    def bodies(prefixes):
        return [{"text": t, "prefix": p, "max_new_tokens": PREFIX_NEW}
                for t, p in zip(suffixes, prefixes)]

    want_pages = 0
    want_adopt = 0
    if page:
        for text in (PREFIX_A, PREFIX_B):
            bucket = -(-len(text) // page) * page
            want_pages += bucket // page
            want_adopt += kv_tree_bytes(
                engine.model.init_cache(1, bucket, device="meta"))
    engine.model.decode_step = counted_step
    t_leg = time.perf_counter()
    with BackgroundServer(build_app(engine)) as srv:
        zero_counters()
        steps[0] = 0
        b0 = engine.batch_calls
        cold_ttft, cold = concurrent_streams(
            srv.port, bodies([PREFIX_A] * 8), "prefix cold round")
        b1 = engine.batch_calls
        warm_ttft, warm = concurrent_streams(
            srv.port, bodies([PREFIX_A] * 8), "prefix warm round")
        b2 = engine.batch_calls
        solo = json.loads(post(srv.port, {
            "text": suffixes[0], "prefix": PREFIX_B,
            "max_new_tokens": PREFIX_NEW}))
        b3 = engine.batch_calls
        cross_ttft, cross = concurrent_streams(
            srv.port, bodies([PREFIX_A, PREFIX_B] * 4), "cross-prefix round")
        formations = engine.batch_calls - b0
        launches, bodies_ran = read_counters(SERVING)
        decode_steps, shared_max = steps[0], shared[0]
        # Rows drop their holds on the device thread after the terminal
        # frames; the entries keep theirs.
        deadline = time.monotonic() + 60.0
        while (engine.kv_pages_in_use != want_pages
               and time.monotonic() < deadline):
            time.sleep(0.01)
        metrics = get(srv.port, "/metrics")
    del engine.model.decode_step            # the class's method again
    leg_s = time.perf_counter() - t_leg
    c, g = metrics["counters"], metrics["gauges"]
    counters = {k: c[f"generate.{k}"] for k in (
        "prefix_builds", "prefix_misses", "prefix_hits", "prefix_fallbacks",
        "prefix_adopt_bytes", "kv_prefix_copy_fallback")}
    batches = {"cold": b1 - b0, "warm": b2 - b1, "solo": b3 - b2,
               "cross": engine.batch_calls - b3}
    row = {
        "case": "prefix_serving", "model": model,
        "kv_quant": engine.kv_quant, "kv_page_size": page,
        "prefix_bytes": [len(PREFIX_A), len(PREFIX_B)],
        "suffix_bytes": [len(t) for t in suffixes],
        "max_new_tokens": PREFIX_NEW, "batches": batches,
        "ttft_ms_p50": {"cold": statistics.median(cold_ttft),
                        "warm": statistics.median(warm_ttft),
                        "cross": statistics.median(cross_ttft)},
        "ttft_ms": {"cold": cold_ttft, "warm": warm_ttft,
                    "cross": cross_ttft},
        "counters": counters, "kv_pages_shared_max": shared_max,
        "kv_pages_in_use_at_end": g["generate.kv_pages_in_use"],
        "want_kv_pages_in_use": want_pages,
        "cow_copies": engine.pool.cow_copies if page else 0,
        "formations": formations, "decode_steps": decode_steps,
        "launches": launches, "bodies": bodies_ran, "seconds": leg_s,
        "card": power,
    }
    outs = cold + warm + [solo] + cross
    vocab = cfg["vocab_size"]
    if any(len(o["token_ids"]) != PREFIX_NEW
           or not all(0 <= t < vocab for t in o["token_ids"]) for o in outs):
        emit(row)
        raise SystemExit(f"{model} prefix leg: a request missed its tokens")
    if [o["prompt_tokens"] for o in cold] != [
            len(PREFIX_A) + len(t) for t in suffixes]:
        emit(row)
        raise SystemExit(f"{model} prefix leg: prompt_tokens disagree")
    # The JAX engine's counts for this trace: the cold round's first
    # request builds (a miss) and the other 7 wait for it (hits); the warm
    # round hits 8 times; PREFIX_B's request builds; the cross round hits
    # 8 times. Paged pools adopt each entry once; every shift is a page
    # multiple, so nothing is copied.
    want = {"prefix_builds": 2, "prefix_misses": 2, "prefix_hits": 23,
            "prefix_fallbacks": 0, "prefix_adopt_bytes": want_adopt,
            "kv_prefix_copy_fallback": 0}
    extend, decode = mine[1], mine[0]
    row["checks"] = checks = {
        "counters": counters == want,
        "one_batch_warm_cross": batches["warm"] == batches["cross"] == 1,
        "extend_one_per_layer_per_formation":
            launches[extend] == layers * formations
            and bodies_ran[extend]["mma"] == launches[extend],
        "decode_one_per_layer_per_step":
            launches[decode] == layers * decode_steps
            and bodies_ran[decode]["decode"] == launches[decode],
        "no_other_kernel": not any(launches[k] for k in KERNELS
                                   if k not in mine),
        "pages_shared_while_running": (shared_max > 0) == bool(page),
        "pages_settle_at_entries":
            g["generate.kv_pages_in_use"] == want_pages,
        "no_cow_when_aligned": row["cow_copies"] == 0,
    }
    row["want_counters"] = want
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{model} prefix leg failed: {checks}")
    prefix_formation_profile(engine, suffixes, power)
    prefix_agreement(engine, suffixes)
    return row


# -- 9. the unit scheduler and sampled tokens ---------------------------

# Sampled requests (fault C4): every filter on, a temperature near 1.
SAMPLING = {"temperature": 0.9, "top_k": 40, "top_p": 0.95}
SAMPLE_TEXT, SAMPLE_NEW = "sample a stream", 32
SAMPLE_MATES = (("mate one", 3), ("mate two", 4), ("mate three", 5))
OTHER_MATES = (("other mate a", 6), ("other mate b", 7), ("other mate c", 8))
# The two-group load: the 8 short prompts (one of them sampled) with 136
# new tokens, and one prompt of max_positions - 128 bytes (chunked
# prefill) with 16: together past the window, so two lanes.
SCHED_SHORT_NEW, SCHED_LONG_NEW = 136, 16
# The long-joiner leg: a 200-byte lane (bucket 256, 2 prefill chunks)
# with 80 new tokens, then a 200-byte joiner with 16, prefilled in 2
# chunks between the lane's decode chunks.
JOIN_LANE_NEW, JOIN_NEW = 80, 16
SCHED_DEADLINE_MS = 1000.0      # well inside the deadline rows' budgets
# The profiled window of the two-group load: decode steps 9-24 (after
# the first lane's first chunk), started and stopped on the dispatch
# thread, the one thread that runs the model's ops (stopping
# torch.profiler while another thread runs ops can crash the process).
PROFILE_FROM, PROFILE_STEPS = 9, 16


def engine_run(engine, sched: int, body):
    """Start the engine (collector and unit scheduler at ``sched``
    lanes), await ``body(loop)``, stop the engine; returns the body's
    result."""
    import asyncio

    async def main():
        engine.sched_max_batches = sched
        await engine.start()
        try:
            return await body(asyncio.get_running_loop())
        finally:
            await engine.stop()

    return asyncio.run(main())


def enqueue(engine, loop, specs, deadline_ms=None):
    """Encode and queue ``(text, n_new, sampling or None)`` requests with
    no await between them: the collector's first pop sees them all, and
    each group's rows follow the queue's order."""
    reqs = []
    for text, n, samp in specs:
        samp = samp or {}
        reqs.append(engine._encode(
            text, n, samp.get("temperature", 0.0), samp.get("seed", 0), loop,
            samp.get("top_k", 0), samp.get("top_p", 1.0), stream=True,
            deadline_ms=deadline_ms))
    for r in reqs:
        engine._queue.put_nowait(r)
    return reqs


async def collect_timed(req, t0):
    """(tokens, terminal error or None, ms to the first chunk, ms to the
    last)."""
    out, first, last = [], None, None
    while True:
        item = await req.queue.get()
        if item is None or isinstance(item, Exception):
            return out, item, first, last
        now = (time.perf_counter() - t0) * 1e3
        first = now if first is None else first
        last = now
        out.extend(item["token_ids"])


async def wait_until(pred, timeout_s: float = 120.0):
    import asyncio

    t_end = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > t_end:
            raise SystemExit("scheduler phase: a wait timed out")
        await asyncio.sleep(0.001)


def text_of(n: int, salt: str) -> str:
    """``n`` bytes of prose, distinct per ``salt``."""
    base = (f"{salt}: a long prompt pays its prefill in chunks, and a "
            f"scheduler interleaves them with decode. ")
    return (base * (n // len(base) + 1))[:n]


# Stop strings need text: GPT-2's random ids rarely fall in the byte
# range the tokenizer decodes, so they run on a byte-vocabulary GPT of
# the engine's format and layout.
STOP_CFG = dict(vocab_size=260, hidden_size=128, num_layers=2, num_heads=2,
                max_positions=256, compute_dtype="bfloat16")


def sampling_leg(engine, model: str, power) -> dict:
    """Fault C4: sampled tokens on the card (``temperature``, ``top_k``,
    ``top_p``). Through the engine, rows in queue order: the same seed
    gives the same stream, another seed another; a row's stream is the
    same in slot 0 and slot 3 of a batch of 4, and beside other batch
    mates (the same shapes); over HTTP the unary stream equals the
    engine's. A stop string, on ``STOP_CFG``'s model served with the
    engine's cache format and layout, ends unary and NDJSON answers
    where the text says (the text up to the stop's first match,
    ``stopped``, ids a prefix of the full stream's). A batch of 1
    beside a batch of 4 is reported, not held (other GEMM shapes)."""
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.serving.server import BackgroundServer
    from mlapi_tpu_torch.text import ByteTokenizer

    def batch(rows):
        async def body(loop):
            reqs = enqueue(engine, loop, [
                (t, SAMPLE_NEW, {**SAMPLING, "seed": seed})
                for t, seed in rows])
            outs = [await collect_timed(r, time.perf_counter())
                    for r in reqs]
            if any(e is not None for _, e, _, _ in outs):
                raise SystemExit(f"sampling leg: {[e for _, e, _, _ in outs]}")
            return [t for t, _, _, _ in outs]

        return engine_run(engine, 2, body)

    me = (SAMPLE_TEXT, 11)
    alone, again = batch([me])[0], batch([me])[0]
    other_seed = batch([(SAMPLE_TEXT, 12)])[0]
    first = batch([me, *SAMPLE_MATES])[0]
    last = batch([*SAMPLE_MATES, me])[3]
    mates = batch([me, *OTHER_MATES])[0]
    body = {"text": SAMPLE_TEXT, "seed": 11, "max_new_tokens": SAMPLE_NEW,
            **SAMPLING}
    with BackgroundServer(build_app(engine)) as srv:
        served = json.loads(post(srv.port, body))["token_ids"]
    small = GptLM(**STOP_CFG, seed=0, device=engine.device)
    small.configure(kv_quant=engine.kv_quant,
                    decode_attn_impl=engine.decode_attn_impl)
    stop_engine = TextGenerationEngine(
        small, tokenizer=ByteTokenizer(),
        kv_page_size=engine.kv_page_size or None)
    with BackgroundServer(build_app(stop_engine)) as srv:
        full = json.loads(post(srv.port, body))
        again_full = json.loads(post(srv.port, body))
        text = full["text"]
        # A printable ASCII character of the text, past its start.
        i = next((i for i in range(4, len(text))
                  if text[i].isascii() and text[i].isalnum()), None)
        stop = text[i] if i is not None else None
        cut = text.find(stop) if stop else -1
        unary = (json.loads(post(srv.port, {**body, "stop": stop}))
                 if stop else None)
        lines = ([json.loads(x) for x in post(srv.port, {
            **body, "stop": [stop], "stream": True}).decode().splitlines()
            if x.strip()] if stop else [])
    streamed = [t for x in lines[:-1] for t in x.get("token_ids", [])]
    ids = full["token_ids"]
    row = {
        "case": "sampling", "model": model, "kv_quant": engine.kv_quant,
        "kv_page_size": engine.kv_page_size or None, **SAMPLING,
        "max_new_tokens": SAMPLE_NEW, "stream": alone,
        "stop_model": STOP_CFG, "stop_text": text, "stop": stop,
        "batch_of_1_equals_batch_of_4": alone == first, "card": power,
    }
    row["checks"] = checks = {
        "same_seed_same_stream": alone == again,
        "other_seed_other_stream": alone != other_seed,
        "slot_0_equals_slot_3": first == last,
        "other_batch_mates_same_stream": first == mates,
        "http_equals_engine": served == alone,
        "in_vocab": all(0 <= t < engine.model.vocab_size for t in alone)
        and len(alone) == SAMPLE_NEW,
        "stop_model_same_seed_same_stream": ids == again_full["token_ids"],
        "stop_cuts_unary": stop is not None
        and unary["text"] == text[:cut] and unary.get("stopped") == stop
        and unary["token_ids"] == ids[:len(unary["token_ids"])],
        "stop_cuts_stream": stop is not None
        and lines[-1].get("done") is True and lines[-1]["text"] == text[:cut]
        and lines[-1].get("stopped") == stop
        and lines[-1]["token_ids"][:len(streamed)] == streamed
        and lines[-1]["token_ids"] == ids[:len(lines[-1]["token_ids"])],
    }
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{model} sampling leg failed: {checks}")
    return row


def entry_pages(engine) -> int:
    """Pages the resident prefix entries hold (0 without a pool)."""
    pool = engine.pool
    if pool is None:
        return 0
    with pool.lock:
        return sum(len(p) for p in pool._entries.values())


def two_group_load(engine, sched: int, profile: bool = False) -> dict:
    """The 8 short prompts (the first sampled) and one long prompt,
    queued together at ``sched`` lanes: per request its stream, TTFT and
    inter-token ms (wall, from the queue). ``profile``: decode steps
    ``PROFILE_FROM`` to ``PROFILE_FROM + PROFILE_STEPS - 1`` (whichever
    lanes they belong to, and the units between them) under
    ``torch.profiler``, the device synchronized at both ends; the
    kernels' summed duration over the window's wall time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity

    long_text = text_of(engine.model.max_positions - 128, "long")
    specs = [(p, SCHED_SHORT_NEW, {**SAMPLING, "seed": 11} if i == 0
              else None) for i, p in enumerate(SHORT_PROMPTS)]
    specs.append((long_text, SCHED_LONG_NEW, None))
    engine.sched_batches_live_max = 0
    window = {"n": 0}
    step = engine.model.decode_step

    def profiled_step(*args, **kwargs):
        window["n"] += 1
        if window["n"] == PROFILE_FROM:
            torch.cuda.synchronize()
            window["prof"] = torch.profiler.profile(
                activities=[ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        out = step(*args, **kwargs)
        if window["n"] == PROFILE_FROM + PROFILE_STEPS - 1:
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - window["t0"]
            window["prof"].__exit__(None, None, None)
            kernels = device_kernels(window.pop("prof"))
            window["busy"] = (
                sum(e.device_time_total for e in kernels) / 1e6 / wall_s
                if kernels else "not measured")
        return out

    async def body(loop):
        import asyncio

        t0 = time.perf_counter()
        reqs = enqueue(engine, loop, specs)
        outs = await asyncio.gather(*(collect_timed(r, t0) for r in reqs))
        return outs, (time.perf_counter() - t0), list(engine.sched.trace)

    if profile:
        engine.model.decode_step = profiled_step
    try:
        outs, wall, trace = engine_run(engine, sched, body)
    finally:
        engine.model.decode_step = step
    busy = window.get("busy")
    errors = [repr(e) for _, e, _, _ in outs if e is not None]
    if errors or [len(t) for t, _, _, _ in outs] != [
            n for _, n, _ in specs]:
        raise SystemExit(f"two-group load at {sched}: {errors}")
    lanes = [lane for lane, _ in trace]
    short = outs[:len(SHORT_PROMPTS)]
    return {
        "streams": [t for t, _, _, _ in outs],
        "ttft_ms_p50_short": statistics.median(f for _, _, f, _ in short),
        "itl_ms_p50": statistics.median(
            (last - first) / max(1, len(t) - 1) for t, _, first, last in outs),
        "device_busy_share": busy, "wall_s": wall,
        "batches_live_max": engine.sched_batches_live_max,
        "lane_switches": sum(a != b for a, b in zip(lanes, lanes[1:])),
    }


def sched_leg(engine, cfg, model: str, power) -> dict:
    """The unit scheduler on a served engine at ``--sched-max-batches
    2``, launch counters zeroed just before and read just after:

    - deadlines: 8 rows with budgets to the window's end and
      ``deadline_ms`` 1000 (admission control off) each end with a
      ``deadline_exceeded`` frame;
    - the page budget: the same 8 rows without a deadline hold the whole
      pool's worst case; a group that cannot share their window waits
      (a paged engine counts it in ``sched_pages_deferred``) until the
      rows are cancelled, then completes;
    - the two-group load (:func:`two_group_load`) at 1 and at 2 lanes,
      unprofiled, then profiled: at 2 both groups are live at once
      (``sched_batches_live_max == 2``) and the trace switches lanes;
      every stream, greedy and sampled, is the same at 1 and 2 (both
      modes form the same batches); the informational
      ``scheduler_load`` row gives each mode's TTFT p50 of the short
      group, inter-token p50 and device-busy share;
    - a long joiner: a 256-bucket lane, then a 200-byte prompt once its
      first chunk arrived; a paged engine prefills the joiner between
      the lane's decode chunks (2 chunks, ``interleaved_prefills``; a
      ``prefill`` unit between two of the lane's ``decode`` units), a
      contiguous one admits it in one prefill;
    - a drain with two lanes live and a 0.3 s budget: every stream ends
      (done, or a ``draining`` frame) and the scheduler goes idle.

    Exact launches summed over lanes: flash-decode one per layer per
    decode step, flash-extend one per layer per prefill chunk (chunked
    formations and interleaved joiners), all on the ``decode`` and
    ``mma`` bodies, no other kernel; pages settle at the prefix entries'
    pages."""
    import asyncio

    from mlapi_tpu_torch.serving.requests import (
        DeadlineExceeded, DrainCancelled,
    )

    page = engine.kv_page_size or None
    layers = cfg["num_layers"]
    mine = (("paged_decode_attention", "paged_extend_attention") if page
            else ("decode_attention", "extend_attention"))
    steps = [0]
    decode_step = engine.model.decode_step

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return decode_step(*args, **kwargs)

    t_leg = time.perf_counter()
    resident = entry_pages(engine)
    engine.model.decode_step = counted_step
    zero_counters()
    chunks0 = engine.prefill_chunks
    try:
        # Deadlines: 8 rows whose budgets outlast the deadline.
        d0 = (engine.deadline_expired_queued + engine.deadline_expired_prefill
              + engine.deadline_expired_decode)
        big = engine.model.max_positions - 16

        async def deadline(loop):
            t0 = time.perf_counter()
            rows = enqueue(engine, loop, [(p, big, None) for p in SHORT_PROMPTS],
                           deadline_ms=SCHED_DEADLINE_MS)
            return await asyncio.gather(*(collect_timed(r, t0) for r in rows))

        engine.admission_control = False    # deadlines still expire
        try:
            outs = engine_run(engine, 2, deadline)
        finally:
            engine.admission_control = True
        expired = {
            "deadline_ms": SCHED_DEADLINE_MS,
            "frames": [getattr(e, "code", repr(e)) for _, e, _, _ in outs],
            "ms_at_last_chunk": [last for _, _, _, last in outs],
            "counted": (engine.deadline_expired_queued
                        + engine.deadline_expired_prefill
                        + engine.deadline_expired_decode) - d0,
        }

        # The page budget: the same 8 rows (no deadline) reserve the
        # whole pool; a group that cannot share their window waits
        # (paged) until they are cancelled, as by a client disconnect.
        pd0 = engine.sched_pages_deferred

        async def budget(loop):
            t0 = time.perf_counter()
            rows = enqueue(engine, loop, [(p, big, None) for p in SHORT_PROMPTS])
            await wait_until(lambda: engine.sched_batches_live == 1)
            (late,) = enqueue(engine, loop,
                              [(text_of(40, "late"), SCHED_LONG_NEW, None)])
            late_out = asyncio.ensure_future(collect_timed(late, t0))
            await wait_until(lambda: engine.sched_pages_deferred > pd0
                             or late_out.done())
            for r in rows:
                r.cancel()
            out = await late_out
            await wait_until(lambda: engine.sched.idle)
            return out

        late_out = engine_run(engine, 2, budget)
        expired.update({
            "late_group_tokens": len(late_out[0]),
            "late_group_error": repr(late_out[1]) if late_out[1] else None,
            "pages_deferred": engine.sched_pages_deferred - pd0,
        })

        load = {s: two_group_load(engine, s) for s in (1, 2)}
        for s in (1, 2):
            load[s]["device_busy_share"] = two_group_load(
                engine, s, profile=True)["device_busy_share"]

        # The long joiner.
        lane_text, join_text = text_of(200, "lane"), text_of(200, "joiner")
        il0, ad0, pc0 = (engine.interleaved_prefills, engine.admitted,
                         engine.prefill_chunks)

        async def joiner(loop):
            t0 = time.perf_counter()
            (lane,) = enqueue(engine, loop, [(lane_text, JOIN_LANE_NEW, None)])
            first = await lane.queue.get()
            n0 = len(engine.sched.trace)
            (join,) = enqueue(engine, loop, [(join_text, JOIN_NEW, None)])
            outs = await asyncio.gather(collect_timed(lane, t0),
                                        collect_timed(join, t0))
            return first, outs, list(engine.sched.trace)[n0:]

        first, (lane_out, join_out), jtrace = engine_run(engine, 2, joiner)
        kinds = [k for _, k in jtrace]
        joined = {
            "lane_tokens": len(first["token_ids"]) + len(lane_out[0]),
            "joiner_tokens": len(join_out[0]),
            "errors": [repr(e) for e in (lane_out[1], join_out[1]) if e],
            "interleaved_prefills": engine.interleaved_prefills - il0,
            "admitted": engine.admitted - ad0,
            "prefill_chunks": engine.prefill_chunks - pc0,
            "trace": kinds,
            # A prefill unit with the lane's decode units on both sides.
            "prefill_between_decodes": any(
                kinds[i] == "prefill" and "decode" in kinds[:i]
                and "decode" in kinds[i + 1:] for i in range(len(kinds))),
        }

        # A drain with two lanes live.
        async def drain(loop):
            t0 = time.perf_counter()
            reqs = enqueue(engine, loop, [
                (SHORT_PROMPTS[0], SCHED_SHORT_NEW, None),
                (text_of(engine.model.max_positions - 128, "long"),
                 SCHED_LONG_NEW, None)])
            tasks = [asyncio.ensure_future(collect_timed(r, t0))
                     for r in reqs]
            await wait_until(lambda: engine.sched_batches_live == 2
                             or all(t.done() for t in tasks))
            await engine.drain(0.3)
            outs = await asyncio.gather(*tasks)
            await wait_until(lambda: engine.sched.idle)
            return outs

        outs = engine_run(engine, 2, drain)
        drained = {
            "ends": ["done" if e is None else getattr(e, "code", repr(e))
                     for _, e, _, _ in outs],
            "all_terminated": all(e is None or isinstance(e, DrainCancelled)
                                  for _, e, _, _ in outs),
        }
        t_end = time.monotonic() + 60.0
        while (engine.kv_pages_in_use != resident
               and time.monotonic() < t_end):
            time.sleep(0.01)
    finally:
        del engine.model.decode_step        # the class's method again
    launches, bodies = read_counters(SERVING)
    decode_steps, chunks = steps[0], engine.prefill_chunks - chunks0
    extend, decode = mine[1], mine[0]
    info = {str(s): {k: load[s][k] for k in (
        "ttft_ms_p50_short", "itl_ms_p50", "device_busy_share", "wall_s")}
        for s in (1, 2)}
    emit({"case": "scheduler_load", "model": model,
          "kv_quant": engine.kv_quant, "kv_page_size": page,
          "short_rows": len(SHORT_PROMPTS), "short_new": SCHED_SHORT_NEW,
          "long_bytes": engine.model.max_positions - 128,
          "long_new": SCHED_LONG_NEW, "profiled_decode_steps": [PROFILE_FROM,
                                    PROFILE_FROM + PROFILE_STEPS - 1],
          "by_sched_max_batches": info, "card": power})
    row = {
        "case": "scheduler", "model": model, "kv_quant": engine.kv_quant,
        "kv_page_size": page, "sched_max_batches": 2,
        "two_groups": {k: load[2][k] for k in (
            "batches_live_max", "lane_switches")},
        "serial_batches_live_max": load[1]["batches_live_max"],
        "joiner": joined, "deadline": expired, "drain": drained,
        "decode_steps": decode_steps, "prefill_chunks": chunks,
        "launches": launches, "bodies": bodies,
        "kv_pages_in_use_at_end": engine.kv_pages_in_use,
        "entry_pages": resident,
        "seconds": time.perf_counter() - t_leg, "card": power,
    }
    row["checks"] = checks = {
        "two_lanes_live": load[2]["batches_live_max"] == 2
        and load[1]["batches_live_max"] == 1,
        "trace_switches_lanes": load[2]["lane_switches"] >= 2,
        "streams_same_at_1_and_2": load[1]["streams"] == load[2]["streams"],
        "joiner_streams": not joined["errors"]
        and joined["lane_tokens"] == JOIN_LANE_NEW
        and joined["joiner_tokens"] == JOIN_NEW,
        "joiner_between_decode_chunks": (
            joined["interleaved_prefills"] == 1 and joined["admitted"] == 1
            and joined["prefill_chunks"] == 4
            and joined["prefill_between_decodes"]) if page else (
            joined["admitted"] == 1 and joined["prefill_chunks"] == 2),
        "deadline_frames": expired["frames"]
        == [DeadlineExceeded.code] * len(SHORT_PROMPTS)
        and expired["counted"] == len(SHORT_PROMPTS),
        "late_group_completes": expired["late_group_tokens"] == SCHED_LONG_NEW
        and expired["late_group_error"] is None,
        # A contiguous engine has no page budget: the group starts at once.
        "tight_pool_defers": expired["pages_deferred"] >= 1 if page
        else expired["pages_deferred"] == 0,
        "drain_terminates_every_stream": drained["all_terminated"],
        "extend_one_per_layer_per_chunk":
            launches[extend] == layers * chunks
            and bodies[extend]["mma"] == launches[extend],
        "decode_one_per_layer_per_step":
            launches[decode] == layers * decode_steps
            and bodies[decode]["decode"] == launches[decode],
        "no_other_kernel": not any(launches[k] for k in KERNELS
                                   if k not in mine),
        "pages_settle_at_entries": engine.kv_pages_in_use == resident,
    }
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{model} scheduler phase failed: {checks}")
    return row


def prefix_formation_profile(engine, suffixes, power, runs: int = 5):
    """One warm prefix formation (8 rows of ``PREFIX_A`` and the
    suffixes: the entry's KV into the batch's cache or its pages shared,
    one suffix block, the first token) next to the same prompts as plain
    ``prefix + text`` (a 7-chunk prefill at bucket 896): wall ms per
    formation (``runs``, each with a device sync; median) and device ms
    under ``torch.profiler``, with the kernels each launched."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.serving.requests import _SyncSink

    out = {}
    for label, encode in (
        ("prefix", lambda t: engine._encode(t, PREFIX_NEW, 0.0, 0, None,
                                            prefix=PREFIX_A)),
        ("plain", lambda t: engine._encode(PREFIX_A + t, PREFIX_NEW, 0.0, 0,
                                           None)),
    ):
        sinks = [_SyncSink(encode(t), []) for t in suffixes]

        def form():
            run = engine._form_batch(list(sinks))
            torch.cuda.synchronize()
            run._paged_cleanup()
            return run

        def timed() -> float:
            t0 = time.perf_counter()
            form()
            return (time.perf_counter() - t0) * 1e3

        with torch.inference_mode():
            run = form()                                # warm
            walls = sorted(timed() for _ in range(runs))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                form()
        kernels = device_kernels(prof)
        dev_us = sum(e.device_time_total for e in kernels)
        out[label] = {
            "bucket": run.bucket, "prefix_len": run.p_len, "B": run.b,
            "wall_ms": {"median": statistics.median(walls), "min": walls[0],
                        "max": walls[-1], "runs": runs},
            "device_ms": dev_us / 1e3 if dev_us else "not measured",
            "kernels": len(kernels),
        }
    emit({"case": "prefix_formation_profile",
          "model": type(engine.model).__name__,
          "kv_quant": engine.kv_quant, "kv_page_size": engine.kv_page_size,
          **out, "card": power})


# The int8 floor's margin under the plain path's own reading: three
# standard errors of the difference of two 512-token readings near 0.98,
# 3 * sqrt(2 * 0.98 * 0.02 / 512) (on an H100, readings at TinyLlama's
# width scatter 0.973-0.984 on either path, in either format).
AGREEMENT_MARGIN = 0.026


def forced_agreement(engine, prompts, n: int = 64):
    """Teacher-forced top-1 agreement of flash with einsum through the
    engine's own formation (``_form_batch``: on a paged engine the entry's
    shared pages, a COW where the entry is unaligned, the suffix block
    through B4; on a contiguous one the entry's KV in every row through
    B2), then ``n - 1`` decode steps on the formation's cache (B1/B3
    under flash), over the engine's cache format on both sides: the
    kernels against the oracle, with the cache's own rounding on both.
    ``prompts`` are ``(text, prefix or None)``. The first token is
    compared too.

    Returns ``(agreement, ties)``: for each position where the two
    disagree, the einsum logits' top-1 - top-2 margin and the largest
    |flash - einsum| logit difference there (the flash run reads the
    einsum run's tokens, so both see the same history); ``ties`` says
    whether every margin is below its difference."""
    import torch

    import mlapi_tpu_torch.models.gpt as gpt
    from mlapi_tpu_torch.serving.requests import _SyncSink

    model = engine.model
    served = model.decode_attn_impl
    pick = gpt._pick_token

    def run(forced=None):
        sinks = [_SyncSink(engine._encode(t, n, 0.0, 0, None, prefix=p), [])
                 for t, p in prompts]
        firsts = []

        def capture(temps, logits, *args, **kwargs):
            firsts.append(logits.float())
            return pick(temps, logits, *args, **kwargs)

        gpt._pick_token = capture       # the formation's first logits
        try:
            batch = engine._form_batch(sinks)
        finally:
            gpt._pick_token = pick
        b = batch.b
        try:
            tok = batch._first
            toks, logs = [tok[:b]], [firsts[-1][:b]]
            for t in range(n - 1):
                if batch.pool is not None:
                    batch._ensure_pages(1, list(range(b)))
                if forced is not None:
                    tok = tok.clone()
                    tok[:b] = forced[:, t]
                logits, batch.cache = model.decode_step(
                    batch.cache, tok[:, None], batch.pos, batch._n_pad_dev(),
                    batch.p_len, batch._lo_arg())
                tok = pick(batch.temps, logits, batch.seeds, batch.step)
                batch.pos += 1
                toks.append(tok[:b])
                logs.append(logits[:b].float())
        finally:
            batch._paged_cleanup()
        return torch.stack(toks, dim=1), torch.stack(logs, dim=1)

    try:
        with torch.inference_mode():
            model.configure(decode_attn_impl="einsum")
            ref, ref_logits = run()
            model.configure(decode_attn_impl="flash")
            got, got_logits = run(forced=ref)
    finally:
        model.configure(decode_attn_impl=served)
    ties = []
    for row, pos in (got != ref).nonzero().tolist():
        top2 = ref_logits[row, pos].topk(2).values
        diff = (got_logits[row, pos] - ref_logits[row, pos]).abs().max()
        ties.append({"row": row, "pos": pos,
                     "margin": float(top2[0] - top2[1]),
                     "max_abs_diff": float(diff)})
    return float((got == ref).float().mean()), ties


def prefix_agreement(engine, suffixes, n: int = 64) -> float:
    """:func:`forced_agreement` over the cold round's prompts through the
    prefix path, beside the same prompts as plain ``prefix + text`` (the
    witness: a 7-chunk prefill, then decode, on the same engine). Floor
    0.98 over a bf16 cache; over int8, 0.98 or the witness's reading
    less ``AGREEMENT_MARGIN``, whichever is lower (the prefix path no
    worse than the plain one within the readings' noise), with the
    witness itself held at 0.9 (:func:`agreement`'s floor). Each
    disagreeing position of either path is listed with its einsum
    margin and its largest flash - einsum logit difference, and
    ``all_ties`` says whether every margin is below that difference
    (fault C3's test)."""
    agr, ties = forced_agreement(engine, [(t, PREFIX_A) for t in suffixes],
                                 n)
    plain, plain_ties = forced_agreement(
        engine, [(PREFIX_A + t, None) for t in suffixes], n)
    int8 = engine.kv_quant != "none"
    floor = min(0.98, plain - AGREEMENT_MARGIN) if int8 else 0.98
    emit({"case": "prefix_agreement", "model": type(engine.model).__name__,
          "kv_quant": engine.kv_quant, "kv_page_size": engine.kv_page_size,
          "path": "engine formation", "floor": floor,
          "vs": f"einsum, kv {engine.kv_quant}",
          "prefix_len": len(PREFIX_A), "tokens": n, "rows": len(suffixes),
          "top1_agreement": agr, "plain_top1_agreement": plain,
          "margin": AGREEMENT_MARGIN if int8 else None,
          "disagreements": {"prefix": ties, "plain": plain_ties},
          "all_ties": all(t["margin"] < t["max_abs_diff"]
                          for t in ties + plain_ties)})
    if agr < floor or (int8 and plain < 0.9):
        raise SystemExit(f"prefix path: flash top-1 agreement {agr} (plain "
                         f"path {plain}), floor {floor}")
    return agr


# Exact f32 streams: an aligned prefix (100 bytes: bucket 100, 112 in
# 16-token pages) and one at the window edge (230 bytes of a 256-position
# model: 240 aligned would leave no room, so it stays unaligned and every
# row copies its group-end page on write), as same-prefix batches and as
# one cross-prefix batch (in pages: a 118-slot shift, the copy fallback).
PREFIX_F32 = (("the shared system prompt of the small model is exactly one "
               "hundred bytes long, give or take none at all")[:100],
              ("b" * 230))


def check_prefix_f32(family: str, num_heads: int, kv_heads=None):
    """A small float32 model (the widths :func:`check_small_f32` uses)
    through the flash kernels on both layouts: every prefix stream equals
    the stream of ``prefix + text`` served without a prefix (the
    reference's pinned equivalence), with the window-edge entry's COW
    copies (2) and the copy fallback (1) counted in a paged engine of the
    default pool (48 pages): the fallback's 32 private pages evict the
    first entry's idle set (7 pages), and pages settle at the window-edge
    entry's 15."""
    import torch

    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.serving.requests import _SyncSink
    from mlapi_tpu_torch.text import ByteTokenizer

    kw = {} if kv_heads is None else {"num_kv_heads": kv_heads}
    model = get_model(family, vocab_size=260, hidden_size=128, num_layers=2,
                      num_heads=num_heads, max_positions=256,
                      compute_dtype="float32", seed=1, device="cuda", **kw)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 2:
                p.mul_(10.0)
    model.configure(kv_quant="none", decode_attn_impl="flash")
    p1, p2 = PREFIX_F32
    batches = [
        [("one", p1, 12), ("a second suffix", p1, 12),
         ("the third and longest suffix", p1, 10)],
        [("ij", p2, 8), ("kl", p2, 6)],
        [("mn", p1, 8), ("op", p2, 8)],
    ]
    for page in (None, PAGE):
        eng = TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                   prompt_buckets=(16, 32, 64),
                                   kv_page_size=page)
        equal = []
        for specs in batches:
            outs = [[] for _ in specs]
            sinks = [_SyncSink(eng._encode(t, n, 0.0, 0, None, prefix=p), o)
                     for (t, p, n), o in zip(specs, outs)]
            eng._run_batch(sinks)
            errors = [repr(s.error) for s in sinks if s.error]
            if errors:
                raise SystemExit(f"{family} f32 prefix batch: {errors}")
            equal.append([
                o == eng.generate_text(p + t, max_new_tokens=n)["token_ids"]
                for (t, p, n), o in zip(specs, outs)])
        row = {"case": "f32_prefix_streams", "model": family,
               "num_heads": num_heads, "kv_heads": model.kv_heads,
               "kv_page_size": page, "equals_prefix_plus_text": equal,
               "cow_copies": eng.pool.cow_copies if page else 0,
               "kv_prefix_copy_fallback": eng.kv_prefix_copy_fallback,
               "entry_evictions": eng.pool.entry_evictions if page else 0,
               "kv_pages_in_use": eng.kv_pages_in_use,
               "prefix_counters": [eng.prefix_builds, eng.prefix_misses,
                                   eng.prefix_hits]}
        emit(row)
        want_pool = (2, 1, 1, 15) if page else (0, 0, 0, 0)
        got_pool = (row["cow_copies"], row["kv_prefix_copy_fallback"],
                    row["entry_evictions"], row["kv_pages_in_use"])
        if not all(map(all, equal)) or got_pool != want_pool or (
                row["prefix_counters"] != [2, 2, 5]):
            raise SystemExit(f"{family} f32 prefix streams failed: {row}")


# -- phase 6: flash attention kernels (B5, B6, B7) -----------------------

def sst2_first_batch():
    """The sst2-bert run's first batch (``fit``'s ``batch_at(0)``) and
    the dataset it is drawn from."""
    import numpy as np

    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset

    cfg = get_preset("sst2-bert")
    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    idx = np.random.default_rng((cfg.seed, 0)).choice(
        len(splits.x_train), size=cfg.batch_size, replace=False)
    return cfg, splits, splits.x_train[idx], splits.y_train[idx]


def flash_shapes(sst2_x):
    """(name, B, L, H, KVH, dtype, causal, window, key lengths, D): (a)
    the sst2-bert training batch's key mask (its own lengths; the last
    row fully masked), (b) GPT-2 small causal at its full window, (c) a
    GQA sliding window in float32 with ragged key lengths, (d) docs-gpt's
    training batch (64 x 128 tokens, 4 heads of 32, float32, causal),
    (e) Llama-class causal GQA (32 query heads on 8 KV heads of 128, bf16,
    L = 1024), causal bf16 at head dims 256 and 512 (8 heads) and 160
    and 320 (8 on 4 KV heads, zero-padded to 256 and 512 by the
    wrappers), B = 2, L = 256, and (f) TinyLlama-1.1B's geometry, causal,
    32 query heads on 4 KV heads of 64 (a group of 8), B = 4, L = 2048."""
    import numpy as np

    lengths = (sst2_x != 0).sum(axis=1)
    lengths[-1] = 0
    ragged = np.random.default_rng(7).integers(128, 257, 4)
    return [
        ("sst2-bert", 32, 128, 12, 12, "bfloat16", False, None, lengths, 64),
        ("gpt2-causal", 8, 1024, 12, 12, "bfloat16", True, None, None, 64),
        ("gqa-window-f32", 4, 256, 8, 2, "float32", True, 64, ragged, 64),
        ("docs-gpt-d32", 64, 128, 4, 4, "float32", True, None, None, 32),
        ("llama-d128", 2, 1024, 32, 8, "bfloat16", True, None, None, 128),
        ("d256-causal", 2, 256, 8, 8, "bfloat16", True, None, None, 256),
        ("d160-gqa", 2, 256, 8, 4, "bfloat16", True, None, None, 160),
        ("d320-gqa", 2, 256, 8, 4, "bfloat16", True, None, None, 320),
        ("d512-causal", 2, 256, 8, 8, "bfloat16", True, None, None, 512),
        ("tinyllama-causal", 4, 2048, 32, 4, "bfloat16", True, None, None,
         64),
    ]


def flash_inputs(shape, seed):
    """q/k/v drawn N(0, 1) and dO 0.1 * N(0, 1) on the card, with the
    shape's key mask as a float tensor: each wrapper compares it with 0
    inside the timed call (the training path does that once per layer,
    in ``flash_attention_with_lse``, and hands the kernels a bool
    mask)."""
    import torch

    _, b, length, h, kvh, dtype, _, _, lengths, d = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)   # as kernel_case

    def t(heads, s=1.0):
        return (s * torch.randn(b, length, heads, d, generator=g,
                                device="cuda")).to(dt)

    mask = torch.ones(b, length)
    if lengths is not None:
        mask = (torch.arange(length)[None]
                < torch.as_tensor(lengths)[:, None]).float()
    return t(h), t(kvh), t(kvh), mask.to("cuda"), t(h, 0.1)


def flash_bytes_flops(which, q, k, mask, causal, window):
    """The least each kernel must move and compute on THESE inputs: q,
    dO, the K/V rows of keys some query attends, the mask, lse/delta and
    the outputs, each once; 2*D FLOPs per (query head, attended key)
    pair and matrix product (B5 two products, B6 three, B7 four). Also
    the dense byte count (every K/V row)."""
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    es = q.element_size()
    keep = _keep(mask, causal, window, lq, lk)[:, 0].expand(b, lq, lk)
    pairs = int(keep.sum()) * h
    live_keys = int(keep.any(dim=1).sum())
    q_bytes = q.numel() * es
    kv_all = 2 * b * lk * kvh * d * es
    rows = b * h * lq * 4                      # one f32 per row and head
    kv_live = 2 * live_keys * kvh * d * es
    if which == "flash_forward":               # q, k, v, mask -> out, lse
        fixed, n_products = 2 * q_bytes + rows + mask.numel(), 2
    elif which == "flash_backward_dq":         # + dO, lse, delta -> dq
        fixed, n_products = 3 * q_bytes + 2 * rows + mask.numel(), 3
    else:                                      # + dO, lse, delta -> dk, dv
        fixed = 2 * q_bytes + 2 * rows + mask.numel() + kv_all
        n_products = 4
    return fixed + kv_live, 2 * d * n_products * pairs, fixed + kv_all


def sdpa_flash_fns(q, k, v, mask, causal, window, dout):
    """One ``scaled_dot_product_attention`` call on the same inputs
    (forward) and its forward + backward: yardsticks the port never
    calls."""
    import torch
    import torch.nn.functional as F

    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    b, lq, h, _ = q.shape
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = dout.transpose(1, 2).contiguous()
    kw = {"enable_gqa": h != k.shape[2]}
    if causal and window is None and bool(mask.all()):
        kw["is_causal"] = True
    elif not bool(mask.all()) or causal:
        kw["attn_mask"] = _keep(mask, causal, window, lq, k.shape[1]) > 0

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    return fwd, fwd_bwd


def check_flash_kernels(power, sst2_x):
    """B5, B6 and B7 against their plain versions at every shape of
    :func:`flash_shapes`, each row naming the body that ran, timed beside
    the plain versions, SDPA and the card's bound. B6/B7 take the plain
    forward's lse and delta = rowsum(dO * out)."""
    import importlib

    import torch

    from mlapi_tpu_torch.ops import cuda as kern
    from mlapi_tpu_torch.ops.cuda.flash_attention import _keep

    wrappers = importlib.import_module(
        "mlapi_tpu_torch.ops.cuda.flash_attention")
    rows = []
    for i, shape in enumerate(flash_shapes(sst2_x)):
        name, b, length, h, kvh, dtype, causal, window, _, d = shape
        cfg = dict(causal=causal, scale=d ** -0.5, window=window)
        q, k, v, mask, dout = flash_inputs(shape, seed=100 + i)
        out_p, lse_p = kern.flash_forward_plain(q, k, v, mask, **cfg)
        delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        before = {w: dict(getattr(kern, w).bodies) for w in FLASH}
        out, lse = kern.flash_forward(q, k, v, mask, **cfg)
        dq = kern.flash_backward_dq(q, k, v, mask, dout, lse_p, delta, **cfg)
        dk, dv = kern.flash_backward_dkv(q, k, v, mask, dout, lse_p, delta,
                                         **cfg)
        torch.cuda.synchronize()
        # The body each kernel ran, as the C entry point reported it to
        # the counters, and the one the wrapper's mirror names.
        ran = {w: [x for x, n in getattr(kern, w).bodies.items()
                   if n != before[w][x]] for w in FLASH}
        dc = wrappers._compiled_d(name, d)
        want_body = {w: wrappers._body(q.dtype, dc) for w in FLASH}
        dq_p, dk_p, dv_p = kern.flash_backward_plain(
            q, k, v, mask, dout, lse_p, delta, **cfg)
        keep = _keep(mask, causal, window, length, length)[:, 0]
        keep = keep.expand(b, length, length)
        live_q, live_k = keep.any(-1), keep.any(-2)
        checks = {
            "flash_forward": [("out", out, out_p, live_q)],
            "flash_backward_dq": [("dq", dq, dq_p, live_q)],
            "flash_backward_dkv": [("dk", dk, dk_p, live_k),
                                   ("dv", dv, dv_p, live_k)],
        }
        lse_err = float((lse - lse_p).abs()[
            live_q[:, None, :].expand_as(lse)].max())
        # Copies of the inputs, rotated so that a launch does not find the
        # previous one's operands in the 50 MB L2; each with its own lse
        # and delta (from the kernel's forward).
        nbytes0 = 4 * q.numel() * q.element_size()
        sets = []
        for s_i in range(min(8, max(2, math.ceil(160e6 / nbytes0)))):
            qs, ks, vs, ms, ds = flash_inputs(shape, seed=200 + 10 * i + s_i)
            o_s, l_s = kern.flash_forward(qs, ks, vs, ms, **cfg)
            d_s = (ds.float() * o_s.float()).sum(-1).transpose(1, 2)
            sets.append((qs, ks, vs, ms, ds, l_s, d_s.contiguous()))
        calls = {
            "flash_forward": lambda a: kern.flash_forward(*a[:4], **cfg),
            "flash_backward_dq":
                lambda a: kern.flash_backward_dq(*a, **cfg),
            "flash_backward_dkv":
                lambda a: kern.flash_backward_dkv(*a, **cfg),
        }
        plains = {
            "flash_forward": lambda a: kern.flash_forward_plain(*a[:4], **cfg),
            "flash_backward_dq":
                lambda a: kern.flash_backward_plain(*a, **cfg)[0],
            "flash_backward_dkv":
                lambda a: kern.flash_backward_plain(*a, **cfg)[1:],
        }
        sdpa = [sdpa_flash_fns(*a[:4], causal, window, a[4]) for a in sets]
        lib_fwd = graph_ms([f for f, _ in sdpa])
        lib_bwd = (cuda_ms([fb for _, fb in sdpa], iters=20)
                   - cuda_ms([f for f, _ in sdpa], iters=20))
        # The same difference with forward and forward + backward each
        # captured in a CUDA graph: host launch costs drop out.
        lib_bwd_graph = (graph_ms([fb for _, fb in sdpa], iters=20)
                         - graph_ms([f for f, _ in sdpa], iters=20))
        del sdpa
        peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        for which in FLASH:
            errs, refs, dead_zero, finite = {}, {}, True, True
            for label, got, want, live in checks[which]:
                errs[label] = float(
                    (got.float() - want.float()).abs()[live].max())
                refs[label] = float(want.float().abs()[live].max())
                dead_zero &= not bool(got[~live].any())
                finite &= bool(torch.isfinite(got).all())
            err = max(errs.values())
            rel = max(errs[k] / refs[k] if refs[k] else math.inf
                      for k in errs)
            nbytes, flops, dense = flash_bytes_flops(which, q, k, mask,
                                                     causal, window)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            fn, pf = calls[which], plains[which]
            kernel_ms = graph_ms([(lambda a=a: fn(a)) for a in sets])
            body = ran[which][0] if len(ran[which]) == 1 else ran[which]
            row = {
                "case": "flash_kernel", "kernel": which, "shape": name,
                "B": b, "L": length, "H": h, "KVH": kvh, "D": d,
                "dtype": dtype, "causal": causal, "window": window,
                "body": body,
                "live_key_rows": int(live_k.sum()),
                "max_abs_err": err, "errors": errs,
                "ref_max_abs": refs, "max_rel_err": rel,
                "lse_max_abs_err": lse_err if which == "flash_forward"
                else None,
                "dead_rows_exact_zero": dead_zero, "finite": finite,
                "ms": kernel_ms,
                "device_ms": profiled_ms(
                    [(lambda a=a: fn(a)) for a in sets], only="flash_"),
                "eager_ms": cuda_ms([(lambda a=a: fn(a)) for a in sets]),
                "plain_ms": graph_ms([(lambda a=a: pf(a)) for a in sets[:2]],
                                     iters=6),
                "library_ms": lib_fwd if which == "flash_forward"
                else lib_bwd,
                "library_graph_ms": lib_fwd if which == "flash_forward"
                else lib_bwd_graph,
                "library": "sdpa forward" if which == "flash_forward"
                else "sdpa forward+backward minus forward (dq, dk, dv "
                     "together), eager; library_graph_ms the same from "
                     "CUDA-graph replays",
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / kernel_ms,
                "bytes": nbytes, "dense_bytes": dense, "flops": flops,
                "card": power,
            }
            emit(row)
            if ran[which] != [want_body[which]]:
                raise SystemExit(
                    f"{which} at {name}: ran the bodies {ran[which]}, the "
                    f"wrapper's mirror says {want_body[which]}"
                )
            if (not finite or not dead_zero
                    or err > FLASH_TOLERANCE[dtype]
                    or rel > FLASH_TOLERANCE[dtype]):
                raise SystemExit(
                    f"{which} at {name}: kernel disagrees with its plain "
                    f"version (errors {errs} of largest values {refs}, "
                    f"finite {finite}, exact zeros where dead {dead_zero}, "
                    f"tolerance {FLASH_TOLERANCE[dtype]}, absolute and "
                    "relative)"
                )
            rows.append(row)
        if lse_err > 1e-4:
            raise SystemExit(f"B5 lse at {name}: max abs err {lse_err}")
        del sets
        torch.cuda.empty_cache()
    # What the training path pays for its float key mask: the one
    # comparison with 0 that flash_attention_with_lse makes per layer (the
    # rows above pay it once in each call).
    shape = flash_shapes(sst2_x)[0]
    masks = [flash_inputs(shape, seed=300 + s)[3] for s in range(8)]
    calls = [(lambda m=m: m != 0) for m in masks]
    emit({"case": "flash_mask_compare", "shape": shape[0], "B": shape[1],
          "L": shape[2], "ms": graph_ms(calls),
          "device_ms": profiled_ms(calls), "card": power})
    return rows


# -- phase 7: training --------------------------------------------------

def batch_tensors(x, y):
    import torch

    return (torch.as_tensor(x).long().to("cuda"),
            torch.as_tensor(y).long().to("cuda"))


def train_run(cfg, splits, out: Path):
    """The sst2-bert preset through the train CLI's ``run`` at full width
    for SST2_STEPS steps, then its test-set evaluation; the launch
    counters zeroed just before and read just after. The checkpoint it
    writes at ``out`` is read back (and served in phase 10)."""
    import dataclasses
    import statistics

    from mlapi_tpu_torch.checkpoint import load_checkpoint, tree_signature
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.__main__ import run

    cfg = dataclasses.replace(cfg, steps=SST2_STEPS)
    zero_counters()
    t0 = time.perf_counter()
    summary = run(cfg, str(out))
    run_s = time.perf_counter() - t0
    launches, bodies = read_counters()
    model = get_model(cfg.model, **cfg.model_kwargs, seed=None,
                      device="cpu")
    state, meta = load_checkpoint(out, model)   # checks the signature
    model.load_state_dict(state)
    ckpt_ok = (meta.vocab is not None
               and meta.vocab.labels == splits.vocab.labels
               and meta.tree_signature == tree_signature(model)
               and meta.step == SST2_STEPS)
    layers = model.num_layers
    eval_batches = math.ceil(len(splits.x_test) / 4096)
    want = {name: 0 for name in SERVING}
    want.update(flash_forward=layers * (SST2_STEPS + eval_batches),
                flash_backward_dq=layers * SST2_STEPS,
                flash_backward_dkv=layers * SST2_STEPS)
    last = summary["step_ms"][-20:]
    median = statistics.median(last)
    row = {
        "case": "train", "preset": cfg.name, "steps": SST2_STEPS,
        "batch": cfg.batch_size, "max_len": splits.x_train.shape[1],
        "model": cfg.model_kwargs, "device": summary["device"],
        "dataset_source": summary["dataset_source"],
        "first_loss": summary["first_loss"],
        "final_loss": summary["final_loss"],
        "test_accuracy": summary["test_accuracy"],
        "wall_ms_per_step": {"median_last_20": median, "min": min(last),
                             "max": max(last)},
        "first_step_ms": summary["step_ms"][0],
        "tokens_per_s": cfg.batch_size * splits.x_train.shape[1]
        / (median / 1e3),
        "run_seconds": run_s, "launches": launches,
        "launches_expected": want, "bodies": bodies,
        "checkpoint_round_trip": ckpt_ok,
        "step_losses": summary["step_losses"],
    }
    emit(row)
    if not (math.isfinite(row["first_loss"])
            and math.isfinite(row["final_loss"])):
        raise SystemExit(f"sst2-bert: non-finite loss: {row}")
    if launches != want:
        raise SystemExit(f"sst2-bert: launches {launches}, want {want}")
    # bf16 at head dim 64: B5, B6 and B7 on the tensor cores, every
    # launch.
    want_bodies = {name: {"mma": want[name], "fma": 0} for name in FLASH}
    if bodies != want_bodies:
        raise SystemExit(f"sst2-bert: bodies {bodies}, want {want_bodies}")
    if not ckpt_ok:
        raise SystemExit("sst2-bert: the checkpoint did not round-trip")
    return row


def flash_vs_full(cfg, x, y):
    """One step's loss and gradients from the same weights on the same
    batch, flash attention against full attention, at full width."""
    import torch
    import torch.nn.functional as F

    from mlapi_tpu_torch.models import get_model

    xt, yt = batch_tensors(x, y)
    losses, grads = {}, {}
    for impl in ("flash", "full"):
        model = get_model(cfg.model, **{**cfg.model_kwargs,
                                        "attention_impl": impl},
                          seed=cfg.seed, device="cuda")
        loss = F.cross_entropy(model.apply(xt).float(), yt)
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = {k: p.grad.float() for k, p in model.named_parameters()}
        del model
    rel = {
        k: float((grads["flash"][k] - g).norm() / g.norm().clamp_min(1e-30))
        for k, g in grads["full"].items()
    }
    # Softmax is invariant to a shift of all of a query's scores, so the
    # key projection's bias gets no gradient: both sides compute rounding
    # noise there. Its norms are reported; the bound holds on the rest.
    no_grad = [k for k in rel if k.endswith(".k.bias")]
    worst = max((k for k in rel if k not in no_grad), key=rel.get)
    row = {"case": "flash_vs_full", "loss_flash": losses["flash"],
           "loss_full": losses["full"],
           "loss_abs_diff": abs(losses["flash"] - losses["full"]),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2": rel,
           "key_bias_grad_norm": {
               k: {impl: float(grads[impl][k].norm())
                   for impl in ("flash", "full")} for k in no_grad},
           "grad_norm_median_leaf": float(torch.stack(
               [g.norm() for g in grads["full"].values()]).median())}
    emit(row)
    del grads
    torch.cuda.empty_cache()
    if row["loss_abs_diff"] > 1e-2 or rel[worst] > 5e-2:
        raise SystemExit(f"flash and full attention disagree: {row}")


def profile_train_step(cfg, splits, runs: int = 5):
    """Where one sst2-bert training step's time goes: ``runs`` steps
    timed without the profiler (host clock around each step, ending in
    the loss read, which waits for the device), then one step under
    ``torch.profiler``: device time, kernels per step, B5+B6+B7's share
    of device time and the top kernels. Busy share = profiled device time
    / unprofiled wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.loop import _make_optimizer, make_train_step

    model = get_model(cfg.model, **cfg.model_kwargs, seed=cfg.seed,
                      device="cuda")
    params = dict(model.named_parameters())
    opt = _make_optimizer(cfg.optimizer, cfg.learning_rate, params.values())
    step = make_train_step(model.apply, params, opt,
                           weight_decay=cfg.weight_decay)
    n = len(splits.x_train)

    def batch(i):
        idx = np.random.default_rng((cfg.seed, i)).choice(
            n, size=cfg.batch_size, replace=False)
        return splits.x_train[idx], splits.y_train[idx]

    for i in range(3):                                  # warm
        float(step(*batch_tensors(*batch(i))))
    walls = []
    for i in range(runs):
        t0 = time.perf_counter()
        float(step(*batch_tensors(*batch(3 + i))))
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(*batch_tensors(*batch(3 + runs))))
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    dev_us = sum(e.device_time_total for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    flash_us = {k: sum(v for n_, v in by_name.items() if k in n_)
                for k in ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    walls.sort()
    dev_ms = dev_us / 1e3
    row = {
        "case": "train_profile", "preset": cfg.name, "batch": cfg.batch_size,
        "wall_ms_per_step": {"min": walls[0], "median": walls[runs // 2],
                             "max": walls[-1], "runs": runs},
        "profiled_wall_ms": prof_wall,
        "device_ms_per_step": dev_ms if dev_us else "not measured",
        "device_busy_share": {
            "median": dev_ms / walls[runs // 2],
            "min": dev_ms / walls[-1], "max": dev_ms / walls[0],
        } if dev_us else "not measured",
        "kernels_per_step": len(kernels),
        "flash_share_of_device": {k: v / dev_us for k, v in flash_us.items()}
        if dev_us else "not measured",
        "flash_ms_per_step": {k: v / 1e3 for k, v in flash_us.items()},
        "top_kernels_ms": [{"kernel": k[:90], "ms": v / 1e3} for k, v in top],
    }
    emit(row)
    del model, opt
    torch.cuda.empty_cache()
    return row


# -- Llama (the docstring's item 7) ------------------------------------

def make_llama_checkpoint(path: Path) -> dict:
    """A TinyLlama-1.1B-width checkpoint with weights drawn from seed 0 on
    the host and written straight to disk; returns its row (the seconds
    of the draw and of the write)."""
    from mlapi_tpu_torch.checkpoint import save_checkpoint
    from mlapi_tpu_torch.models.llama import LlamaLM
    from mlapi_tpu_torch.text import ByteTokenizer

    t0 = time.perf_counter()
    model = LlamaLM(**TINYLLAMA, seed=0, device="cpu")
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    save_checkpoint(path, model, config={
        "model": "llama_lm", "model_kwargs": TINYLLAMA,
        "tokenizer": ByteTokenizer().fingerprint(),
    })
    row = {"case": "llama_checkpoint", "params": n_params,
           "init_s": init_s, "write_s": time.perf_counter() - t0,
           "params_npz_bytes": (path / "params.npz").stat().st_size}
    emit(row)
    return row


def llama_flash_vs_full(ckpt: Path):
    """One docs_text batch (B = 2, L = 1024) through the TinyLlama-width
    checkpoint: the LM loss and every gradient with flash against full
    attention, from the same weights on the same batch, at
    :func:`flash_vs_full`'s bounds; every B5-B7 launch of the flash pass
    on the tensor-core body, one per layer."""
    import torch
    import torch.nn.functional as F

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model

    t0 = time.perf_counter()
    model = get_model("llama_lm", **TINYLLAMA, seed=None, device="cpu")
    state, _ = load_checkpoint(ckpt, model)
    model.load_state_dict(state)
    del state
    model.to("cuda")
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.as_tensor(get_dataset("docs_text", seq_len=1024).x_train[:2])
    x = x.long().cuda()
    targets = x[:, 1:]
    keep = (targets != 0).float()
    losses, grads = {}, {}
    for impl in ("flash", "full"):
        model.attention_impl = impl
        zero_counters()
        logits = model.apply(x)
        ce = F.cross_entropy(logits[:, :-1].transpose(1, 2), targets,
                             reduction="none")
        loss = (ce * keep).sum() / keep.sum().clamp_min(1.0)
        loss.backward()
        del logits, ce
        losses[impl] = loss.item()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        if impl == "flash":
            launches, bodies = read_counters()
    rel = {
        k: float((grads["flash"][k] - g).norm() / g.norm().clamp_min(1e-30))
        for k, g in grads["full"].items()
    }
    worst = max(rel, key=rel.get)
    layers = TINYLLAMA["num_layers"]
    want = {name: layers if name in FLASH else 0 for name in KERNELS}
    row = {"case": "llama_flash_vs_full", "B": 2, "L": 1024,
           "model": "tinyllama-1.1b", "loss_flash": losses["flash"],
           "loss_full": losses["full"],
           "loss_abs_diff": abs(losses["flash"] - losses["full"]),
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "launches": launches, "bodies": bodies,
           "seconds": time.perf_counter() - t0}
    emit(row)
    del model, grads
    torch.cuda.empty_cache()
    if row["loss_abs_diff"] > 1e-2 or rel[worst] > 5e-2:
        raise SystemExit(f"TinyLlama: flash and full disagree: {row}")
    if launches != want or any(b != {"mma": layers, "fma": 0}
                               for b in bodies.values()):
        raise SystemExit(f"TinyLlama flash pass: launches {launches}, bodies "
                         f"{bodies}, want {layers} a kernel, all mma")


def llama_train_run():
    """The docs-llama preset through the train CLI's ``run`` with
    ``attention_impl="flash"`` for DOCS_LLAMA_STEPS steps and its test
    evaluation, the launch counters zeroed just before and read just
    after: B5 exactly one launch per layer per step and per eval batch,
    B6 and B7 per step, each on the body the wrapper's mirror names for
    f32 at head dim 32. The checkpoint reads back (tree signature,
    tokenizer), and served through the CLI's engine factory its greedy
    streams through flash equal einsum's."""
    import dataclasses
    import importlib
    import statistics

    import torch

    from mlapi_tpu_torch.checkpoint import load_checkpoint, tree_signature
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.text import ByteTokenizer
    from mlapi_tpu_torch.train.__main__ import run

    wrappers = importlib.import_module(
        "mlapi_tpu_torch.ops.cuda.flash_attention")
    cfg = get_preset("docs-llama")
    cfg = dataclasses.replace(
        cfg, steps=DOCS_LLAMA_STEPS,
        model_kwargs={**cfg.model_kwargs, "attention_impl": "flash"})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = Path(tmp) / "docs-llama"
        zero_counters()
        t0 = time.perf_counter()
        summary = run(cfg, str(out))
        run_s = time.perf_counter() - t0
        launches, bodies = read_counters()
        model = get_model(cfg.model, **cfg.model_kwargs, seed=None,
                          device="cpu")
        _, meta = load_checkpoint(out, model)     # checks the signature
        ckpt_ok = (meta.tree_signature == tree_signature(model)
                   and meta.step == DOCS_LLAMA_STEPS
                   and meta.config["tokenizer"]
                   == ByteTokenizer().fingerprint())
        engine = build_engine(out, decode_attn_impl="flash")
        streams = {}
        for impl in ("flash", "einsum"):
            engine.model.configure(decode_attn_impl=impl)
            streams[impl] = [
                engine.generate_text(p, max_new_tokens=32)["token_ids"]
                for p in SHORT_PROMPTS[:4]
            ]
        del engine
    layers = model.num_layers
    del model
    torch.cuda.empty_cache()
    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    eval_batches = math.ceil(len(splits.x_test) / 256)  # evaluate_lm's
    want = {name: 0 for name in SERVING}
    want.update(flash_forward=layers * (DOCS_LLAMA_STEPS + eval_batches),
                flash_backward_dq=layers * DOCS_LLAMA_STEPS,
                flash_backward_dkv=layers * DOCS_LLAMA_STEPS)
    body = wrappers._body(torch.float32, wrappers._compiled_d("flash", 32))
    want_bodies = {name: {"mma": 0, "fma": 0, body: want[name]}
                   for name in FLASH}
    row = {
        "case": "train", "preset": cfg.name, "steps": DOCS_LLAMA_STEPS,
        "batch": cfg.batch_size, "max_len": splits.x_train.shape[1],
        "model": cfg.model_kwargs, "device": summary["device"],
        "dataset_source": summary["dataset_source"],
        "first_loss": summary["first_loss"],
        "final_loss": summary["final_loss"],
        "test_next_token_accuracy": summary["test_accuracy"],
        "wall_ms_per_step_median": statistics.median(summary["step_ms"]),
        "run_seconds": run_s, "launches": launches,
        "launches_expected": want, "bodies": bodies,
        "checkpoint_round_trip": ckpt_ok,
        "served_flash_equals_einsum": streams["flash"] == streams["einsum"],
    }
    emit(row)
    if not (math.isfinite(row["first_loss"])
            and math.isfinite(row["final_loss"])
            and row["final_loss"] < row["first_loss"]):
        raise SystemExit(f"docs-llama: the loss did not fall: {row}")
    if launches != want or bodies != want_bodies:
        raise SystemExit(f"docs-llama: launches {launches}, bodies {bodies}; "
                         f"want {want}, {want_bodies}")
    if not ckpt_ok or not row["served_flash_equals_einsum"]:
        raise SystemExit(f"docs-llama: the checkpoint did not round-trip or "
                         f"serve: {row}, {streams}")
    return row


def llama_phases(scratch: Path, launches: dict, power, then=None) -> dict:
    """Item 7 of the docstring: the Llama family. A seeded TinyLlama-1.1B-width
    checkpoint served in two runs (contiguous bf16, paged 16 int8) with
    their profiles and, on the contiguous engine, flash's top-1 agreement
    with einsum; flash against full attention at its width; small f32
    Llamas' greedy streams; the docs-llama training run. Each serving
    engine then runs the prefix phase (:func:`prefix_leg`), the paged one
    the scheduler phase (:func:`sched_leg`). Adds each serving run's
    launches to ``launches``; ``then(checkpoint)`` runs last on the
    TinyLlama-width checkpoint; returns the training row."""
    import torch

    seconds = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ckpt = Path(tmp) / "tinyllama_seed0"
        made = make_llama_checkpoint(ckpt)
        seconds.update(init=made["init_s"], write=made["write_s"])
        for kv_quant, page in ((None, None), ("int8", PAGE)):
            t0 = time.perf_counter()
            row, engine = serve_run(ckpt, kv_quant, page, TINYLLAMA,
                                    "tinyllama-1.1b")
            emit(row)
            path = "llama " + row["kv_quant"] + (f", page {page}" if page
                                                 else "")
            for k in launches:
                launches[k][path] = row["launches"][k]
            profile_decode(engine)
            profile_prefill(engine)
            if page is None:
                agreement(engine, kv_quant)
            seconds[f"serve {path}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prow = prefix_leg(engine, TINYLLAMA, "tinyllama-1.1b", power)
            for k in launches:
                launches[k]["llama prefix " + path[6:]] = prow["launches"][k]
            seconds[f"prefix {path}"] = time.perf_counter() - t0
            if page:
                # 9. the unit scheduler on the paged int8 engine
                t0 = time.perf_counter()
                srow = sched_leg(engine, TINYLLAMA, "tinyllama-1.1b", power)
                for k in launches:
                    launches[k]["llama sched " + path[6:]] = (
                        srow["launches"][k])
                seconds[f"sched {path}"] = time.perf_counter() - t0
            del engine
            torch.cuda.empty_cache()
            seconds[f"read {path}"] = row["load_s"]
        t0 = time.perf_counter()
        llama_flash_vs_full(ckpt)
        seconds["flash_vs_full"] = time.perf_counter() - t0
        if then is not None:
            t0 = time.perf_counter()
            then(ckpt)
            seconds["item5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_small_f32(4, "llama_lm", kv_heads=2)            # docs-llama
    check_small_f32(8, "llama_lm", kv_heads=1, hidden=512)  # a group of 8
    check_prefix_f32("llama_lm", 4, kv_heads=2)
    seconds["f32_streams"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_row = llama_train_run()
    seconds["train docs-llama"] = time.perf_counter() - t0
    emit({"case": "llama_seconds", **seconds})
    return train_row


# -- 14. fused widths and the host KV tier ------------------------------

# Two budgets above fused_max_new's 64: the longest row's remaining 128
# tokens take two 64-wide fused chunks or sixteen plain ones, the same
# decode steps either way, and the 65-token rows end on the boundary
# both share (step 64), so both compact there and every step runs at
# the same batch shape. At 33 the short rows end at step 32, where only
# the plain chunks have a boundary: the fused run decodes steps 33-64 at
# B = 8 and the plain one at B = 4, and bf16 GEMMs round by shape.
FUSED_BUDGETS = (65, 129)
FUSED_BUDGETS_SKEWED = (33, 129)
# A non-streaming pair and a streaming joiner admitted at the first
# boundary: plain widths while it is live, then one fused chunk.
FUSED_PAIR, FUSED_JOINER = ("fused row one", "fused row two"), "join"
FUSED_PAIR_NEW, FUSED_JOINER_NEW = 64, 16
TIER_BYTES = 1 << 30             # host bytes of the KV tier


def fused_widths_of(engine, bucket, budgets, stream_at_formation=False,
                    joiner=None):
    """The decode chunk widths of one batch by the fused-width rule,
    worked out from its budgets alone: the top width is the smallest
    ladder tier (powers of two of ``chunk`` from the default budget's
    tier up to ``fused_max_new``'s) covering the longest budget, the last
    rung past it, or the plain chunk when a row streams at formation; at
    each boundary the smallest power of two of ``chunk`` covering the
    live rows' remaining tokens, capped at the top, the plain chunk while
    a streaming row is live. Every row has its first token at formation;
    ``joiner`` ``(n_new, stream)`` joins at the first boundary with its
    own. ``bucket``: the batch's prompt bucket."""
    chunk = engine.chunk
    tier = chunk
    while tier < engine.default_max_new_tokens:
        tier *= 2
    ladder = [tier]
    while ladder[-1] < engine.fused_max_new:
        ladder.append(ladder[-1] * 2)
    top = next((t for t in ladder if t >= max(budgets)), ladder[-1])
    if stream_at_formation or top <= chunk:
        top = 0
    rows = [[n, stream_at_formation and i == 0, 1]
            for i, n in enumerate(budgets)]
    pos, total = bucket, engine._cache_len(bucket, max(budgets))
    widths = []
    while True:
        if joiner is not None and not widths:
            rows.append([joiner[0], joiner[1], 1])
        live = [r for r in rows if r[2] < r[0]]
        if not live:
            return widths
        w = chunk
        if top and not any(r[1] for r in live):
            need = max(r[0] - r[2] for r in live)
            while w < need:
                w *= 2
            w = min(w, top)
        size = min(max(w, chunk), total - pos)
        if size <= 0:
            return widths
        widths.append(size)
        for r in live:
            r[2] += size
        pos += size


def fused_batch(engine, specs, fused: bool, joiner=None,
                count_syncs: bool = False) -> dict:
    """One formed batch on this thread (``_run_batch``, as
    ``generate_text`` runs one), in fused widths or (``fused`` False)
    pinned to the plain chunk: ``specs`` ``(text, n_new)`` rows, no
    stream; ``joiner`` ``(text, n_new)`` staged to stream from the first
    boundary. Its streams, wall seconds (device synchronized), the
    engine's counter deltas, launches, decode steps and, with
    ``count_syncs``, the host syncs of the run: the synchronizing CUDA
    calls (device-to-host reads, pageable uploads, stream waits) that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, one warning
    each."""
    import warnings

    import torch

    from mlapi_tpu_torch.serving.requests import _SyncSink

    steps = [0]
    step = engine.model.decode_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    sinks = [_SyncSink(engine._encode(t, n, 0.0, 0, None), [])
             for t, n in specs]
    everyone = list(sinks)
    if joiner is not None:
        j = _SyncSink(engine._encode(joiner[0], joiner[1], 0.0, 0, None,
                                     stream=True), [])
        everyone.append(j)
        engine._admit[:] = [j]
    before = {k: getattr(engine, k) for k in (
        "chunk_calls", "fused_calls", "admitted", "batch_calls")}
    engine.model.decode_step = counted
    caught: list = []
    try:
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                engine._run_batch(sinks, admit=joiner is not None,
                                  fused_ok=fused)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, _ = read_counters(SERVING)
    finally:
        del engine.model.decode_step        # the class's method again
        engine._admit[:] = []
    errors = [repr(s.error) for s in everyone if s.error is not None]
    if errors:
        raise SystemExit(f"fused batch failed: {errors}")
    out = {"streams": [s._out for s in everyone], "wall_s": wall,
           "steps": steps[0], "launches": launches,
           **{k: getattr(engine, k) - v for k, v in before.items()}}
    if count_syncs:
        out["host_syncs"] = sum("synchroniz" in str(w.message)
                                for w in caught)
    return out


def fused_leg(engine, cfg, model: str, power) -> dict:
    """Phase 14 (a) on a served engine (contiguous bf16 or paged 16
    int8): the 8 short prompts at ``FUSED_BUDGETS`` in one formed batch
    with fused widths (the default) and pinned to the plain chunk, and a
    non-streaming pair with a streaming joiner. Streams equal, one
    fused run a batch, chunk counts as the rule works them out, one
    flash-decode a layer a decode step; wall ms and host syncs per token
    fused against plain, alternated (reported, no gate)."""
    import statistics

    layers = cfg["num_layers"]
    decode = ("paged_decode_attention" if engine.kv_page_size
              else "decode_attention")
    specs = [(p, FUSED_BUDGETS[i % 2]) for i, p in enumerate(SHORT_PROMPTS)]
    tokens = sum(n for _, n in specs)
    budgets = [n for _, n in specs]
    runs = {fused: fused_batch(engine, specs, fused)
            for fused in (True, False)}
    # Budgets whose compaction steps differ: report which streams
    # diverge, and hold that none does before the short rows end.
    skewed = [(p, FUSED_BUDGETS_SKEWED[i % 2])
              for i, p in enumerate(SHORT_PROMPTS)]
    sk = {fused: fused_batch(engine, skewed, fused)["streams"]
          for fused in (True, False)}
    first_diff = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       None) for x, y in zip(sk[True], sk[False])]
    bucket = max(engine._bucket(len(p)) for p in SHORT_PROMPTS)
    want_fused = fused_widths_of(engine, bucket, budgets)
    want_plain = [engine.chunk] * -(-(max(budgets) - 1) // engine.chunk)
    pair = [(t, FUSED_PAIR_NEW) for t in FUSED_PAIR]
    joined = {fused: fused_batch(engine, pair, fused,
                                 (FUSED_JOINER, FUSED_JOINER_NEW))
              for fused in (True, False)}
    want_join = fused_widths_of(
        engine, max(engine._bucket(len(t)) for t in FUSED_PAIR),
        [FUSED_PAIR_NEW] * 2, joiner=(FUSED_JOINER_NEW, True))
    # Timing: plain, fused, fused, plain, then one profiled run each.
    walls = {True: [], False: []}
    for fused in (False, True, True, False):
        walls[fused].append(fused_batch(engine, specs, fused)["wall_s"])
    syncs = {fused: fused_batch(engine, specs, fused,
                                count_syncs=True)["host_syncs"]
             for fused in (True, False)}
    f, p = runs[True], runs[False]
    row = {
        "case": "fused_widths", "model": model,
        "kv_quant": engine.kv_quant, "kv_page_size": engine.kv_page_size,
        "budgets": list(FUSED_BUDGETS), "fused_max_new": engine.fused_max_new,
        "chunk_calls": {"fused": f["chunk_calls"], "plain": p["chunk_calls"]},
        "want_chunks": {"fused": len(want_fused), "plain": len(want_plain)},
        "widths": want_fused, "fused_calls": f["fused_calls"],
        "decode_steps": {"fused": f["steps"], "plain": p["steps"]},
        "decode_launches": {"fused": f["launches"][decode],
                            "plain": p["launches"][decode]},
        "joiner": {"chunk_calls": joined[True]["chunk_calls"],
                   "want_chunks": len(want_join), "widths": want_join,
                   "admitted": joined[True]["admitted"],
                   "plain_chunk_calls": joined[False]["chunk_calls"]},
        "wall_ms_per_token": {
            k: statistics.median(v) * 1e3 / tokens
            for k, v in (("fused", walls[True]), ("plain", walls[False]))},
        "wall_ms_per_token_runs": {
            "fused": [w * 1e3 / tokens for w in walls[True]],
            "plain": [w * 1e3 / tokens for w in walls[False]]},
        "host_syncs_per_token": {"fused": syncs[True] / tokens,
                                 "plain": syncs[False] / tokens},
        "tokens": tokens, "card": power,
        "skewed_budgets": {
            "budgets": list(FUSED_BUDGETS_SKEWED),
            "streams_differing": sum(d is not None for d in first_diff),
            "first_divergence": first_diff},
    }
    row["checks"] = checks = {
        "streams_equal_plain": f["streams"] == p["streams"]
        and [len(s) for s in f["streams"]] == budgets,
        "one_fused_run": f["fused_calls"] == 1 and p["fused_calls"] == 0,
        "chunks_as_worked_out": f["chunk_calls"] == len(want_fused)
        and p["chunk_calls"] == len(want_plain),
        "decode_one_per_layer_per_step":
            f["launches"][decode] == layers * f["steps"]
            and p["launches"][decode] == layers * p["steps"],
        "same_decode_total": f["launches"][decode] == p["launches"][decode],
        "joiner_streams_equal_plain":
            joined[True]["streams"] == joined[False]["streams"]
            and joined[True]["admitted"] == 1,
        "joiner_drops_the_width":
            joined[True]["chunk_calls"] == len(want_join)
            and want_join[0] == engine.chunk
            and joined[True]["fused_calls"] == 1,
        "joiner_decode_one_per_layer_per_step":
            joined[True]["launches"][decode] == layers * joined[True]["steps"],
        "skewed_same_until_the_short_rows_end": all(
            d is None or d >= min(FUSED_BUDGETS_SKEWED) for d in first_diff),
    }
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{model} fused widths failed: {checks}")
    return f["launches"]


def tier_leg(engine, cfg, model: str, power, scratch: Path | None = None,
             ckpt: Path | None = None) -> dict:
    """Phase 14 (b) on a served engine, with a host tier of
    ``TIER_BYTES`` attached as the engine's constructor attaches one
    (``kv_tier_bytes``), after a restart's state (no prefix entry, no
    resident page set). Over HTTP, one request naming ``PREFIX_A``: cold
    (a build), warm (a hit); on a paged engine ``evict_idle(1)`` spills
    the entry's pages and the next request restores them; the prefix
    dict's LRU (one entry) drops the entry when ``PREFIX_B`` arrives and
    the next ``PREFIX_A`` request rebuilds it from the blob. Every
    restored stream equals the cold one, ``prefix_builds`` stays flat,
    spill and restore bytes are ``n_pages x kv_page_bytes`` (one
    bucket-wide page on a contiguous engine), and each restored request
    launches one flash-extend a layer (its suffix) and one flash-decode a
    layer a step, nothing else. Then the fault points (``tier_spill``,
    ``tier_restore``: counted, cold fallback, pages conserved), one
    restore timed beside plain host-to-device copies of its bytes, and,
    with ``ckpt``, a disk round trip through the CLI's factory with
    ``--kv-tier-disk-dir`` under ``scratch``."""
    import numpy as np
    import torch

    from mlapi_tpu_torch.ops.quant import kv_tree_bytes
    from mlapi_tpu_torch.serving import faults
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.kv_tier import KVTier
    from mlapi_tpu_torch.serving.prefix import PrefixCache
    from mlapi_tpu_torch.serving.server import BackgroundServer

    layers = cfg["num_layers"]
    pool = engine.pool
    page = engine.kv_page_size or None
    mine = (("paged_decode_attention", "paged_extend_attention") if page
            else ("decode_attention", "extend_attention"))
    if page:
        pool.evict_idle(pool.pages_total)   # no tier yet: discarded
    engine.prefix = PrefixCache(engine)
    engine.kv_tier = tier = KVTier(TIER_BYTES)
    if page:
        pool.tier = tier
    suffix = prefix_suffixes()[0]
    body = {"text": suffix, "prefix": PREFIX_A, "max_new_tokens": PREFIX_NEW}
    body_b = {**body, "prefix": PREFIX_B}
    steps = [0]
    step = engine.model.decode_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    def restored_request(srv, what):
        zero_counters()
        steps[0] = 0
        ttft, (done,) = concurrent_streams(srv.port, [body], what)
        launches, _ = read_counters(SERVING)
        return ttft[0], done["token_ids"], launches, steps[0]

    def exact(launches, n_steps):
        return (launches[mine[1]] == layers
                and launches[mine[0]] == layers * n_steps
                and not any(launches[k] for k in KERNELS if k not in mine))

    def settled():
        deadline = time.monotonic() + 60.0
        want = lambda: sum(len(p) for p in pool._entries.values())  # noqa
        while pool.pages_in_use != want() and time.monotonic() < deadline:
            time.sleep(0.01)
        return pool.pages_in_use == want()

    engine.model.decode_step = counted
    row = {"case": "kv_tier", "model": model, "kv_quant": engine.kv_quant,
           "kv_page_size": page, "prefix_bytes": len(PREFIX_A),
           "card": power}
    checks = row["checks"] = {}
    launch_paths = {}
    t_leg = time.perf_counter()
    try:
        with BackgroundServer(build_app(engine)) as srv:
            ttft_cold, (cold,) = concurrent_streams(srv.port, [body],
                                                    "tier cold")
            ref = cold["token_ids"]
            ttft_warm, (warm,) = concurrent_streams(srv.port, [body],
                                                    "tier warm")
            entry = engine.prefix.entry(PREFIX_A)
            if page:
                settled()
                n_pages = len(pool.entry_pages(PREFIX_A))
                blob_bytes = n_pages * pool.page_bytes
                # Seam 1: pool pressure (the brownout lever).
                checks["evict_one"] = pool.evict_idle(1) == 1
                checks["spill_bytes_closed_form"] = (
                    tier.spill_count == 1 and tier.spill_bytes == blob_bytes)
                ttft_pool, got, launches, n = restored_request(
                    srv, "tier pool restore")
                launch_paths["tier pool restore"] = launches
                checks["pool_restore_stream"] = got == ref
                checks["pool_restore_builds_flat"] = (
                    engine.prefix_builds == 1)
                checks["pool_restore_bytes"] = (
                    tier.restore_hits == 1
                    and tier.restore_bytes == blob_bytes)
                checks["pool_restore_launches"] = exact(launches, n)
                row["pool_restore"] = {"ttft_ms": ttft_pool,
                                       "n_pages": n_pages,
                                       "bytes": blob_bytes,
                                       "launches": launches, "steps": n}
            else:
                blob_bytes = kv_tree_bytes(entry.kv)
            # Seam 2: the prefix dict's own LRU.
            engine.prefix.max_entries = 1
            concurrent_streams(srv.port, [body_b], "tier other prefix")
            hits0, builds0 = tier.restore_hits, engine.prefix_builds
            checks["entry_spilled"] = tier.entries >= 1
            ttft_entry, got, launches, n = restored_request(
                srv, "tier entry restore")
            launch_paths["tier entry restore"] = launches
            checks["entry_restore_stream"] = got == ref
            checks["entry_restore_builds_flat"] = (
                engine.prefix_builds == builds0 == 2)
            checks["entry_restore_hits"] = (
                tier.restore_hits == hits0 + (2 if page else 1))
            checks["restore_bytes_closed_form"] = (
                tier.restore_bytes == tier.restore_hits * blob_bytes)
            checks["entry_restore_launches"] = exact(launches, n)
            row["entry_restore"] = {"ttft_ms": ttft_entry,
                                    "launches": launches, "steps": n}
            # The fault points: counted, cold fallback, pages conserved.
            if page:
                settled()
                with faults.active("tier_spill:raise"):
                    pool.evict_idle(1)
                checks["spill_fault_counted"] = tier.spill_failures == 1
                checks["spill_fault_pages_conserved"] = settled()
                fails = tier.restore_failures
                with faults.active("tier_restore:raise"):
                    _, (done,) = concurrent_streams(
                        srv.port, [body], "tier restore fault")
                checks["restore_fault_stream"] = done["token_ids"] == ref
                checks["restore_fault_counted"] = (
                    tier.restore_failures == fails + 1)
                checks["restore_fault_pages_conserved"] = settled()
            else:
                concurrent_streams(srv.port, [body_b], "tier other prefix")
                fails, builds = tier.restore_failures, engine.prefix_builds
                with faults.active("tier_restore:raise"):
                    _, (done,) = concurrent_streams(
                        srv.port, [body], "tier restore fault")
                checks["restore_fault_stream"] = done["token_ids"] == ref
                checks["restore_fault_counted"] = (
                    tier.restore_failures == fails + 1
                    and engine.prefix_builds == builds + 1)
                spills = tier.spill_failures
                with faults.active("tier_spill:raise"):
                    concurrent_streams(srv.port, [body_b], "tier spill fault")
                checks["spill_fault_counted"] = (
                    tier.spill_failures == spills + 1)
            metrics = get(srv.port, "/metrics")
    finally:
        del engine.model.decode_step
    c, g = metrics["counters"], metrics["gauges"]
    checks["metrics"] = all(
        c[f"generate.{k}"] == getattr(engine, k) for k in (
            "kv_prefix_restore_hits", "kv_prefix_restore_misses",
            "kv_prefix_restore_bytes", "kv_prefix_restore_failures",
            "kv_prefix_spill_count", "kv_prefix_spill_bytes",
            "kv_prefix_spill_failures", "kv_tier_evictions")) and all(
        g[f"generate.{k}"] == getattr(engine, k)
        for k in ("kv_tier_bytes_in_use", "kv_tier_entries"))
    row.update({
        "ttft_ms": {"cold_build": ttft_cold, "warm_hit": ttft_warm,
                    "pool_restore": row.get("pool_restore", {}).get(
                        "ttft_ms"),
                    "entry_restore": ttft_entry},
        "blob_bytes": blob_bytes,
        "counters": {k: getattr(engine, k) for k in (
            "prefix_builds", "kv_prefix_restore_hits",
            "kv_prefix_restore_bytes", "kv_prefix_restore_failures",
            "kv_prefix_spill_count", "kv_prefix_spill_bytes",
            "kv_prefix_spill_failures")},
    })
    if page:
        # One restore timed: the blob into fresh pool pages (lookup
        # outside the window), beside plain host-to-device copies of the
        # same bytes from pageable and from pinned host memory.
        settled()
        pool.evict_idle(1)
        blob = tier.lookup(PREFIX_A)
        pool_fp = "timed restore"
        restore_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pages = pool.restore_entry(pool_fp, blob)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            pool.drop_entry(pool_fp)
        host = np.ones(blob.nbytes, np.uint8)
        pinned = torch.from_numpy(host).pin_memory()
        copies = {}
        for name, src in (("pageable", torch.from_numpy(host)),
                          ("pinned", pinned)):
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                src.to("cuda", non_blocking=name == "pinned")
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            copies[name] = min(ts)
        best = min(restore_s)
        row["restore_timing"] = {
            "bytes": blob.nbytes, "pages": len(pages),
            "restore_ms": [t * 1e3 for t in restore_s],
            "restore_gb_s": blob.nbytes / best / 1e9,
            "h2d_copy_ms": {k: v * 1e3 for k, v in copies.items()},
            "h2d_copy_gb_s": {k: blob.nbytes / v / 1e9
                              for k, v in copies.items()},
        }
        checks["pages_conserved_at_end"] = settled()
    if ckpt is not None and scratch is not None:
        row["disk"] = tier_disk_round_trip(ckpt, engine, scratch)
        checks["disk_round_trip"] = all(row["disk"]["checks"].values())
    row["seconds"] = time.perf_counter() - t_leg
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{model} kv tier failed: {checks}")
    return launch_paths


def tier_disk_round_trip(ckpt: Path, like, scratch: Path) -> dict:
    """``--kv-tier-disk-dir``: an engine from the CLI's factory at
    ``like``'s cache format and page size with a disk-backed tier under
    ``scratch``; a prefix's pages evicted to a ``.npz`` file and restored
    from it, the stream equal to the cold one."""
    from mlapi_tpu_torch.serving.__main__ import build_engine

    disk = scratch / "kv_tier"
    engine = build_engine(
        ckpt, kv_quant=None if like.kv_quant == "none" else like.kv_quant,
        decode_attn_impl="flash", kv_page_size=like.kv_page_size,
        kv_tier_bytes=TIER_BYTES, kv_tier_disk_dir=str(disk))
    suffix = prefix_suffixes()[0]
    ref = engine.generate_text(suffix, prefix=PREFIX_A,
                               max_new_tokens=PREFIX_NEW)["token_ids"]
    engine.pool.evict_idle(1)
    files = sorted(os.listdir(disk))
    got = engine.generate_text(suffix, prefix=PREFIX_A,
                               max_new_tokens=PREFIX_NEW)["token_ids"]
    out = {"files": len(files), "checks": {
        "one_file": len(files) == 1 and files[0].endswith(".npz"),
        "stream": got == ref,
        "restored": engine.kv_prefix_restore_hits == 1
        and engine.prefix_builds == 1,
    }}
    del engine
    shutil.rmtree(disk, ignore_errors=True)
    return out


def tier_llama_leg(ckpt: Path, power) -> None:
    """Phase 14 (b) at TinyLlama-1.1B's width (paged 16 int8, from the
    CLI's factory with ``--kv-tier-bytes``): one prefix evicted and
    restored, its stream equal to the cold one, spill and restore bytes
    ``n_pages x`` 191,488 B (a 16-token int8 page over 4 KV heads)."""
    import torch

    from mlapi_tpu_torch.ops.quant import kv_page_bytes
    from mlapi_tpu_torch.serving.__main__ import build_engine

    t0 = time.perf_counter()
    engine = build_engine(ckpt, kv_quant="int8", decode_attn_impl="flash",
                          kv_page_size=PAGE, kv_tier_bytes=TIER_BYTES)
    load_s = time.perf_counter() - t0
    suffix = prefix_suffixes()[0]
    ref = engine.generate_text(suffix, prefix=PREFIX_A,
                               max_new_tokens=PREFIX_NEW)["token_ids"]
    n_pages = len(engine.pool.entry_pages(PREFIX_A))
    page_bytes = kv_page_bytes(engine.model, PAGE)
    engine.pool.evict_idle(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = engine.generate_text(suffix, prefix=PREFIX_A,
                               max_new_tokens=PREFIX_NEW)["token_ids"]
    tier = engine.kv_tier
    row = {"case": "kv_tier", "model": "tinyllama-1.1b", "kv_quant": "int8",
           "kv_page_size": PAGE, "n_pages": n_pages, "page_bytes": page_bytes,
           "restored_request_s": time.perf_counter() - t1, "load_s": load_s,
           "spill_bytes": tier.spill_bytes,
           "restore_bytes": tier.restore_bytes, "card": power}
    row["checks"] = checks = {
        "page_bytes": page_bytes == 191_488,
        "spill_bytes": tier.spill_count == 1
        and tier.spill_bytes == n_pages * page_bytes,
        "restore_bytes": tier.restore_hits == 1
        and tier.restore_bytes == n_pages * page_bytes,
        "stream": got == ref, "builds_flat": engine.prefix_builds == 1,
    }
    emit(row)
    del engine
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"tinyllama kv tier failed: {checks}")


# -- 10. the scoring path --------------------------------------------------

# The reference's held-out Iris accuracy (tests/test_linear_iris.py:4).
IRIS_MIN_ACCURACY = 0.9666666666666667
CLOSED_LOOP_CLIENTS, CLOSED_LOOP_REQUESTS = 16, 2000
# The criteo-widedeep preset's widths (mlapi_tpu_torch/config.py).
CRITEO_WIDE_DEEP = dict(num_dense=13, vocab_sizes=[100_000] * 26,
                        embed_dim=16, hidden_dims=[256, 128], num_classes=2)
SCORE_TEXTS = 64                 # concurrent sst2-bert /predict texts
B5_SERVING_BATCHES = (1, 64, 512)
B5_PROFILED_CALLS = 12


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_server(args: list, log: Path):
    """``python -m mlapi_tpu_torch.serving ARGS`` on a free port, its
    output in ``log``; returns (process, port) once ``/healthz`` answers
    ok. The caller stops it with :func:`stop_server`."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = open(log, "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlapi_tpu_torch.serving", *args,
         "--port", str(port)], cwd=ROOT, env=env, stdout=out,
        stderr=subprocess.STDOUT,
    )
    out.close()
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise SystemExit(f"server {args} exited {proc.returncode}: "
                             f"{log.read_text()[-3000:]}")
        try:
            if get(port, "/healthz")["status"] == "ok":
                return proc, port
        except OSError:
            pass
        time.sleep(0.2)
    stop_server(proc)
    raise SystemExit(f"server {args} did not come up: "
                     f"{log.read_text()[-3000:]}")


def stop_server(proc) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def predict(port: int, body: dict, path: str = "/predict") -> dict:
    status, out = http(port, "POST", path, json.dumps(body).encode())
    if status != 200:
        raise SystemExit(f"{path} answered {status}: {out[:300]!r}")
    return json.loads(out)


def closed_loop(port: int, bodies: list, clients: int, total: int) -> dict:
    """A closed-loop load: ``clients`` threads, each on its own
    keep-alive connection, sending ``/predict`` bodies in turn until
    ``total`` requests have answered; each request's latency from its
    send to its answer."""
    import http.client

    lock = threading.Lock()
    sent = [0]
    lat: list = []
    errors: list = []
    barrier = threading.Barrier(clients + 1)

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        barrier.wait()
        while True:
            with lock:
                i = sent[0]
                sent[0] += 1
            if i >= total:
                break
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=bodies[i % len(bodies)],
                         headers={"content-type": "application/json"})
            r = conn.getresponse()
            r.read()
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(ms)
                if r.status != 200:
                    errors.append(r.status)
        conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or len(lat) != total:
        raise SystemExit(f"closed loop: {len(lat)} answers, errors "
                         f"{errors[:5]}")
    lat.sort()
    return {"clients": clients, "requests": total, "seconds": wall,
            "req_per_s": total / wall, "p50_ms": lat[total // 2],
            "p99_ms": lat[int(total * 0.99) - 1]}


def multipart_body(fields: dict, files: dict) -> tuple[bytes, str]:
    boundary = "mlapi-chip-smoke-boundary"
    parts = []
    for name, value in fields.items():
        parts.append(f'--{boundary}\r\ncontent-disposition: form-data; '
                     f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (filename, data) in files.items():
        parts.append(f'--{boundary}\r\ncontent-disposition: form-data; '
                     f'name="{name}"; filename="{filename}"\r\n'
                     f'content-type: text/csv\r\n\r\n'.encode()
                     + data + b"\r\n")
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def iris_leg(scratch: Path, power) -> dict:
    """``iris-linear`` trained on the card through the train CLI's
    ``run``, then served by ``python -m mlapi_tpu_torch.serving`` as a
    subprocess: the 30 test rows one at a time and all at once (labels
    equal to the checkpoint's plain forward on the CPU, probabilities
    within 1e-5; the burst in at most ceil(30 / max_batch) + 1 device
    calls), a ``/files/`` round trip, ``/healthz`` and a 422; then a
    closed-loop ``/predict`` load at batch 1 on a server at the default
    batch window (informational)."""
    import numpy as np
    import torch

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.__main__ import run

    ckpt = scratch / "iris-linear"
    t0 = time.perf_counter()
    summary = run(get_preset("iris-linear"), str(ckpt))
    train_s = time.perf_counter() - t0
    if summary["device"] != "cuda:0" or not (
            summary["test_accuracy"] >= IRIS_MIN_ACCURACY):
        raise SystemExit(f"iris-linear: {summary['test_accuracy']} on "
                         f"{summary['device']}, want >= "
                         f"{IRIS_MIN_ACCURACY} on the card")
    splits = get_dataset("iris")
    names = splits.feature_names
    rows = splits.x_test
    model = get_model("linear", num_features=4, num_classes=3, seed=None,
                      device="cpu")
    state, meta = load_checkpoint(ckpt, model)
    model.load_state_dict(state)
    with torch.no_grad():
        probs = torch.softmax(model.apply(torch.as_tensor(rows)), -1)
    want = [(meta.vocab.labels[int(i)], float(p))
            for i, p in zip(probs.argmax(-1), probs.max(-1).values)]
    bodies = [{n: float(v) for n, v in zip(names, r)} for r in rows]

    proc, port = spawn_server(["--checkpoint", str(ckpt),
                               "--max-wait-ms", "20"],
                              scratch / "iris_server.log")
    try:
        single = [predict(port, b) for b in bodies]
        calls0 = get(port, "/metrics")["counters"]["batcher.device_calls"]
        burst = at_once(lambda b: predict(port, b), bodies)
        calls = (get(port, "/metrics")["counters"]["batcher.device_calls"]
                 - calls0)
        csv = ("sepal_length,sepal_width,petal_length,petal_width,species\n"
               + "".join(",".join(f"{v:g}" for v in r)
                         + f",{meta.vocab.labels[int(y)]}\n"
                         for r, y in zip(rows, splits.y_test))).encode()
        body, ctype = multipart_body({"token": "tok"},
                                     {"file": ("iris.csv", csv)})
        files_status, files_out = http(port, "POST", "/files/", body, ctype)
        health = get(port, "/healthz")
        bad_status, bad_out = http(port, "POST", "/predict", json.dumps(
            {k: v for k, v in bodies[0].items() if k != "petal_width"}
        ).encode())
    finally:
        stop_server(proc)
    max_batch = 512
    err = max(abs(g["probability"] - p)
              for got in (single, burst) for g, (_, p) in zip(got, want))
    labels_ok = all([g["prediction"] for g in got] == [w for w, _ in want]
                    for got in (single, burst))
    files = json.loads(files_out) if files_status == 200 else {}
    fecho = files.get("file", {})
    files_ok = (files.get("token") == "tok" and fecho.get("rows") == 30
                and fecho.get("columns") == [*names, "species"]
                and fecho["records"][0]["species"]
                == meta.vocab.labels[int(splits.y_test[0])]
                and fecho["truncated"] is False)
    bad = json.loads(bad_out)["detail"] if bad_status == 422 else None

    proc, port = spawn_server(["--checkpoint", str(ckpt)],
                              scratch / "iris_server_default.log")
    try:
        raw = [json.dumps(b).encode() for b in bodies]
        load = closed_loop(port, raw, CLOSED_LOOP_CLIENTS,
                           CLOSED_LOOP_REQUESTS)
        load["device_calls"] = get(port, "/metrics")["counters"][
            "batcher.device_calls"]
    finally:
        stop_server(proc)
    row = {
        "case": "scoring_iris", "train_seconds": train_s,
        "test_accuracy": summary["test_accuracy"],
        "final_loss": summary["final_loss"],
        "max_prob_err": err, "labels_equal_plain_cpu": labels_ok,
        "burst_device_calls": calls,
        "burst_device_calls_max": math.ceil(len(rows) / max_batch) + 1,
        "files_ok": files_ok, "healthz": {k: health[k] for k in (
            "status", "model", "classes", "backend", "device")},
        "missing_field_422": bad,
        "closed_loop_batch_1": {**load, "max_wait_ms": 0.2},
        "card": power,
    }
    emit(row)
    if not labels_ok or err > 1e-5:
        raise SystemExit(f"iris /predict disagrees with the plain forward: "
                         f"labels {labels_ok}, max prob err {err}")
    if calls > row["burst_device_calls_max"]:
        raise SystemExit(f"30 concurrent rows took {calls} device calls")
    if not files_ok:
        raise SystemExit(f"/files/ answered {files_status}: {files}")
    if (health["status"] != "ok" or health["backend"] != "cuda"
            or health["classes"] != list(meta.vocab.labels)):
        raise SystemExit(f"/healthz: {health}")
    if not bad or bad[0]["loc"] != ["petal_width"]:
        raise SystemExit(f"a missing field answered {bad_status}: {bad}")
    if not np.isfinite(load["p99_ms"]):
        raise SystemExit(f"closed loop: {load}")
    return row


def sst2_texts(n: int, seed: int = 0) -> list:
    """``n`` sentences of the synthetic sst2 corpus's words (filler and
    planted polarity words, 6-60 words each, drawn from ``seed``)."""
    import numpy as np

    from mlapi_tpu_torch.datasets import sst2

    rng = np.random.default_rng(seed)
    words = sst2._FILLER + sst2._POSITIVE + sst2._NEGATIVE
    return [" ".join(rng.choice(words, size=int(rng.integers(6, 61))))
            for _ in range(n)]


def sst2_serving_leg(ckpt: Path, power) -> dict:
    """The sst2-bert run's checkpoint served through the CLI's engine
    factory (a TextClassificationEngine, flash attention: B5) and the
    HTTP app: 64 concurrent texts, the launch counters zeroed just
    before and read just after (B5 exactly 12 per device call, all on
    ``mma``, no other attention kernel); labels equal to the same
    weights with ``attention_impl="full"`` on the card (ties reported),
    max-probabilities within 2e-2; and one 64-row batch's wall and
    device time (profiled)."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.engine import TextClassificationEngine
    from mlapi_tpu_torch.serving.server import BackgroundServer

    engine = build_engine(ckpt)
    if not isinstance(engine, TextClassificationEngine):
        raise SystemExit(f"sst2-bert served by {type(engine).__name__}")
    texts = sst2_texts(SCORE_TEXTS)
    app = build_app(engine)
    with BackgroundServer(app) as srv:
        sp = app.state["batcher"]
        calls0 = sp.device_calls
        zero_counters()
        answers = at_once(lambda t: predict(srv.port, {"text": t}), texts)
        launches, bodies = read_counters()
        calls = sp.device_calls - calls0
    cfg = json.loads((ckpt / "MANIFEST.json").read_text())["config"]
    full = get_model(cfg["model"], **{**cfg["model_kwargs"],
                                      "attention_impl": "full"},
                     seed=None, device="cpu")
    state, meta = load_checkpoint(ckpt, full)
    full.load_state_dict(state)
    full.requires_grad_(False)
    ref = TextClassificationEngine(full.to("cuda"), meta.vocab,
                                   tokenizer=engine.tokenizer,
                                   max_len=engine.max_len)
    rows = np.stack([engine.encode(t) for t in texts])
    want_ids, want_p = ref.predict(rows)
    got = [meta.vocab.labels.index(a["prediction"]) for a in answers]
    got_p = np.asarray([a["probability"] for a in answers])
    differ = [i for i in range(len(texts)) if got[i] != want_ids[i]]
    # Two classes: full attention's top-1 - top-2 margin is 2 p - 1.
    ties = [{"row": i, "full_max_prob": float(want_p[i]),
             "margin": float(2 * want_p[i] - 1)} for i in differ]
    p_err = float(np.abs(got_p - want_p).max())
    # One 64-row batch through the engine (no HTTP): wall ms, median of
    # five, and device ms of one profiled call.
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(rows)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.predict(rows)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device = sum(e.device_time_total for e in kernels) / 1e3
    b5 = sum(e.device_time_total for e in kernels
             if "flash_" in e.name) / 1e3
    by_name: dict = {}
    for e in kernels:
        key = e.name[:90]
        by_name[key] = by_name.get(key, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    wall = statistics.median(walls[1:])
    want = {name: 0 for name in KERNELS}
    want["flash_forward"] = 12 * calls
    row = {
        "case": "scoring_sst2_bert", "texts": len(texts),
        "device_calls": calls, "launches": launches,
        "launches_expected": want, "bodies": bodies,
        "labels_equal_full": not differ, "ties": ties,
        "max_prob_err": p_err,
        "batch_64": {"wall_ms": wall, "device_ms": device,
                     "b5_device_ms": b5, "busy": device / wall,
                     "kernels": len(kernels),
                     "top_kernels_ms": dict(top)},
        "card": power,
    }
    emit(row)
    if launches != want or bodies["flash_forward"] != {
            "mma": want["flash_forward"], "fma": 0}:
        raise SystemExit(f"sst2-bert /predict: launches {launches}, bodies "
                         f"{bodies}, want {want} all on mma")
    # A label may differ only where full attention's answer is a near
    # tie: its top-1 - top-2 margin within 2e-2.
    if p_err > 2e-2 or any(t["margin"] > 2e-2 for t in ties):
        raise SystemExit(f"sst2-bert flash vs full: max prob err {p_err}, "
                         f"label changes {ties}")
    del engine, ref, full
    torch.cuda.empty_cache()
    return row


def wide_deep_numpy(state: dict, x, cfg: dict):
    """The plain Wide&Deep forward in float32 numpy from a checkpoint's
    tensors (no module of the port): ids truncated toward zero, each
    feature's vocab remainder (numpy's takes the divisor's sign), the
    wide sum and the ReLU MLP over the dense features and the deep
    embeddings."""
    import numpy as np

    w = {k: v.numpy() for k, v in state.items()}
    nd, f = cfg["num_dense"], len(cfg["vocab_sizes"])
    dense = x[:, :nd]
    ids = np.remainder(x[:, nd:].astype(np.int32),
                       np.asarray(cfg["vocab_sizes"], np.int32))
    feat = np.arange(f)[None, :]
    wide = (dense @ w["wide_dense"] + w["wide_bias"]
            + w["wide_tables"][feat, ids].sum(1))
    h = np.concatenate([dense, w["deep_tables"][feat, ids].reshape(
        len(x), -1)], axis=1)
    n = len(cfg["hidden_dims"])
    for i in range(n):
        h = np.maximum(h @ w[f"deep_{i}.kernel"] + w[f"deep_{i}.bias"], 0)
    return wide + h @ w[f"deep_{n}.kernel"] + w[f"deep_{n}.bias"]


def wide_deep_leg(scratch: Path, power) -> dict:
    """A Wide&Deep checkpoint at the criteo-widedeep preset's widths
    (26 tables of 100,000 rows, 16 + 2 wide; weights from seed 0,
    written by ``save_checkpoint``) served through the CLI's engine
    factory and the HTTP app: 256 criteo rows through ``/predict``,
    held to :func:`wide_deep_numpy` on the tensors read back from the
    checkpoint file (probabilities within 2e-2, labels equal where its
    top-1 - top-2 margin exceeds 2e-2). So the leg checks the port's
    model on the card (bf16 hidden layers) as well as the checkpoint
    round trip, HTTP and batching."""
    import numpy as np
    import torch

    from mlapi_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.server import BackgroundServer

    splits = get_dataset("criteo", n_train=256, n_test=256)
    t0 = time.perf_counter()
    model = get_model("wide_deep", **CRITEO_WIDE_DEEP, seed=0, device="cpu")
    path = save_checkpoint(scratch / "criteo-widedeep", model, config={
        "model": "wide_deep", "model_kwargs": CRITEO_WIDE_DEEP,
        "feature_names": list(splits.feature_names)}, vocab=splits.vocab)
    write_s = time.perf_counter() - t0
    del model
    engine = build_engine(path)
    names = splits.feature_names
    rows = splits.x_test[:256]
    app = build_app(engine)
    with BackgroundServer(app) as srv:
        sp = app.state["batcher"]
        calls0 = sp.device_calls
        answers = at_once(
            lambda r: predict(srv.port, dict(zip(names, map(float, r)))),
            list(rows), workers=64)
        calls = sp.device_calls - calls0
    del engine
    torch.cuda.empty_cache()
    state, _ = load_checkpoint(path)
    logits = wide_deep_numpy(state, rows, CRITEO_WIDE_DEEP)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    labels = splits.vocab.labels
    got = np.asarray([labels.index(a["prediction"]) for a in answers])
    got_p = np.asarray([a["probability"] for a in answers])
    top2 = np.sort(probs, -1)
    margin = top2[:, -1] - top2[:, -2]
    differ = got != probs.argmax(-1)
    p_err = float(np.abs(got_p - probs.max(-1)).max())
    row = {
        "case": "scoring_wide_deep", "rows": len(rows),
        "reference": "float32 numpy forward of the checkpoint's tensors",
        "tables": [len(CRITEO_WIDE_DEEP["vocab_sizes"]),
                   max(CRITEO_WIDE_DEEP["vocab_sizes"]),
                   CRITEO_WIDE_DEEP["embed_dim"]
                   + CRITEO_WIDE_DEEP["num_classes"]],
        "checkpoint_write_s": write_s,
        "device_calls": calls, "max_prob_err": p_err,
        "labels": [int((probs.argmax(-1) == c).sum())
                   for c in range(len(labels))],
        "margin_min": float(margin.min()),
        "labels_differ": int(differ.sum()),
        "labels_differ_past_margin": int((differ & (margin > 2e-2)).sum()),
        "card": power,
    }
    emit(row)
    if p_err > 2e-2 or row["labels_differ_past_margin"]:
        raise SystemExit(f"Wide&Deep /predict disagrees with its plain "
                         f"forward: {row}")
    return row


def coresident_leg(gpt_ckpt: Path, sst2_ckpt: Path, scratch: Path,
                   power) -> dict:
    """One ``python -m mlapi_tpu_torch.serving`` process serving GPT-2
    small (flash, paged 16) as the default model and sst2-bert as
    ``--model clf=...``: 8 greedy streams alone, then the same 8 with 64
    ``/models/clf/predict`` texts at once. The streams must equal the
    ones served alone, every scoring batch must run as a score unit on
    the GPT engine's scheduler (``generate.sched_units_score`` > 0 and
    equal to ``model.clf.sched_dispatches`` and
    ``model.clf.device_calls``), with 12 B5 launches per scoring batch
    (``/metrics`` ``kernels``)."""
    proc, port = spawn_server(
        ["--checkpoint", str(gpt_ckpt), "--decode-attn-impl", "flash",
         "--kv-page-size", "16", "--model", f"clf={sst2_ckpt}"],
        scratch / "coresident_server.log")
    gen_bodies = [{"text": t, "max_new_tokens": 32}
                  for t in SHORT_PROMPTS]
    texts = sst2_texts(SCORE_TEXTS, seed=1)
    try:
        health = get(port, "/healthz")
        alone = at_once(lambda b: json.loads(post(port, b))["token_ids"],
                        gen_bodies)
        m0 = get(port, "/metrics")
        items = ([("g", b) for b in gen_bodies]
                 + [("s", {"text": t}) for t in texts])
        t0 = time.perf_counter()
        outs = at_once(
            lambda it: (json.loads(post(port, it[1]))["token_ids"]
                        if it[0] == "g"
                        else predict(port, it[1], "/models/clf/predict")),
            items)
        mixed_s = time.perf_counter() - t0
        m1 = get(port, "/metrics")
    finally:
        stop_server(proc)

    def delta(key, group="counters"):
        return m1[group][key] - m0[group][key]

    together = outs[:len(gen_bodies)]
    row = {
        "case": "scoring_coresident", "streams": len(gen_bodies),
        "predicts": len(texts), "seconds": mixed_s,
        "models": health.get("models"),
        "streams_equal_alone": together == alone,
        "sched_units_score": delta("generate.sched_units_score"),
        "sched_dispatches": delta("model.clf.sched_dispatches"),
        "device_calls": delta("model.clf.device_calls"),
        "b5_launches": m1["kernels"]["flash_forward"]
        - m0["kernels"]["flash_forward"],
        "generate_batches": delta("generate.batch_calls"),
        "card": power,
    }
    emit(row)
    if not row["streams_equal_alone"]:
        raise SystemExit("co-resident: the streams changed beside scoring")
    if not (row["sched_units_score"] > 0 and row["sched_units_score"]
            == row["sched_dispatches"] == row["device_calls"]):
        raise SystemExit(f"co-resident: score units {row}")
    if row["b5_launches"] != 12 * row["device_calls"]:
        raise SystemExit(f"co-resident: {row['b5_launches']} B5 launches "
                         f"for {row['device_calls']} scoring batches")
    if any(a.get("prediction") not in ("negative", "positive")
           for a in outs[len(gen_bodies):]):
        raise SystemExit("co-resident: a /predict answer lost its label")
    return row


def check_b5_serving(power, sst2_x) -> list:
    """B5 at the serving shapes of the sst2-bert classifier: B in
    B5_SERVING_BATCHES, L = 128, 12 heads of 64, bf16, key masks from
    sst2 rows; the last quarter of the rows of B = 64 and 512 are bucket
    padding (all keys masked, dead). Each row: kernel
    ms (graph replays), device ms (profiled, per B5 event, with every
    kernel's event count), the bound, SDPA's and the plain version's ms,
    the max error on live rows, exact zeros on dead ones, the body."""
    import torch

    from mlapi_tpu_torch.ops import cuda as kern

    rows = []
    for b in B5_SERVING_BATCHES:
        live = b if b == 1 else b - b // 4
        row_len = (sst2_x != 0).sum(axis=1).tolist()
        lengths = [row_len[i % len(row_len)] for i in range(live)]
        lengths += [0] * (b - live)
        shape = (f"serve-b{b}", b, 128, 12, 12, "bfloat16", False, None,
                 lengths, 64)
        cfg = dict(causal=False, scale=64 ** -0.5, window=None)
        q, k, v, mask, _ = flash_inputs(shape, seed=500 + b)
        before = dict(kern.flash_forward.bodies)
        out, _ = kern.flash_forward(q, k, v, mask, **cfg)
        want, _ = kern.flash_forward_plain(q, k, v, mask, **cfg)
        torch.cuda.synchronize()
        body = [x for x, n in kern.flash_forward.bodies.items()
                if n != before[x]]
        live_q = mask.bool().any(-1)
        err = float((out.float() - want.float()).abs()[live_q].max())
        dead_zero = not bool(out[~live_q].any())
        nbytes0 = 4 * q.numel() * q.element_size()
        sets = [flash_inputs(shape, seed=600 + b + s)[:4]
                for s in range(min(8, max(2, math.ceil(160e6 / nbytes0))))]
        fn = [(lambda a=a: kern.flash_forward(*a, **cfg)) for a in sets]
        sdpa = [sdpa_flash_fns(*a, False, None, a[0])[0] for a in sets]
        nbytes, flops, _ = flash_bytes_flops("flash_forward", q, k, mask,
                                             False, None)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        kernel_ms = graph_ms(fn)
        # Every kernel the profiled calls launched, with its event count:
        # one B5 event a call is expected; device_ms is per B5 event, so
        # an event the profiler drops does not shrink it.
        events = profiled_kernels(fn, iters=B5_PROFILED_CALLS)
        b5_events = sum(n for name, (n, _) in events.items()
                        if "flash_" in name)
        b5_us = sum(t for name, (_, t) in events.items() if "flash_" in name)
        row = {
            "case": "flash_kernel_serving", "kernel": "flash_forward",
            "shape": shape[0], "B": b, "L": 128, "H": 12, "D": 64,
            "dtype": "bfloat16", "live_rows": live, "body": body,
            "max_abs_err": err, "dead_rows_exact_zero": dead_zero,
            "ms": kernel_ms,
            "device_ms": b5_us / 1e3 / max(b5_events, 1),
            "device_events": {name[:80]: n for name, (n, _) in
                              events.items()},
            "profiled_calls": B5_PROFILED_CALLS,
            "plain_ms": graph_ms(
                [(lambda a=a: kern.flash_forward_plain(*a, **cfg))
                 for a in sets[:2]], iters=6),
            "library_ms": graph_ms(sdpa), "library": "sdpa forward",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": max(t_bytes, t_ops) / kernel_ms,
            "bytes": nbytes, "flops": flops, "card": power,
        }
        emit(row)
        if body != ["mma"] or not dead_zero or err > FLASH_TOLERANCE[
                "bfloat16"]:
            raise SystemExit(f"B5 at serving shape B={b}: {row}")
        rows.append(row)
        del sets, fn, sdpa
        torch.cuda.empty_cache()
    return rows


def scoring_phase(gpt_ckpt: Path, sst2_ckpt: Path, sst2_x, scratch: Path,
                  power) -> dict:
    """Phase 10: Iris, sst2-bert, Wide&Deep, co-resident, B5 rows.
    Returns B5's launches per scoring path."""
    iris_leg(scratch, power)
    srow = sst2_serving_leg(sst2_ckpt, power)
    wide_deep_leg(scratch, power)
    crow = coresident_leg(gpt_ckpt, sst2_ckpt, scratch, power)
    b5_rows = check_b5_serving(power, sst2_x)
    return {
        "launches": {
            f"serve sst2-bert /predict, {SCORE_TEXTS} texts":
            srow["launches"]["flash_forward"],
            f"co-resident clf /predict beside GPT-2, {SCORE_TEXTS} texts":
            crow["b5_launches"]},
        "b5_rows": b5_rows,
    }


# -- 11. the rest of training ---------------------------------------------

RESUME_EVERY = 10               # train-state saves of the killed run
RESUME_KEEP = 2
# The resumed sst2-bert run against phase 4's uninterrupted one (bf16
# compute): step losses 21-30 and every parameter.
RESUME_TOL = {"loss": 1e-2, "param": 1e-3}
CRITEO_STEPS = 500              # the criteo-widedeep run (preset: 2000)
SPARSE_DENSE_STEPS = 20
SPARSE_DENSE_TOL = 1e-4
BENCH_STEPS = {"sst2-bert": 20, "criteo-widedeep": 50}


def committed_steps(root: Path) -> list:
    return sorted(p.name for p in root.glob("step_*")
                  if (p / "MANIFEST.json").exists())


def resume_leg(full_row: dict, full_ckpt: Path, work: Path, power) -> dict:
    """(a) ``python -m mlapi_tpu_torch.train --preset sst2-bert`` with
    train-state saves as a subprocess, SIGKILLed once ``step_00000020``
    has committed, then the same command again in this process (its
    ``parse_args`` and ``run``), the launch counters zeroed just before
    and read just after: it resumes at step 20; B5 one launch a layer per
    step and per eval batch, B6 and B7 one a layer per step, all
    ``mma``; test accuracy equal to phase 4's uninterrupted run, step
    losses 21-30 and parameters within RESUME_TOL; two committed steps
    remain."""
    import signal

    import numpy as np

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.train.__main__ import parse_args, run

    out = work / "sst2-resumed"
    state = Path(f"{out}_train_state")
    argv = ["--preset", "sst2-bert", "--steps", str(SST2_STEPS),
            "--save-every", str(RESUME_EVERY), "--keep-last",
            str(RESUME_KEEP), "--out", str(out)]
    marker = state / f"step_{2 * RESUME_EVERY:08d}" / "MANIFEST.json"
    t0 = time.perf_counter()
    with open(work / "resume_killed.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlapi_tpu_torch.train", *argv],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while not marker.exists():
                if proc.poll() is not None:
                    raise SystemExit(
                        f"resume: the first run exited ({proc.returncode}) "
                        f"before {marker.parent.name} committed; see "
                        f"{log.name}")
                if time.perf_counter() - t0 > 600:
                    raise SystemExit("resume: step 20 never committed")
                time.sleep(0.005)
        finally:
            proc.kill()                                 # SIGKILL
            proc.wait()
    killed_s = time.perf_counter() - t0
    killed = proc.returncode == -signal.SIGKILL
    at_kill = committed_steps(state)
    cfg, kwargs = parse_args(argv)
    zero_counters()
    t0 = time.perf_counter()
    summary = run(cfg, kwargs.pop("out"), **kwargs)
    resumed_s = time.perf_counter() - t0
    launches, bodies = read_counters()
    # Phase 4's counts: one launch a layer per step (B6, B7) and per step
    # and eval batch (B5); the resumed process runs steps 21-30 and the
    # same evaluation.
    ran = SST2_STEPS - 2 * RESUME_EVERY
    layers = full_row["launches"]["flash_backward_dq"] // SST2_STEPS
    eval_launches = full_row["launches"]["flash_forward"] - layers * SST2_STEPS
    want = {name: 0 for name in SERVING}
    want.update(flash_forward=layers * ran + eval_launches,
                flash_backward_dq=layers * ran,
                flash_backward_dkv=layers * ran)
    want_bodies = {name: {"mma": want[name], "fma": 0} for name in FLASH}
    got, _ = load_checkpoint(out)
    full, _ = load_checkpoint(full_ckpt)
    gaps = {k: float((got[k] - v).abs().max()) for k, v in full.items()}
    worst = max(gaps, key=gaps.get)
    loss_gap = float(np.max(np.abs(
        np.asarray(summary["step_losses"])
        - np.asarray(full_row["step_losses"][2 * RESUME_EVERY:]))))
    row = {
        "case": "train_resume", "preset": cfg.name, "steps": SST2_STEPS,
        "save_every": RESUME_EVERY, "keep_last": RESUME_KEEP,
        "killed_by_sigkill": killed, "killed_after_s": killed_s,
        "committed_at_kill": at_kill, "start_step": summary["start_step"],
        "resumed_run_s": resumed_s,
        "committed_after": committed_steps(state),
        "test_accuracy": summary["test_accuracy"],
        "test_accuracy_uninterrupted": full_row["test_accuracy"],
        "step_losses_21_30": summary["step_losses"],
        "max_loss_gap": loss_gap, "max_param_gap": gaps[worst],
        "max_param_gap_leaf": worst,
        "bitwise": all(g == 0.0 for g in gaps.values()) and loss_gap == 0.0,
        "tolerance": RESUME_TOL, "launches": launches,
        "launches_expected": want, "bodies": bodies, "nvidia_smi": power,
    }
    emit(row)
    checks = {
        "killed": killed,
        "resumed_at_20": summary["start_step"] == 2 * RESUME_EVERY,
        "launches": launches == want and bodies == want_bodies,
        "accuracy": row["test_accuracy"] == row["test_accuracy_uninterrupted"],
        "losses": loss_gap <= RESUME_TOL["loss"],
        "params": gaps[worst] <= RESUME_TOL["param"],
        "kept": row["committed_after"] == [
            f"step_{s:08d}" for s in (RESUME_EVERY, 2 * RESUME_EVERY)],
    }
    if not all(checks.values()):
        raise SystemExit(f"resume leg failed: {checks}; want {want}, "
                         f"{want_bodies}")
    return row


def mean_kl(teacher, student, x, batch: int = 256) -> float:
    """Mean KL(teacher || student) at temperature 1 over the next-token
    positions of ``x`` that are not pad (id 0)."""
    import torch
    import torch.nn.functional as F

    total = count = 0.0
    with torch.no_grad():
        for s in range(0, len(x), batch):
            ids = torch.as_tensor(x[s:s + batch]).long().to("cuda")
            keep = (ids[:, 1:] != 0).float()
            t = F.log_softmax(teacher.apply(ids).float()[:, :-1], -1)
            q = F.log_softmax(student.apply(ids).float()[:, :-1], -1)
            kl = (t.exp() * (t - q)).sum(-1)
            total += float((kl * keep).sum())
            count += float(keep.sum())
    return total / count


def distill_leg(work: Path, power) -> dict:
    """(b) ``docs-gpt`` (the teacher), ``docs-gpt-draft`` (hard labels)
    and ``docs-gpt-draft-distilled --distill-from <teacher>`` through the
    train CLI's ``run``, all with ``attention_impl="flash"``, counters
    zeroed just before and read just after each: per distilled step the
    teacher's B5 once per layer (2, head dim 32) and the student's B5, B6
    and B7 once (1 layer, head dim 12), all ``fma`` (float32); plus the
    student's B5 per eval batch. The distilled draft's mean KL to the
    teacher on the test split must be below the hard-label draft's."""
    import dataclasses

    import torch

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.__main__ import run

    def flash(name, **kw):
        cfg = get_preset(name)
        return dataclasses.replace(
            cfg, model_kwargs={**cfg.model_kwargs, "attention_impl": "flash"},
            **kw)

    teacher_dir = work / "docs-gpt"
    runs = {}
    for name, cfg in (
            ("docs-gpt", flash("docs-gpt")),
            ("docs-gpt-draft", flash("docs-gpt-draft")),
            ("docs-gpt-draft-distilled",
             flash("docs-gpt-draft-distilled",
                   distill_from=str(teacher_dir)))):
        zero_counters()
        t0 = time.perf_counter()
        summary = run(cfg, str(work / name))
        launches, bodies = read_counters()
        runs[name] = {"cfg": cfg, "summary": summary, "launches": launches,
                      "bodies": bodies, "seconds": time.perf_counter() - t0}
    splits = get_dataset("docs_text", seq_len=128)
    eval_batches = math.ceil(len(splits.x_test) / 256)   # evaluate_lm's
    models = {}
    for name, r in runs.items():
        cfg = r["cfg"]
        model = get_model(cfg.model, **cfg.model_kwargs, seed=None,
                          device="cuda")
        model.load_state_dict(load_checkpoint(work / name, model)[0])
        models[name] = model
        s_layers = cfg.model_kwargs["num_layers"]
        evals = cfg.steps // cfg.eval_every + 1
        t_layers = (get_preset("docs-gpt").model_kwargs["num_layers"]
                    if cfg.distill_from else 0)
        want = {k: 0 for k in SERVING}
        want.update(
            flash_forward=cfg.steps * (t_layers + s_layers)
            + s_layers * eval_batches * evals,
            flash_backward_dq=cfg.steps * s_layers,
            flash_backward_dkv=cfg.steps * s_layers)
        r["want"] = want
    kl = {name: mean_kl(models["docs-gpt"], models[name], splits.x_test)
          for name in ("docs-gpt-draft", "docs-gpt-draft-distilled")}
    row = {"case": "train_distill", "nvidia_smi": power,
           "mean_kl_to_teacher": kl,
           "runs": {name: {"steps": r["cfg"].steps,
                           "first_loss": r["summary"]["first_loss"],
                           "final_loss": r["summary"]["final_loss"],
                           "test_next_token_accuracy":
                           r["summary"]["test_accuracy"],
                           "wall_ms_per_step_median": sorted(
                               r["summary"]["step_ms"])[
                               len(r["summary"]["step_ms"]) // 2],
                           "run_seconds": r["seconds"],
                           "launches": r["launches"],
                           "launches_expected": r["want"],
                           "bodies": r["bodies"]}
                    for name, r in runs.items()}}
    emit(row)
    del models
    torch.cuda.empty_cache()
    for name, r in runs.items():
        want_bodies = {k: {"mma": 0, "fma": r["want"][k]} for k in FLASH}
        if r["launches"] != r["want"] or r["bodies"] != want_bodies:
            raise SystemExit(f"distill leg: {name} launches {r['launches']}, "
                             f"bodies {r['bodies']}; want {r['want']}")
    if not kl["docs-gpt-draft-distilled"] < kl["docs-gpt-draft"]:
        raise SystemExit(f"distill leg: the distilled draft is not closer "
                         f"to the teacher: {kl}")
    return {name: r["launches"] for name, r in runs.items()}


def profiled_steps_ms(step, batches, runs: int = 5) -> float:
    """Device ms per step of ``runs`` steps under ``torch.profiler`` (the
    kernels and copies they launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(runs):
            float(step(*batches[i % len(batches)]))
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in device_kernels(prof)) / 1e3 / runs


def criteo_leg(work: Path, power) -> dict:
    """(c) ``criteo-widedeep`` at its published widths (26 tables of
    100,000 rows × 16, dense 13, hidden 256/128, batch 1024) on its
    seeded synthetic stand-in with ``recsys-sparse-adamw`` through the
    train CLI's ``run`` for CRITEO_STEPS steps (test accuracy printed);
    then from one init SPARSE_DENSE_STEPS sparse steps against as many
    dense ``recsys-adamw`` steps: parameters within SPARSE_DENSE_TOL,
    rows no batch touched bit-equal to the init on both; wall and
    profiled device ms per step both ways."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.__main__ import run
    from mlapi_tpu_torch.train.loop import (
        _as_input,
        _make_optimizer,
        _make_sparse_step,
        fit,
        make_train_step,
    )

    cfg = dataclasses.replace(get_preset("criteo-widedeep"),
                              steps=CRITEO_STEPS)
    zero_counters()
    t0 = time.perf_counter()
    summary = run(cfg, None)
    run_s = time.perf_counter() - t0
    launches, _ = read_counters()
    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    kw = dict(steps=SPARSE_DENSE_STEPS, batch_size=cfg.batch_size,
              learning_rate=cfg.learning_rate, seed=cfg.seed)
    results, models = {}, {}
    for opt in ("recsys-adamw", "recsys-sparse-adamw"):
        models[opt] = get_model(cfg.model, **cfg.model_kwargs, seed=cfg.seed,
                                device="cuda")
        results[opt] = fit(models[opt], splits, optimizer=opt, **kw)
    init = get_model(cfg.model, **cfg.model_kwargs, seed=cfg.seed,
                     device="cuda").state_dict()
    n, nd = len(splits.x_train), cfg.model_kwargs["num_dense"]
    vocab = np.asarray(cfg.model_kwargs["vocab_sizes"])
    touched = np.zeros((len(vocab), int(vocab.max())), bool)
    for i in range(SPARSE_DENSE_STEPS):
        idx = np.random.default_rng((cfg.seed, i)).choice(
            n, size=cfg.batch_size, replace=False)
        ids = np.remainder(splits.x_train[idx, nd:].astype(np.int32), vocab)
        touched[np.arange(len(vocab))[None, :], ids] = True
    frozen = torch.as_tensor(~touched, device="cuda")
    dense_sd = models["recsys-adamw"].state_dict()
    sparse_sd = models["recsys-sparse-adamw"].state_dict()
    gaps = {k: float((sparse_sd[k] - v).abs().max())
            for k, v in dense_sd.items()}
    untouched_equal = all(
        torch.equal(sd[k][frozen], init[k][frozen])
        for sd in (dense_sd, sparse_sd) for k in init if k.endswith("_tables"))
    # Device time per step of each way, on batches of the run's schedule.
    batches = []
    for i in range(3):
        idx = np.random.default_rng((cfg.seed, 100 + i)).choice(
            n, size=cfg.batch_size, replace=False)
        batches.append((_as_input(splits.x_train[idx], "cuda"),
                        _as_input(splits.y_train[idx], "cuda")))
    device_ms = {}
    for opt, model in models.items():
        if opt.startswith("recsys-sparse-"):
            _, step = _make_sparse_step(opt, cfg.learning_rate, model)
        else:
            named = dict(model.named_parameters())
            step = make_train_step(model.apply, named, _make_optimizer(
                opt, cfg.learning_rate, named.values(), model=model))
        for b in batches:
            float(step(*b))                             # warm
        device_ms[opt] = profiled_steps_ms(step, batches)
    row = {
        "case": "train_criteo", "preset": cfg.name, "steps": CRITEO_STEPS,
        "batch": cfg.batch_size, "model": cfg.model_kwargs,
        "dataset_source": summary["dataset_source"],
        "first_loss": summary["first_loss"],
        "final_loss": summary["final_loss"],
        "test_accuracy": summary["test_accuracy"], "run_seconds": run_s,
        "wall_ms_per_step_median": statistics.median(summary["step_ms"]),
        "launches": launches,
        "sparse_vs_dense": {
            "steps": SPARSE_DENSE_STEPS, "max_param_gap": max(gaps.values()),
            "gaps": gaps, "tolerance": SPARSE_DENSE_TOL,
            "untouched_rows_bit_equal": untouched_equal,
            "touched_rows": int(touched.sum()),
            "wall_ms_per_step_median": {
                opt: statistics.median(r.step_ms[2:])
                for opt, r in results.items()},
            "device_ms_per_step": device_ms},
        "nvidia_smi": power,
    }
    emit(row)
    del models, init
    torch.cuda.empty_cache()
    if not (math.isfinite(row["final_loss"])
            and max(gaps.values()) <= SPARSE_DENSE_TOL and untouched_equal
            and sum(launches.values()) == 0):
        raise SystemExit(f"criteo leg failed: {row}")
    return row


def bench_leg(power) -> dict:
    """(d) ``--bench`` rows (the train CLI's ``bench_train``) for
    sst2-bert and criteo-widedeep, counters zeroed just before and read
    just after each: step ms, examples/s, FLOPs (B5-B7 from their
    shapes) and MFU."""
    from mlapi_tpu_torch.train.bench import bench_train

    launches = {}
    for preset, steps in BENCH_STEPS.items():
        zero_counters()
        row = bench_train(preset, bench_steps=steps)
        launches[preset], bodies = read_counters()
        emit({"case": "train_bench", **row, "launches": launches[preset],
              "bodies": bodies, "nvidia_smi": power})
        if not (row["mfu"] and row["mfu"] > 0 and row["backend"] == "cuda"):
            raise SystemExit(f"bench leg: no MFU for {preset}: {row}")
    return launches


def debug_profile_leg(work: Path, power) -> dict:
    """``--debug-checks``: a batch with a NaN feature raises at step 1 on
    the card, and the flash path (docs-gpt-draft, B5-B7) trains clean
    under the checks; ``--profile-dir``: the trace of a few flash steps
    names the flash kernels."""
    import dataclasses
    import json as _json

    import numpy as np

    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.train.__main__ import run
    from mlapi_tpu_torch.train.loop import fit

    class Poisoned:
        x_train = np.zeros((64, 4), np.float32)
        y_train = np.zeros((64,), np.int32)
        x_test = np.zeros((0, 4), np.float32)
        y_test = np.zeros((0,), np.int32)

    Poisoned.x_train[3, 2] = np.nan
    model = get_model("linear", num_features=4, num_classes=3, device="cuda")
    try:
        fit(model, Poisoned(), steps=5, debug_checks=True)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    cfg = get_preset("docs-gpt-draft")
    cfg = dataclasses.replace(
        cfg, steps=3, model_kwargs={**cfg.model_kwargs,
                                    "attention_impl": "flash"})
    clean = run(cfg, None, debug_checks=True)
    prof_dir = work / "profile"
    run(cfg, None, profile_dir=str(prof_dir))
    trace = _json.loads((prof_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    flash = sorted({n[:80] for n in names
                    if "flash_fwd" in n or "flash_bwd" in n})
    row = {"case": "train_debug_profile", "poisoned_raised": raised,
           "clean_flash_run_final_loss": clean["final_loss"],
           "trace_flash_kernels": flash,
           "trace_bytes": (prof_dir / "trace.json").stat().st_size,
           "nvidia_smi": power}
    emit(row)
    if not (raised and "nan" in raised.lower()
            and raised.endswith("at step 1")
            and math.isfinite(clean["final_loss"])
            and any("flash_fwd" in n for n in flash)
            and any("flash_bwd_dq" in n for n in flash)
            and any("flash_bwd_dkv" in n for n in flash)):
        raise SystemExit(f"debug/profile leg failed: {row}")
    return row


def rest_of_training(train_row: dict, sst2_ckpt: Path, work: Path,
                     power) -> dict:
    """Item 11 of the docstring. Returns each leg's B5-B7 launches by
    path."""
    seconds = {}
    t0 = time.perf_counter()
    resume = resume_leg(train_row, sst2_ckpt, work, power)
    seconds["resume"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    distill = distill_leg(work, power)
    seconds["distill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    criteo_leg(work, power)
    seconds["criteo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench = bench_leg(power)
    seconds["bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    debug_profile_leg(work, power)
    seconds["debug_profile"] = time.perf_counter() - t0
    emit({"case": "rest_of_training_seconds", **seconds})
    paths = {f"resume sst2-bert, steps {2 * RESUME_EVERY + 1}-{SST2_STEPS}"
             " + test eval": resume["launches"]}
    for name, launches in distill.items():
        paths[f"train {name} (flash), steps + evals"] = launches
    for preset, launches in bench.items():
        paths[f"bench {preset}, {BENCH_STEPS[preset]} steps + warmup"] = (
            launches)
    return {k: {path: counts[k] for path, counts in paths.items()}
            for k in FLASH}


# -- 12. int8 weights, adapters and tenants, LoRA ---------------------------

ADAPTER_RANK = 8
ADAPTER_SLOTS = 4
ADAPTER_IDS = ("t1", "t2", "t3")
ITEM5_NEW = 32                   # new tokens of the launch-count batches
AGREE_NEW = 64                   # teacher-forced agreement positions
LORA_STEPS = 10                  # sst2-bert LoRA fine-tune steps
LORA_TEXTS = 16                  # /predict texts of each sst2 leg
# Teacher-forced top-1 agreement limits of phase 12's bf16 legs, each
# between the leg's worst sound reading and its controls' best, read on
# an H100 (PERF.md, PR 14). int8 weights against the float engine: sound
# 0.973 (GPT-2) and 0.818 (TinyLlama); the same int8 weights dequantized
# with wrong scales (:func:`wrong_scales`) at most 0.471 and 0.031. The
# slot path against the eagerly merged engine: sound 0.992 and 0.939;
# the adapter dropped, or another in its place, at most 0.178 and 0.035.
# An agreement under its limit fails the leg, and so does a control over
# it (the limit could not have seen that fault).
INT8_AGREE = {"gpt2-small": 0.9, "tinyllama-1.1b": 0.75}
SLOTS_AGREE = {"gpt2-small": 0.9, "tinyllama-1.1b": 0.9}


def adapter_targets(cfg: dict) -> dict:
    """``{target: (d_in, d_out)}`` of every adapted kernel of a layer
    (``models/lora.DEFAULT_TARGETS``) at ``cfg``'s widths."""
    h = cfg["hidden_size"]
    if "num_kv_heads" not in cfg:            # GPT-2
        return {"qkv": (h, 3 * h), "attn_out": (h, h), "ffn_up": (h, 4 * h),
                "ffn_down": (4 * h, h)}
    kvd = cfg["num_kv_heads"] * (h // cfg["num_heads"])
    f = cfg["intermediate_size"]
    return {"wq": (h, h), "wk": (h, kvd), "wv": (h, kvd), "wo": (h, h),
            "w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)}


def seeded_adapter(cfg: dict, seed: int, rank: int = ADAPTER_RANK,
                   b_scale: float = 0.05) -> dict:
    """A canonical serving payload (``b`` carrying its scale) over every
    target of ``cfg``: ``a ~ N(0, 1/d_in)``, ``b ~ N(0, b_scale^2)``,
    float32, drawn from ``seed``; at 0.05, a delta of 15-25 % of the
    seeded kernels' scale at GPT-2 and TinyLlama widths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {f"layer_{n}": {t: {
        "a": (rng.standard_normal((i, rank)) / math.sqrt(i)).astype(
            np.float32),
        "b": (b_scale * rng.standard_normal((rank, o))).astype(np.float32),
    } for t, (i, o) in adapter_targets(cfg).items()}
        for n in range(cfg["num_layers"])}


def forced_run(engine, prompts, n: int, forced=None, adapter=None):
    """Greedy ``n`` tokens of ``prompts`` (one batch, the engine's own
    formation and decode steps, with ``adapter``'s context on every
    step), or teacher-forced by ``forced``'s tokens. Returns ``(tokens [B,
    n], logits [B, n, V])``."""
    import torch

    import mlapi_tpu_torch.models.gpt as gpt
    from mlapi_tpu_torch.serving.requests import _SyncSink

    model = engine.model
    pick = gpt._pick_token
    sinks = [_SyncSink(engine._encode(t, n, 0.0, 0, None, adapter=adapter),
                       []) for t in prompts]
    firsts = []

    def capture(temps, logits, *args, **kwargs):
        firsts.append(logits.float())
        return pick(temps, logits, *args, **kwargs)

    gpt._pick_token = capture
    try:
        batch = engine._form_batch(sinks)
    finally:
        gpt._pick_token = pick
    b = batch.b
    try:
        tok = batch._first
        toks, logs = [tok[:b]], [firsts[-1][:b]]
        for t in range(n - 1):
            if batch.pool is not None:
                batch._ensure_pages(1, list(range(b)))
            if forced is not None:
                tok = tok.clone()
                tok[:b] = forced[:, t]
            logits, batch.cache = model.decode_step(
                batch.cache, tok[:, None], batch.pos, batch._n_pad_dev(),
                batch.p_len, batch._lo_arg(), lora=batch._lora())
            tok = pick(batch.temps, logits, batch.seeds, batch.step)
            batch.pos += 1
            toks.append(tok[:b])
            logs.append(logits[:b].float())
    finally:
        batch._paged_cleanup()
        batch._release_adapters()
    return torch.stack(toks, dim=1), torch.stack(logs, dim=1)


def pair_agreement(ref, got, prompts, n: int = AGREE_NEW, adapter=None):
    """Teacher-forced top-1 agreement of engine ``got`` (with
    ``adapter``) with engine ``ref``'s greedy stream (``ref`` an engine,
    or its :func:`forced_run` result), and for each disagreement the
    ``ref`` logits' top-1 - top-2 margin and the largest |got - ref|
    logit difference there (as :func:`forced_agreement`)."""
    import torch

    with torch.inference_mode():
        want, want_logits = (ref if isinstance(ref, tuple)
                             else forced_run(ref, prompts, n))
        have, have_logits = forced_run(got, prompts, n, forced=want,
                                       adapter=adapter)
    ties = []
    for row, pos in (have != want).nonzero().tolist():
        top2 = want_logits[row, pos].topk(2).values
        diff = (have_logits[row, pos] - want_logits[row, pos]).abs().max()
        ties.append({"row": row, "pos": pos,
                     "margin": float(top2[0] - top2[1]),
                     "max_abs_diff": float(diff)})
    return float((have == want).float().mean()), ties


@contextlib.contextmanager
def wrong_scales(model, fault: str):
    """The int8 leg's controls, in place and undone on exit: every int8
    leaf's per-channel scales rolled by one channel (``rolled``: each
    channel dequantized with its neighbour's scale), or each set to its
    tensor's largest (``per_tensor``)."""
    import torch

    from mlapi_tpu_torch.ops.quant import QuantLeaf

    leaves = [m for m in model.modules() if isinstance(m, QuantLeaf)]
    saved = [m.scale.clone() for m in leaves]
    with torch.no_grad():
        for m in leaves:
            m.scale.copy_(m.scale.roll(1, -1) if fault == "rolled"
                          else m.scale.amax().expand_as(m.scale))
    try:
        yield
    finally:
        with torch.no_grad():
            for m, s in zip(leaves, saved):
                m.scale.copy_(s)


def batch_streams(engine, specs, n: int = ITEM5_NEW) -> list:
    """One formed batch of ``(text, adapter)`` through the engine's
    ``_run_batch``: every row's greedy stream."""
    from mlapi_tpu_torch.serving.requests import _SyncSink

    outs = [[] for _ in specs]
    sinks = [_SyncSink(engine._encode(t, n, 0.0, 0, None, adapter=a), out)
             for (t, a), out in zip(specs, outs)]
    engine._run_batch(sinks)
    errors = [s.error for s in sinks if s.error is not None]
    if errors:
        raise SystemExit(f"batch failed: {errors[0]!r}")
    return outs


def counted_decode(engine) -> list:
    """Count the engine's decode steps (one flash-decode launch a layer
    each): returns the one-element counter."""
    steps = [0]
    step = engine.model.decode_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    engine.model.decode_step = counted
    return steps


def launches_of(engine, run) -> dict:
    """``run()`` with the launch counters zeroed just before and read
    just after; with the decode steps and prefill chunks it took and the
    launches they need (B1/B3 one a layer a decode step, B2/B4 one a layer
    a prefill chunk)."""
    steps = counted_decode(engine)
    chunks0 = engine.prefill_chunks
    zero_counters()
    out = run()
    launches, bodies = read_counters(SERVING)
    del engine.model.decode_step
    layers = engine.model.num_layers
    paged = engine.pool is not None
    want = {k: 0 for k in KERNELS}
    want["paged_decode_attention" if paged else "decode_attention"] = (
        layers * steps[0])
    want["paged_extend_attention" if paged else "extend_attention"] = (
        layers * (engine.prefill_chunks - chunks0))
    return {"out": out, "launches": launches, "want": want,
            "bodies": bodies, "decode_steps": steps[0],
            "per_step": {k: v / max(steps[0], 1) for k, v in launches.items()
                         if v and "decode" in k}}


def allocator_bound(model) -> int:
    """The most ``torch.cuda.memory_allocated`` can count for ``model``'s
    tensors: the caching allocator rounds a block up to 512 B, and one
    past 1 MiB up to at most a whole 2 MiB multiple (it leaves a
    remainder under 1 MiB unsplit)."""
    total = 0
    for t in model.state_dict().values():
        n = t.numel() * t.element_size()
        unit = 2 << 20 if n > 1 << 20 else 512
        total += -(-n // unit) * unit
    return total


def weights_leg(ckpt: Path, cfg: dict, model: str, power) -> dict:
    """(a) int8 weights at ``cfg``'s width: the CLI's engine factory with
    ``--quantize int8`` (contiguous bf16 cache; the paged 16 int8 engine
    serves the same quantized model) beside the float engine. Weight
    bytes on the card (``torch.cuda.memory_allocated`` around the load)
    against ``quantized_bytes``; exact B1-B4 launches for 8 short rows
    and one chunked prompt; teacher-forced top-1 agreement with the float
    engine, each disagreement's margin listed, at least ``INT8_AGREE``
    while both :func:`wrong_scales` controls stay under it; decode wall
    and device ms
    and kernels per step beside the float engine's (``profile_decode``).
    Returns launches by path."""
    import torch

    from mlapi_tpu_torch.ops.quant import quantized_bytes
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine

    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qeng = build_engine(ckpt, quantize="int8", decode_attn_impl="flash")
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    on_card = torch.cuda.memory_allocated() - m0
    stored, full = quantized_bytes(qeng.model)
    bound = allocator_bound(qeng.model)
    feng = build_engine(ckpt, decode_attn_impl="flash")
    float_bytes = quantized_bytes(feng.model)[0]
    tensors = sum(1 for _ in qeng.model.state_dict().values())
    paths, rows = {}, []
    for kv_quant, page in ((None, None), ("int8", PAGE)):
        if page:
            for eng in (qeng, feng):
                eng.model.configure(kv_quant=kv_quant)
            qeng = TextGenerationEngine(qeng.model, tokenizer=qeng.tokenizer,
                                        kv_page_size=page, meta=qeng.meta)
            feng = TextGenerationEngine(feng.model, tokenizer=feng.tokenizer,
                                        kv_page_size=page)
        path = f"int8 weights {model} " + (kv_quant or "none") + (
            f", page {page}" if page else "")
        short = launches_of(qeng, lambda: batch_streams(
            qeng, [(t, None) for t in SHORT_PROMPTS]))
        long = launches_of(qeng, lambda: batch_streams(
            qeng, [(LONG_PROMPT, None)], 16))
        launches = {k: short["launches"][k] + long["launches"][k]
                    for k in KERNELS}
        want = {k: short["want"][k] + long["want"][k] for k in KERNELS}
        paths[path] = launches
        with torch.inference_mode():
            reference = forced_run(feng, SHORT_PROMPTS, AGREE_NEW)
        agree, ties = pair_agreement(reference, qeng, SHORT_PROMPTS)
        controls = {}
        for fault in ("rolled", "per_tensor"):
            with wrong_scales(qeng.model, fault):
                controls[f"scales_{fault}"] = pair_agreement(
                    reference, qeng, SHORT_PROMPTS)[0]
        limit = INT8_AGREE[model]
        prof_q = profile_decode(qeng)
        # The float engine's row from phase 5 or 7 of this run, else now.
        prof_f = PROFILES.get((type(feng.model).__name__, cfg["hidden_size"],
                               feng.kv_quant, page)) or profile_decode(feng)
        row = {
            "case": "int8_weights", "model": model,
            "kv_quant": kv_quant or "none", "kv_page_size": page,
            "meta_quantized": qeng.meta.get("quantized"),
            "weight_bytes_on_card": on_card,
            "quantized_bytes_stored": stored, "f32_bytes": full,
            "allocator_bound": bound,
            "float_engine_bytes": float_bytes,
            "weight_tensors": tensors, "load_s": load_s,
            "launches": launches, "launches_expected": want,
            "decode_steps": short["decode_steps"] + long["decode_steps"],
            "bodies": {k: short["bodies"][k] for k in SERVING},
            "top1_agreement_with_float": agree, "disagreements": ties,
            "controls": controls, "limit": limit,
            "decode": {
                side: {k: p[k] for k in ("wall_ms_per_step",
                                         "device_ms_per_step",
                                         "kernels_per_step")}
                for side, p in (("int8", prof_q), ("float", prof_f))},
            "card": power,
        }
        rows.append(row)
        emit(row)
        if not (stored <= on_card <= row["allocator_bound"]
                and row["meta_quantized"] == "int8"):
            raise SystemExit(f"{model} int8 weights: {on_card} bytes on the "
                             f"card for {stored} stored")
        if launches != want:
            raise SystemExit(f"{model} int8 weights {path}: launches "
                             f"{launches}, want {want}")
        if not (agree >= limit
                and all(c < limit for c in controls.values())):
            raise SystemExit(f"{model} int8 weights {path}: top-1 "
                             f"agreement {agree} with the float engine, "
                             f"controls {controls}, limit {limit}")
    del qeng, feng
    torch.cuda.empty_cache()
    return paths


def adapters_leg(ckpt: Path, cfg: dict, model: str, work: Path, power,
                 http_leg: bool = False) -> dict:
    """(b) ``--adapter-slots 4`` and three rank-8 seeded adapters loaded
    through ``--adapter ID=PATH`` files (the CLI's parser and loader) on
    a paged 16 bf16 engine: adapter-slot bytes against the closed form
    (and the first install's pool allocation); launches per decode step
    with adapters equal to those without; a grouped and a mixed batch
    (three tenants and a base row) against each row's solo stream; base
    streams unchanged after adapter traffic; each adapter row of the mixed
    batch apart from its base stream; teacher-forced top-1 agreement of
    the slot path with the eagerly merged engine (margins listed) at
    least ``SLOTS_AGREE``, with two controls under it: the base engine
    and the slot path of another adapter, against the same merged
    engine; with ``http_leg``, one ``/generate`` naming ``adapter`` and
    ``tenant`` and an unknown adapter answering 404. Returns launches by
    path."""
    import torch

    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.models.lora import merge_adapter
    from mlapi_tpu_torch.ops.quant import quantized_bytes
    from mlapi_tpu_torch.serving.__main__ import (
        build_engine,
        make_parser,
        parse_args,
        register_adapters,
    )
    from mlapi_tpu_torch.serving.adapter_store import save_adapter
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.serving.registry import TenantLedger
    from mlapi_tpu_torch.serving.server import BackgroundServer

    payloads = {aid: seeded_adapter(cfg, 100 + i)
                for i, aid in enumerate(ADAPTER_IDS)}
    argv = ["--checkpoint", str(ckpt), "--decode-attn-impl", "flash",
            "--kv-page-size", str(PAGE), "--adapter-slots",
            str(ADAPTER_SLOTS)]
    for aid, payload in payloads.items():
        path = work / f"{model}-{aid}.lora"
        save_adapter(str(path), aid, payload)
        argv += ["--adapter", f"{aid}={path}"]
    parser = make_parser()
    args = parse_args(argv, parser)
    engine = build_engine(args.checkpoint, decode_attn_impl="flash",
                          kv_page_size=args.kv_page_size,
                          adapter_slots=args.adapter_slots)
    register_adapters(parser, engine, args.adapter)
    # The pools take the served kernels' dtype (bf16 at these widths).
    itemsize = torch.empty((), dtype=engine.model.cdt).element_size()
    slot_closed = itemsize * ADAPTER_RANK * cfg["num_layers"] * sum(
        i + o for i, o in adapter_targets(cfg).values())
    base_specs = [(t, None) for t in SHORT_PROMPTS[:4]]
    base = launches_of(engine, lambda: batch_streams(engine, base_specs))
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    grouped = launches_of(engine, lambda: batch_streams(
        engine, [(t, "t1") for t in SHORT_PROMPTS[:4]]))
    torch.cuda.synchronize()
    pool_alloc = torch.cuda.memory_allocated() - m0
    mixed_specs = [(SHORT_PROMPTS[0], "t1"), (SHORT_PROMPTS[1], None),
                   (SHORT_PROMPTS[2], "t2"), (SHORT_PROMPTS[3], "t3")]
    mixed = launches_of(engine, lambda: batch_streams(engine, mixed_specs))
    solos = [batch_streams(engine, [s])[0] for s in mixed_specs]
    base_after = batch_streams(engine, base_specs)
    base_bytes = quantized_bytes(engine.model)[0]
    counters = {k: getattr(engine, k) for k in (
        "adapter_installs", "adapter_evictions", "adapter_slots_in_use",
        "adapter_grouped_batches", "adapter_gathered_batches",
        "adapter_slot_bytes", "adapter_resident_bytes",
        "adapter_store_entries", "adapter_store_bytes_in_use")}
    # Decode at B = 8 with no adapter, one tenant and four (BGMV).
    decode = {}
    for mode, ctx in (("base", None),
                      ("grouped", engine.adapters.batch_params(slot=1)),
                      ("gathered", engine.adapters.batch_params(
                          rows=[1, 0, 2, 3, 1, 0, 2, 3]))):
        p = profile_decode(engine, lora=ctx)
        decode[mode] = {k: p[k] for k in ("wall_ms_per_step",
                                          "device_ms_per_step",
                                          "kernels_per_step")}
    # The eagerly merged reference of t1, from the served weights.
    state = {k: v.float() for k, v in engine.model.state_dict().items()}
    merged_model = get_model(engine.meta["config"]["model"],
                             **engine.meta["config"]["model_kwargs"],
                             seed=None)
    merged_model.load_state_dict(merge_adapter(state, payloads["t1"]))
    del state
    merged_model.configure(decode_attn_impl="flash")
    merged = TextGenerationEngine(merged_model, tokenizer=engine.tokenizer,
                                  kv_page_size=PAGE)
    with torch.inference_mode():
        reference = forced_run(merged, SHORT_PROMPTS, AGREE_NEW)
    agree, ties = pair_agreement(reference, engine, SHORT_PROMPTS,
                                 adapter="t1")
    controls = {name: pair_agreement(reference, engine, SHORT_PROMPTS,
                                     adapter=aid)[0]
                for name, aid in (("base", None), ("other_adapter", "t2"))}
    limit = SLOTS_AGREE[model]
    http_row = None
    if http_leg:
        led = TenantLedger(weights={"acme": 2.0})
        want_http = engine.generate_text(SHORT_PROMPTS[5], max_new_tokens=16,
                                         adapter="t2")["token_ids"]
        with BackgroundServer(build_app(engine, tenants=led)) as srv:
            got_http = json.loads(post(srv.port, {
                "text": SHORT_PROMPTS[5], "max_new_tokens": 16,
                "adapter": "t2", "tenant": "acme"}))["token_ids"]
            unknown, _ = http(srv.port, "POST", "/generate", json.dumps(
                {"text": "x", "adapter": "nobody"}).encode())
            metrics = get(srv.port, "/metrics")
        http_row = {"equal_engine": got_http == want_http,
                    "unknown_adapter_status": unknown,
                    "metrics_adapter_installs":
                    metrics["counters"]["generate.adapter_installs"]}
    row = {
        "case": "adapters", "model": model, "kv_page_size": PAGE,
        "rank": ADAPTER_RANK, "slots": ADAPTER_SLOTS, **counters,
        "slot_bytes_closed_form": slot_closed, "base_bytes": base_bytes,
        "first_install_pool_alloc_bytes": pool_alloc,
        "pool_bytes_closed_form": (ADAPTER_SLOTS + 1) * slot_closed,
        "launches": {"base": base["launches"], "grouped": grouped["launches"],
                     "mixed": mixed["launches"]},
        "launches_per_decode_step": {"base": base["per_step"],
                                     "grouped": grouped["per_step"],
                                     "mixed": mixed["per_step"]},
        # bf16: the gathered products round otherwise than the grouped
        # ones, so rows may drift from their solo streams (exact at f32:
        # adapters_f32_leg).
        "mixed_rows_equal_solos": [m == s for m, s in
                                   zip(mixed["out"], solos)],
        "mixed_vs_solo_token_agreement": sum(
            a == b for m, s in zip(mixed["out"], solos)
            for a, b in zip(m, s)) / sum(len(m) for m in mixed["out"]),
        "base_unchanged_after_adapters": base_after == base["out"],
        "adapter_bites": grouped["out"][0] != base["out"][0],
        # The gathered path: each adapter row apart from its base stream.
        "mixed_adapter_rows_differ_from_base": [
            mixed["out"][i] != base["out"][i] for i in (0, 2, 3)],
        "top1_agreement_with_merged": agree, "disagreements": ties,
        "controls": controls, "limit": limit,
        "http": http_row, "decode_b8": decode, "card": power,
    }
    emit(row)
    ok = (counters["adapter_slot_bytes"] == slot_closed
          and counters["adapter_resident_bytes"]
          == base_bytes + 3 * slot_closed
          and counters["adapter_installs"] == 3
          # grouped: the t1 batch and the three adapter solos
          and (counters["adapter_grouped_batches"],
               counters["adapter_gathered_batches"]) == (4, 1)
          and all(r["launches"] == r["want"] for r in (base, grouped, mixed))
          and base["per_step"] == grouped["per_step"] == mixed["per_step"]
          and row["base_unchanged_after_adapters"] and row["adapter_bites"]
          and all(row["mixed_adapter_rows_differ_from_base"])
          and agree >= limit and all(c < limit for c in controls.values())
          and (http_row is None or (http_row["equal_engine"]
                                    and http_row["unknown_adapter_status"]
                                    == 404)))
    if not ok:
        raise SystemExit(f"{model} adapters failed: {row}")
    del engine, merged, merged_model
    torch.cuda.empty_cache()
    return {f"adapters {model} page {PAGE} {kind}": r["launches"]
            for kind, r in (("base", base), ("grouped", grouped),
                            ("mixed", mixed))}


def adapters_f32_leg(power) -> None:
    """(b) at float32 on small models (a GPT of 2 heads of 64, a Llama of
    4 heads on 2 KV heads of 32): the slot path's grouped streams equal
    the eagerly merged engine's, and a mixed batch (two tenants and a
    base row) equals each row solo, exactly, contiguous and paged 16."""
    import torch

    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.models.lora import merge_adapter
    from mlapi_tpu_torch.serving.engine import TextGenerationEngine
    from mlapi_tpu_torch.text import ByteTokenizer

    results = {}
    for family, kw in (("gpt_lm", {"num_heads": 2}),
                       ("llama_lm", {"num_heads": 4, "num_kv_heads": 2,
                                     "intermediate_size": 256})):
        cfg = dict(vocab_size=260, hidden_size=128, num_layers=2,
                   max_positions=256, compute_dtype="float32", **kw)
        model = get_model(family, **cfg, seed=1)
        with torch.no_grad():    # sharper logits than the 0.02 init
            for p in model.parameters():
                if p.ndim == 2:
                    p.mul_(10.0)
        model.configure(decode_attn_impl="flash")
        payloads = {aid: seeded_adapter(cfg, 200 + i, rank=4, b_scale=0.5)
                    for i, aid in enumerate(ADAPTER_IDS[:2])}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        for page in (None, PAGE):
            eng = TextGenerationEngine(model, tokenizer=ByteTokenizer(),
                                       kv_page_size=page, adapter_slots=2)
            for aid, payload in payloads.items():
                eng.register_adapter(aid, payload)
            specs = [(SHORT_PROMPTS[0], "t1"), (SHORT_PROMPTS[1], None),
                     (SHORT_PROMPTS[2], "t2")]
            mixed = batch_streams(eng, specs)
            solos = [batch_streams(eng, [s])[0] for s in specs]
            base0 = batch_streams(eng, [(SHORT_PROMPTS[0], None)])[0]
            mm = get_model(family, **cfg, seed=None)
            mm.load_state_dict(merge_adapter(state, payloads["t1"]))
            mm.configure(decode_attn_impl="flash")
            ref = batch_streams(TextGenerationEngine(
                mm, tokenizer=ByteTokenizer(), kv_page_size=page),
                [(SHORT_PROMPTS[0], None)])[0]
            results[f"{family} page {page}"] = {
                "mixed_equals_solos": mixed == solos,
                "slot_equals_merged": solos[0] == ref,
                "adapter_bites": solos[0] != base0}
    emit({"case": "adapters_f32", "results": results, "card": power})
    if not all(all(v.values()) for v in results.values()):
        raise SystemExit(f"f32 adapter streams differ: {results}")


def item5_serving(ckpt: Path, cfg: dict, model: str, work: Path, power,
                  http_leg: bool = False) -> dict:
    """Phase 12 (a) and (b) at one width; returns launches by path."""
    t0 = time.perf_counter()
    paths = weights_leg(ckpt, cfg, model, power)
    t1 = time.perf_counter()
    paths.update(adapters_leg(ckpt, cfg, model, work, power, http_leg))
    emit({"case": "item5_seconds", "model": model, "weights": t1 - t0,
          "adapters": time.perf_counter() - t1})
    return paths


def lora_leg(sst2_ckpt: Path, train_row: dict, train_profile: dict,
             work: Path, power, cfg=None) -> dict:
    """(c) ``--preset sst2-bert --init-from <phase 4's checkpoint>
    --lora-rank 8`` through the train CLI's ``run`` for LORA_STEPS steps
    with flash attention, counters zeroed just before and read just
    after: B5 12 a step and per eval batch; B6 and B7 11 a step (layer
    0's attention inputs need no gradient: the frozen embeddings feed
    it, and BERT's q/k/v carry no adapter), all ``mma``. The merged
    checkpoint: every leaf without an adapter bit-equal to the init, each
    adapted kernel the init plus a rank-8 matrix; optimizer moments
    exactly twice the adapters' f32 bytes; wall ms per step and profiled
    device ms per step beside the full fine-tune's (phase 4); then the
    merged checkpoint served on ``/predict`` through B5. Returns the
    launches by path."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.config import get_preset
    from mlapi_tpu_torch.datasets import get_dataset
    from mlapi_tpu_torch.models import get_model
    from mlapi_tpu_torch.models.lora import LoraModel
    from mlapi_tpu_torch.train.__main__ import run
    from mlapi_tpu_torch.train.loop import _make_optimizer, make_train_step

    cfg = dataclasses.replace(cfg or get_preset("sst2-bert"),
                              steps=LORA_STEPS)
    out = work / "sst2-bert-lora8"
    zero_counters()
    t0 = time.perf_counter()
    summary = run(cfg, str(out), init_from=str(sst2_ckpt),
                  lora_rank=ADAPTER_RANK)
    run_s = time.perf_counter() - t0
    launches, bodies = read_counters()
    model = get_model(cfg.model, **cfg.model_kwargs, seed=None, device="cpu")
    init, _ = load_checkpoint(sst2_ckpt, model)
    merged, meta = load_checkpoint(out, model)
    layers, h = model.num_layers, model.hidden_size
    inter = model.layer(0).ffn_up.kernel.shape[1]
    adapted = {f"layer_{n}.{t}.kernel" for n in range(layers)
               for t in ("attn_out", "ffn_up", "ffn_down")}
    frozen_equal = all(torch.equal(merged[k], init[k])
                       for k in init if k not in adapted)
    ranks = []
    for k in sorted(adapted):
        s = torch.linalg.svdvals((merged[k] - init[k]).double())
        ranks.append(float(s[ADAPTER_RANK] / s[0]))
    adapter_f32 = 4 * ADAPTER_RANK * layers * (
        (h + h) + (h + inter) + (inter + h))
    splits = get_dataset(cfg.dataset, **cfg.dataset_kwargs)
    eval_batches = math.ceil(len(splits.x_test) / 4096)
    want = {k: 0 for k in KERNELS}
    want.update(flash_forward=layers * (LORA_STEPS + eval_batches),
                flash_backward_dq=(layers - 1) * LORA_STEPS,
                flash_backward_dkv=(layers - 1) * LORA_STEPS)
    # Device ms per step of the same LoRA step (the train CLI's).
    lora = LoraModel(get_model(cfg.model, **cfg.model_kwargs, seed=None),
                     rank=ADAPTER_RANK,
                     seed=cfg.seed)
    lora.base.load_state_dict(init)
    every = dict(lora.named_parameters())
    trainable = [p for n, p in every.items() if n.startswith("lora.")]
    for p in trainable:
        p.requires_grad_(True)
    opt = _make_optimizer(cfg.optimizer, cfg.learning_rate, trainable)
    step = make_train_step(lora.apply, every, opt,
                           weight_decay=cfg.weight_decay)
    n = len(splits.x_train)
    batches = []
    for i in range(3):
        idx = np.random.default_rng((cfg.seed, i)).choice(
            n, size=cfg.batch_size, replace=False)
        batches.append(batch_tensors(splits.x_train[idx],
                                     splits.y_train[idx]))
    for b in batches:                                   # warm
        float(step(*b))
    device_ms = profiled_steps_ms(step, batches)
    del lora, opt, step
    torch.cuda.empty_cache()
    wall = statistics.median(summary["step_ms"][2:])
    row = {
        "case": "lora_sst2_bert", "rank": ADAPTER_RANK, "steps": LORA_STEPS,
        "final_loss": summary["final_loss"],
        "test_accuracy": summary["test_accuracy"],
        "launches": launches, "launches_expected": want, "bodies": bodies,
        "frozen_leaves_bit_equal": frozen_equal,
        "adapted_kernels": len(adapted),
        "max_sv_ratio_past_rank": max(ranks),
        "opt_state_bytes": summary["opt_state_bytes"],
        "adapter_f32_bytes": adapter_f32,
        "wall_ms_per_step": {"lora_median": wall,
                             "full_median_last_20":
                             train_row["wall_ms_per_step"]["median_last_20"]},
        "device_ms_per_step": {"lora": device_ms,
                               "full": train_profile["device_ms_per_step"]},
        "run_seconds": run_s, "card": power,
    }
    emit(row)
    want_bodies = {k: {"mma": want[k], "fma": 0} for k in FLASH}
    if not (launches == want and bodies == want_bodies and frozen_equal
            and max(ranks) < 1e-2
            and summary["opt_state_bytes"] == 2 * adapter_f32
            and math.isfinite(summary["final_loss"])):
        raise SystemExit(f"sst2-bert LoRA failed: {row}")
    paths = {f"train sst2-bert --lora-rank {ADAPTER_RANK}, {LORA_STEPS} "
             "steps + test eval": launches}
    paths["/predict sst2-bert LoRA-merged"] = predict_leg(out, None, power)
    return paths


def predict_leg(ckpt: Path, quantize, power) -> dict:
    """A sst2-bert checkpoint served through the CLI's engine factory
    (``quantize``: None or "int8") and the HTTP app: LORA_TEXTS
    concurrent ``/predict`` texts, B5 exactly one launch a layer per
    device call, all ``mma``; with int8 weights, the labels beside the
    float engine's (near ties listed) and the weight bytes on the card
    against ``quantized_bytes``. Returns the launches."""
    import numpy as np
    import torch

    from mlapi_tpu_torch.ops.quant import quantized_bytes
    from mlapi_tpu_torch.serving.__main__ import build_engine
    from mlapi_tpu_torch.serving.app import build_app
    from mlapi_tpu_torch.serving.engine import TextClassificationEngine
    from mlapi_tpu_torch.serving.server import BackgroundServer

    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    engine = build_engine(ckpt, quantize=quantize)
    torch.cuda.synchronize()
    on_card = torch.cuda.memory_allocated() - m0
    if not isinstance(engine, TextClassificationEngine):
        raise SystemExit(f"sst2-bert served by {type(engine).__name__}")
    texts = sst2_texts(LORA_TEXTS, seed=7)
    app = build_app(engine)
    with BackgroundServer(app) as srv:
        sp = app.state["batcher"]
        calls0 = sp.device_calls
        zero_counters()
        answers = at_once(lambda t: predict(srv.port, {"text": t}), texts)
        launches, bodies = read_counters()
        calls = sp.device_calls - calls0
    want = {k: 0 for k in KERNELS}
    want["flash_forward"] = engine.model.num_layers * calls
    row = {"case": "predict_sst2_bert", "checkpoint": ckpt.name,
           "quantized": engine.meta.get("quantized"), "texts": len(texts),
           "device_calls": calls, "launches": launches,
           "launches_expected": want, "bodies": bodies, "card": power}
    if quantize:
        stored = quantized_bytes(engine.model)[0]
        ref = build_engine(ckpt)
        rows = np.stack([engine.encode(t) for t in texts])
        want_ids, want_p = ref.predict(rows)
        got = [engine.vocab.labels.index(a["prediction"]) for a in answers]
        differ = [i for i in range(len(texts)) if got[i] != want_ids[i]]
        row.update(weight_bytes_on_card=on_card, quantized_bytes_stored=stored,
                   allocator_bound=allocator_bound(engine.model),
                   labels_equal_float=len(texts) - len(differ),
                   label_changes=[{"row": i, "float_max_prob":
                                   float(want_p[i])} for i in differ])
        del ref
    emit(row)
    if launches != want or bodies["flash_forward"] != {
            "mma": want["flash_forward"], "fma": 0}:
        raise SystemExit(f"sst2-bert /predict ({quantize}): {row}")
    if quantize and not (row["quantized_bytes_stored"] <= on_card
                         <= row["allocator_bound"]):
        raise SystemExit(f"sst2-bert int8 weights: {row}")
    del engine
    torch.cuda.empty_cache()
    return launches


# -- 13. speculative decoding -----------------------------------------------

# HuggingFace ``distilgpt2`` (config.json: n_layer 6, n_embd 768, n_head
# 12, n_positions 1024, vocab_size 50257): GPT-2 small's width at half
# its depth.
DISTILGPT2 = dict(GPT2_SMALL, num_layers=6)
SPEC_K = 4                      # the engine's default proposals a round
# New tokens of a solo spec stream: with draft == target the 35 after
# the first are 7 rounds of k + 1 (the budget ends on a round).
SPEC_NEW = 36
SPEC_SOLO = ["Speculative decoding drafts k tokens, ",
             "and the target verifies them in one block. ",
             "A rejected proposal leaves stale slots behind, ",
             "masked until the next round writes them. "]
# Batches of (text, new tokens). With draft == target a round emits
# k + 1 = 5 tokens: rows of 86 and 6 new tokens finish after 17 and 1
# rounds, leaving the short rows 80 slots behind (5 pages of 16: the
# paged handoff is a table shift); rows of 16, 6 and 11 finish after 3,
# 1 and 2 rounds, 10 and 5 slots behind (a repack). A draft that accepts
# nothing leaves the same gaps (one token a round).
SPEC_BATCHES = (
    (("row a", 86), ("row b", 6), ("row c", 86), ("row d", 6)),
    (("row e", 16), ("row f", 6), ("row g", 11), ("row h", 16)),
)
SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_realign_table_ops", "spec_realign_repacks",
                 "brownout_spec_suppressed", "sched_units_spec")
# The trained pair's prompts: the docs corpus's own register.
DOCS_PROMPTS = ["The serving engine ", "A checkpoint directory holds ",
                "The unit scheduler "]
DOCS_NEW = 64


def dtype_variant(src: Path, dst: Path, dtype: str) -> Path:
    """``src``'s checkpoint under a manifest whose model computes in
    ``dtype``: the same weights (``params.npz`` hard-linked)."""
    dst.mkdir(parents=True, exist_ok=True)
    os.link(src / "params.npz", dst / "params.npz")
    manifest = json.loads((src / "MANIFEST.json").read_text())
    manifest["config"]["model_kwargs"]["compute_dtype"] = dtype
    (dst / "MANIFEST.json").write_text(json.dumps(manifest))
    return dst


def spec_checkpoints(ckpt: Path, tmp: Path) -> dict:
    """GPT-2 small (``ckpt``, bf16) and a DistilGPT2-width draft drawn
    from seed 1, each with a bf16 and an f32 manifest."""
    from mlapi_tpu_torch.checkpoint import save_checkpoint
    from mlapi_tpu_torch.models.gpt import GptLM
    from mlapi_tpu_torch.text import ByteTokenizer

    draft = save_checkpoint(
        tmp / "distilgpt2_seed1", GptLM(**DISTILGPT2, seed=1, device="cpu"),
        config={"model": "gpt_lm", "model_kwargs": DISTILGPT2,
                "tokenizer": ByteTokenizer().fingerprint()})
    return {"gpt2": {"bfloat16": ckpt,
                     "float32": dtype_variant(ckpt, tmp / "gpt2_f32",
                                              "float32")},
            "distilgpt2": {"bfloat16": draft,
                           "float32": dtype_variant(
                               draft, tmp / "distilgpt2_f32", "float32")}}


class SpecCalls:
    """Count the target's and the draft's cache calls (each decode step
    launches B1 / B3 once a layer, each block B2 / B4), and with ``log``
    keep the target's logits by effective query position (batch row 0:
    solo runs), so two runs can be held position by position."""

    def __init__(self, engine, log: bool = False):
        self.engine = engine
        self.calls = {"t_decode": 0, "t_extend": 0, "d_decode": 0,
                      "d_extend": 0}
        self.logits: dict | None = {} if log else None
        models = [("t", engine.model)]
        if engine.draft_model is not None:
            models.append(("d", engine.draft_model))
        for who, model in models:
            self._wrap(model, who, "decode", "decode_step")
            self._wrap(model, who, "extend", "extend_core")

    def _wrap(self, model, who, kind, attr):
        fn = getattr(model, attr)
        key = f"{who}_{kind}"
        keep = self.logits is not None and who == "t"

        def counted(*args, **kwargs):
            self.calls[key] += 1
            out = fn(*args, **kwargs)
            if keep:
                self._keep(kind, args, kwargs, out)
            return out

        setattr(model, attr, counted)

    def _keep(self, kind, args, kwargs, out):
        pos, n_pad = args[2], args[3] if len(args) > 3 else None
        pad = 0 if n_pad is None else int(n_pad[0])
        p0 = int(pos[0]) if hasattr(pos, "ndim") and pos.ndim else int(pos)
        if kind == "decode":
            self.logits[p0 - pad] = out[0][0].float()
        elif kwargs.get("all_logits"):
            for i in range(out[1].shape[1]):
                self.logits[p0 + i - pad] = out[1][0, i].float()

    def undo(self):
        for model in (self.engine.model, self.engine.draft_model):
            if model is not None:
                for attr in ("decode_step", "extend_core"):
                    model.__dict__.pop(attr, None)

    def want(self) -> dict:
        """Each kernel's launches these calls need: the target's through
        its layout's kernels, the draft's (a contiguous cache) through
        B1 / B2."""
        eng, c = self.engine, self.calls
        paged = "paged_" if eng.pool is not None else ""
        want = {k: 0 for k in KERNELS}
        tl = eng.model.num_layers
        want[paged + "decode_attention"] += tl * c["t_decode"]
        want[paged + "extend_attention"] += tl * c["t_extend"]
        if eng.draft_model is not None:
            dl = eng.draft_model.num_layers
            want["decode_attention"] += dl * c["d_decode"]
            want["extend_attention"] += dl * c["d_extend"]
        return want


def spec_batch(engine, specs) -> list:
    """One formed greedy batch of ``(text, new tokens)`` rows through the
    engine's ``_run_batch``: every row's stream."""
    from mlapi_tpu_torch.serving.requests import _SyncSink

    outs = [[] for _ in specs]
    sinks = [_SyncSink(engine._encode(t, n, 0.0, 0, None), out)
             for (t, n), out in zip(specs, outs)]
    engine._run_batch(sinks)
    errors = [s.error for s in sinks if s.error is not None]
    if errors:
        raise SystemExit(f"spec batch failed: {errors[0]!r}")
    return outs


def spec_counts(engine) -> dict:
    return {c: getattr(engine, c) for c in SPEC_COUNTERS}


def spec_delta(engine, before: dict) -> dict:
    now = spec_counts(engine)
    d = {c: now[c] - before[c] for c in now}
    d["acceptance"] = (d["spec_accepted"] / d["spec_drafted"]
                       if d["spec_drafted"] else None)
    return d


def solo_ms(engine, text: str, n: int, runs: int = 3) -> dict:
    """Batch 1: wall ms per emitted token (median of ``runs`` generations
    after a warm one) and device ms per emitted token (one generation
    under ``torch.profiler``, its kernels and copies), with the
    speculation counters of the timed runs."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.generate_text(text, max_new_tokens=n)
    before = spec_counts(engine)
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate_text(text, max_new_tokens=n)["token_ids"]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / len(out))
    counts = spec_delta(engine, before)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate_text(text, max_new_tokens=n)
        torch.cuda.synchronize()
    dev = sum(e.device_time_total for e in device_kernels(prof)) / 1e3
    rounds = counts["spec_rounds"]
    return {"wall_ms_per_token": statistics.median(walls),
            "wall_ms_per_token_runs": walls,
            "device_ms_per_token": dev / n,
            "tokens_per_round": ((counts["spec_accepted"] + rounds) / rounds
                                 if rounds else None),
            "acceptance": counts["acceptance"], "rounds": rounds}


def spec_exact_leg(ckpts: dict, power) -> dict:
    """(a) GPT-2 small at its full width in f32, contiguous f32 and paged
    16 int8 caches: with draft == target and with the DistilGPT2-width
    draft, solo and batched streams equal the target-only engine's token
    for token; draft == target accepts every proposal; the paged
    batches realign both ways (a table shift and a repack); launches
    exact; batch-1 ms per token beside the target alone (contiguous).
    The DistilGPT2-width draft, which random weights leave at one token
    a round, runs one solo stream and the repack batch. Returns launches
    by path."""
    import gc

    import torch

    from mlapi_tpu_torch.serving.__main__ import build_engine

    target = ckpts["gpt2"]["float32"]
    paths = {}
    for kv_quant, page in ((None, None), ("int8", PAGE)):
        layout = (kv_quant or "f32") + (f", page {page}" if page else "")
        kw = dict(kv_quant=kv_quant, decode_attn_impl="flash",
                  kv_page_size=page)
        plain = build_engine(target, **kw)
        ref_solo = [plain.generate_text(t, max_new_tokens=SPEC_NEW)[
            "token_ids"] for t in SPEC_SOLO[:2]]
        ref_batches = [spec_batch(plain, b) for b in SPEC_BATCHES]
        timing_plain = (solo_ms(plain, SPEC_SOLO[0], SPEC_NEW)
                        if page is None else None)
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        for dname in ("gpt2", "distilgpt2"):
            same = dname == "gpt2"
            n_solo = 2 if same else 1
            batch_ids = (0, 1) if same else (1,)
            t0 = time.perf_counter()
            engine = build_engine(target, **kw,
                                  draft_checkpoint=ckpts[dname]["float32"])
            load_s = time.perf_counter() - t0
            calls = SpecCalls(engine)
            before = spec_counts(engine)
            zero_counters()
            solo = [engine.generate_text(t, max_new_tokens=SPEC_NEW)[
                "token_ids"] for t in SPEC_SOLO[:n_solo]]
            solo_counts = spec_delta(engine, before)
            batches = [spec_batch(engine, SPEC_BATCHES[i])
                       for i in batch_ids]
            torch.cuda.synchronize()
            launches, bodies = read_counters(SERVING)
            calls.undo()
            want = calls.want()
            counts = spec_delta(engine, before)
            timing = (solo_ms(engine, SPEC_SOLO[0], SPEC_NEW)
                      if page is None else None)
            path = f"spec f32 {layout}, draft {dname}"
            paths[path] = launches
            row = {
                "case": "spec_exact", "layout": layout,
                "draft": "gpt2-small (draft == target)" if same
                else "distilgpt2 width, seed 1",
                "k": engine.spec_k, "new_tokens": SPEC_NEW,
                "batches": [[n for _, n in SPEC_BATCHES[i]]
                            for i in batch_ids],
                "solo_equal": solo == ref_solo[:n_solo],
                "batch_equal": batches == [ref_batches[i]
                                           for i in batch_ids],
                "counters": counts, "solo_counters": solo_counts,
                "launches": launches, "want": want, "bodies": bodies,
                "calls": calls.calls, "load_seconds": load_s,
                "batch1_ms": {"spec": timing, "plain": timing_plain},
                "card": power,
            }
            emit(row)
            fails = []
            if not (row["solo_equal"] and row["batch_equal"]):
                fails.append("a stream differs from the target-only "
                             "engine's")
            if same and counts["spec_accepted"] != counts["spec_drafted"]:
                fails.append("draft == target rejected a proposal")
            if same and (solo_counts["spec_accepted"]
                         + solo_counts["spec_rounds"] != 2 * (SPEC_NEW - 1)
                         or solo_counts["spec_accepted"]
                         != SPEC_K * solo_counts["spec_rounds"]):
                # Every solo token after the first came from a round of
                # k + 1.
                fails.append(f"solo rows left the rounds: {solo_counts}")
            if counts["spec_rounds"] == 0:
                fails.append("no speculative round ran")
            if page and same and not (counts["spec_realign_table_ops"]
                                      and counts["spec_realign_repacks"]):
                fails.append("the paged handoff did not realign both ways")
            if launches != want:
                fails.append(f"launches {launches}, want {want}")
            if not (launches["decode_attention"] and launches[
                    ("paged_" if page else "") + "extend_attention"]):
                fails.append("B1 or the verify kernel never launched")
            if fails:
                raise SystemExit(f"spec exact leg ({path}): {fails}")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    return paths


def spec_tie_check(spec_log: dict, plain_log: dict, got, ref, used: int):
    """Fault C3's rule on one solo stream pair: at the first position
    where they disagree, the plain run's top-1 - top-2 margin must be
    below the largest |spec - plain| logit difference there (both runs
    saw the same tokens before it). ``None`` when the streams agree."""
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
    if j is None:
        return None
    if j == 0:
        return {"pos": 0, "tie": False, "why": "the first token differs"}
    e = used - 1 + j
    p, s = plain_log[e], spec_log[e]
    top2 = p.topk(2).values
    margin = float(top2[0] - top2[1])
    diff = float((s - p).abs().max())
    return {"pos": j, "margin": margin, "max_abs_diff": diff,
            "tie": margin < diff}


def spec_bf16_leg(ckpts: dict, power, then=None) -> dict:
    """(b) GPT-2 small in bf16, contiguous bf16 and paged 16 int8, draft
    == target: each solo spec stream held to the target-only engine's by
    fault C3's tie rule (:func:`spec_tie_check`); acceptance and tokens
    a round printed. ``then(engine)`` runs on the contiguous spec engine
    (the scheduler and brownout leg) and returns its launches by path.
    Returns launches by path."""
    import gc

    import torch

    from mlapi_tpu_torch.serving.__main__ import build_engine

    target = ckpts["gpt2"]["bfloat16"]
    paths = {}
    for kv_quant, page in ((None, None), ("int8", PAGE)):
        layout = (kv_quant or "bf16") + (f", page {page}" if page else "")
        kw = dict(kv_quant=kv_quant, decode_attn_impl="flash",
                  kv_page_size=page)
        plain = build_engine(target, **kw)
        plain_calls = SpecCalls(plain, log=True)
        refs = []
        for text in SPEC_SOLO:
            plain_calls.logits.clear()
            out = plain.generate_text(text, max_new_tokens=SPEC_NEW)
            refs.append((out["token_ids"], dict(plain_calls.logits)))
        plain_calls.undo()
        engine = build_engine(target, **kw, draft_checkpoint=target)
        calls = SpecCalls(engine, log=True)
        before = spec_counts(engine)
        zero_counters()
        checks = []
        for text, (ref, ref_log) in zip(SPEC_SOLO, refs):
            calls.logits.clear()
            got = engine.generate_text(text, max_new_tokens=SPEC_NEW)[
                "token_ids"]
            tie = spec_tie_check(calls.logits, ref_log, got, ref, len(text))
            checks.append({"text": text, "equal": got == ref,
                           "agreement": sum(a == b for a, b in
                                            zip(got, ref)) / len(ref),
                           "first_disagreement": tie})
        torch.cuda.synchronize()
        launches, bodies = read_counters(SERVING)
        calls.undo()
        want = calls.want()
        counts = spec_delta(engine, before)
        path = f"spec bf16 {layout}, draft == target"
        paths[path] = launches
        rounds = counts["spec_rounds"]
        row = {"case": "spec_bf16", "layout": layout, "k": engine.spec_k,
               "new_tokens": SPEC_NEW, "streams": checks,
               "all_ties": all(c["first_disagreement"] is None
                               or c["first_disagreement"]["tie"]
                               for c in checks),
               "counters": counts,
               "tokens_per_round": ((counts["spec_accepted"] + rounds)
                                    / rounds if rounds else None),
               "launches": launches, "want": want, "bodies": bodies,
               "card": power}
        emit(row)
        if not row["all_ties"] or launches != want or not rounds:
            raise SystemExit(f"spec bf16 leg ({path}): ties "
                             f"{row['all_ties']}, rounds {rounds}, "
                             f"launches {launches}, want {want}")
        if then is not None and page is None:
            paths.update(then(engine))
        del plain, engine, refs
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def spec_sched_leg(engine, power) -> dict:
    """(d) The unit scheduler at 2 lanes: a solo spec row (the first
    :data:`SPEC_SOLO` prompt, 64 new tokens) and, once its first token
    is out, a window-incompatible long prompt (a second lane). The spec
    phase yields at a round boundary while the other lane has work
    (spec units of the row with the other lane's units between them)
    and re-engages; both streams run to their budgets and the launches
    are exact (bf16: the stream is held to nothing finer). Then at
    brownout rung 1 (the fleet backlog at the queue bound) a greedy run
    speculates not at all and ``brownout_spec_suppressed`` ticks once.
    Returns launches by path."""
    n = 64
    # Past the window beside the spec row (bucket + 64 new tokens), so it
    # forms a lane of its own.
    long_text = text_of(engine.model.max_positions - 32, "lane two")

    async def body(loop):
        (first,) = enqueue(engine, loop, [(SPEC_SOLO[0], n, None)])
        head = await first.queue.get()
        (second,) = enqueue(engine, loop, [(long_text, 16, None)])
        outs = [await collect_timed(r, time.perf_counter())
                for r in (first, second)]
        if any(e is not None for _, e, _, _ in outs):
            raise SystemExit(f"spec sched leg: {[o[1] for o in outs]}")
        await wait_until(lambda: engine.sched.batches_live == 0)
        return (head["token_ids"] + outs[0][0], outs[1][0],
                list(engine.sched.trace))

    before = spec_counts(engine)
    calls = SpecCalls(engine)
    zero_counters()
    got, other, trace = engine_run(engine, 2, body)
    launches = read_counters(SERVING)[0]
    calls.undo()
    counts = spec_delta(engine, before)
    lanes = [lane for lane, kind in trace if kind == "spec"]
    spec_lane = lanes[0] if lanes else None
    idx = [i for i, (lane, kind) in enumerate(trace)
           if lane == spec_lane and kind == "spec"]
    between = (len(idx) >= 2 and any(
        lane != spec_lane for lane, _ in trace[idx[0] + 1:idx[-1]]))
    engine.router_queue_depth = engine.max_queue
    b0 = spec_counts(engine)
    engine.generate_text(SPEC_SOLO[1], max_new_tokens=16)
    brown = spec_delta(engine, b0)
    engine.router_queue_depth = 0
    row = {"case": "spec_sched", "lanes": 2, "new_tokens": n,
           "spec_units_of_the_row": len(idx),
           "other_lane_between_spec_units": between,
           "counters": counts, "brownout": brown,
           "launches": launches, "want": calls.want(), "card": power}
    emit(row)
    fails = []
    if not counts["sched_units_spec"] or not counts["spec_rounds"]:
        fails.append("no spec unit ran")
    if not between:
        fails.append("the spec phase never yielded to the other lane")
    if brown["brownout_spec_suppressed"] != 1 or brown["spec_rounds"]:
        fails.append(f"brownout: {brown}")
    if len(got) != n or len(other) != 16 or launches != calls.want():
        fails.append(f"lengths {len(got)}, {len(other)}; launches "
                     f"{launches}, want {calls.want()}")
    if fails:
        raise SystemExit(f"spec sched leg: {fails}")
    return {"spec sched bf16, 2 lanes": launches}


def spec_trained_leg(work: Path, power) -> dict:
    """(c) The trained pair: ``docs-gpt`` served with phase 11's
    ``docs-gpt-draft-distilled`` and ``docs-gpt-draft`` as drafts
    (``--spec-sample``, f32): greedy streams equal the target-only
    engine's; a sampled solo run is the same for the same seed twice and
    another for another seed; acceptance, tokens a round, and wall and
    device ms per emitted token beside the target-only engine's at batch
    1. Returns launches by path."""
    import gc

    import torch

    from mlapi_tpu_torch.serving.__main__ import build_engine

    target = work / "docs-gpt"
    plain = build_engine(target, decode_attn_impl="flash")
    refs = [plain.generate_text(t, max_new_tokens=DOCS_NEW)["token_ids"]
            for t in DOCS_PROMPTS]
    timing_plain = solo_ms(plain, DOCS_PROMPTS[0], DOCS_NEW)
    del plain
    paths = {}
    sampling = dict(temperature=0.8, top_k=40, top_p=0.95)
    for dname in ("docs-gpt-draft-distilled", "docs-gpt-draft"):
        engine = build_engine(target, decode_attn_impl="flash",
                              draft_checkpoint=work / dname,
                              spec_sample=True)
        calls = SpecCalls(engine)
        before = spec_counts(engine)
        zero_counters()
        got = [engine.generate_text(t, max_new_tokens=DOCS_NEW)[
            "token_ids"] for t in DOCS_PROMPTS]
        greedy = spec_delta(engine, before)
        b1 = spec_counts(engine)
        sampled = [engine.generate_text(DOCS_PROMPTS[0],
                                        max_new_tokens=DOCS_NEW, seed=s,
                                        **sampling)["token_ids"]
                   for s in (3, 3, 4)]
        sampled_counts = spec_delta(engine, b1)
        torch.cuda.synchronize()
        launches = read_counters(SERVING)[0]
        calls.undo()
        want = calls.want()
        timing = solo_ms(engine, DOCS_PROMPTS[0], DOCS_NEW)
        path = f"spec docs-gpt, draft {dname}"
        paths[path] = launches
        rounds = greedy["spec_rounds"]
        row = {"case": "spec_trained", "target": "docs-gpt",
               "draft": dname, "k": engine.spec_k,
               "greedy_equal": got == refs,
               "greedy_counters": greedy,
               "tokens_per_round": ((greedy["spec_accepted"] + rounds)
                                    / rounds if rounds else None),
               "sampled_same_seed_equal": sampled[0] == sampled[1],
               "sampled_other_seed_differs": sampled[0] != sampled[2],
               "sampled_counters": sampled_counts, "sampling": sampling,
               "batch1_ms": {"spec": timing, "plain": timing_plain},
               "launches": launches, "want": want, "card": power}
        emit(row)
        if (got != refs or sampled[0] != sampled[1]
                or sampled[0] == sampled[2] or not rounds
                or not sampled_counts["spec_rounds"] or launches != want):
            raise SystemExit(f"spec trained leg ({dname}): {row}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def check_spec_kernels(power) -> list:
    """(e) B2 and B4 at the verify block's shape (U = k + 1 = 5, B = 1
    and 4, rows at their own positions, L = 1024, GPT-2 heads, bf16 and
    int8) and B1 at the DistilGPT2-width draft's decode shape (its 12
    heads of 64; B = 1 in f32, the exact legs' format, and B = 4 in
    bf16), each against its plain version (:func:`kernel_row`)."""
    u = SPEC_K + 1
    shapes = []
    for name in ("extend_attention", "paged_extend_attention"):
        shapes.append((name, 1, u, 1024, [1019], ("bf16", "int8")))
        shapes.append((name, 4, u, 1024, [1019, 1012, 1003, 996],
                       ("bf16", "int8")))
    shapes.append(("decode_attention", 1, 1, 1024, [1023], ("f32",)))
    shapes.append(("decode_attention", 4, 1, 1024, [1023, 1016, 1007, 1000],
                   ("bf16",)))
    rows = []
    for i, (name, b, uu, length, pos, fmts) in enumerate(shapes):
        for fmt in fmts:
            def make(seed, name=name, fmt=fmt, b=b, uu=uu, length=length,
                     pos=pos):
                return kernel_case(name, fmt, b, uu, length, pos, seed=seed)

            rows.append(kernel_row(name, fmt, b, uu, length, pos, {}, make,
                                   500 + i, power, TOLERANCE[fmt],
                                   extra={"leg": "spec"}))
    return rows


def spec_gpt2_legs(ckpt: Path, tmp: Path, power) -> dict:
    """13 (a), (b) and (d) on the GPT-2 small checkpoint ``ckpt``: returns
    their launches by path."""
    ckpts = spec_checkpoints(ckpt, tmp)
    paths = spec_exact_leg(ckpts, power)
    paths.update(spec_bf16_leg(
        ckpts, power, then=lambda engine: spec_sched_leg(engine, power)))
    return paths


def spec_only(power) -> int:
    """``--only-spec``: phase 13 alone (its kernel rows, the GPT-2 legs,
    and the trained pair, trained here by phase 11's distillation leg),
    a rehearsal; it prints no result line."""
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=scratch, prefix="smoke_"))
    t0 = time.perf_counter()
    check_spec_kernels(power)
    stamps = {"kernels": time.perf_counter() - t0}
    try:
        ckpt = make_checkpoint(work / "gpt2_small_seed0")
        spec_gpt2_legs(ckpt, work, power)
        stamps["gpt2"] = time.perf_counter() - t0
        distill_leg(work, power)
        stamps["distill"] = time.perf_counter() - t0
        spec_trained_leg(work, power)
        stamps["trained"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"case": "phase_seconds", **stamps})
    return 0


def kernel_label(mangled: str) -> str:
    """``extend_mma_kernel<true, false>`` from the mangled name ptxas
    prints (the template arguments these sources use: bool, int, float,
    bf16)."""
    import re

    m = re.search(r"\d+([a-z][a-z_]*_kernel)I(.+?)EEvN", mangled)
    if not m:
        return mangled
    args = [
        {"Lb0E": "false", "Lb1E": "true", "f": "float",
         "13__nv_bfloat16": "bf16"}.get(a, a.strip("LiE"))
        for a in re.findall(r"Lb[01]E|Li\d+E|13__nv_bfloat16|f", m.group(2))
    ]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of every kernel in a ``ptxas -v`` log."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_store_bytes=int(st),
                             spill_load_bytes=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


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
    t_run = time.perf_counter()

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
          "libraries": sorted(built),
          "kernels": {name: ptxas_summary(b.log)
                      for name, b in built.items()}})
    if sys.argv[1:] == ["--only-spec"]:
        return spec_only(power)
    # Seconds of each phase, from the run's start.
    stamps = {}

    def mark(name):
        stamps[name] = time.perf_counter() - t_run

    # 3. kernels against their plain versions (and, for the prefix phase,
    # B1-B4 at its masks)
    rows = check_kernels(power)
    rows += check_prefix_kernels(power)
    rows += check_spec_kernels(power)
    cfg, splits, x0, y0 = sst2_first_batch()
    flash_rows = check_flash_kernels(power, x0)
    mark("3 kernels")

    # 4. training: the sst2-bert run through the train CLI's run(), the
    # flash-vs-full check, one profiled step
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    # What phase 10 serves again: the sst2-bert checkpoint, the servers'
    # logs, the Iris and Wide&Deep checkpoints; removed at the end.
    work = Path(tempfile.mkdtemp(dir=scratch, prefix="smoke_"))
    sst2_ckpt = work / "sst2-bert"
    train_row = train_run(cfg, splits, sst2_ckpt)
    flash_vs_full(cfg, x0, y0)
    train_profile = profile_train_step(cfg, splits)
    del splits
    torch.cuda.empty_cache()
    mark("4 training")

    # 5. serving, 6. correctness
    # Launches per serving path, each path's counts zeroed just before
    # its requests: {kernel: {"none": N, "int8": N, "none, page 16": N,
    # "int8, page 16": N, "prefix none": N, "prefix int8, page 16": N,
    # "llama none": N, "llama int8, page 16": N, "llama prefix none": N,
    # "llama prefix int8, page 16": N}}.
    launches = {name: {} for name in SERVING}
    phase14: dict = {}   # phase 14's seconds by engine
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        ckpt = make_checkpoint(Path(tmp) / "gpt2_small_seed0")
        for page in (None, PAGE):
            for kv_quant in (None, "int8"):
                row, engine = serve_run(ckpt, kv_quant, page)
                emit(row)
                path = row["kv_quant"] + (f", page {page}" if page else "")
                for k in launches:
                    launches[k][path] = row["launches"][k]
                profile_decode(engine)
                profile_prefill(engine)
                if page is None:
                    agreement(engine, kv_quant)
                if (page is None) == (kv_quant is None):
                    # 8. shared-prefix serving on contiguous bf16 and
                    # paged 16 int8, the Llama phase's layouts
                    prow = prefix_leg(engine, GPT2_SMALL, "gpt2-small",
                                      power)
                    for k in launches:
                        launches[k]["prefix " + path] = prow["launches"][k]
                    # 9. sampled tokens, then the unit scheduler
                    sampling_leg(engine, "gpt2-small", power)
                    srow = sched_leg(engine, GPT2_SMALL, "gpt2-small", power)
                    for k in launches:
                        launches[k]["sched " + path] = srow["launches"][k]
                    # 14. fused widths, then the host KV tier (a disk
                    # round trip beside the paged engine)
                    t14 = time.perf_counter()
                    frow = fused_leg(engine, GPT2_SMALL, "gpt2-small", power)
                    for k in launches:
                        launches[k]["fused " + path] = frow[k]
                    trows = tier_leg(engine, GPT2_SMALL, "gpt2-small", power,
                                     Path(tmp), ckpt if page else None)
                    for name, counts in trows.items():
                        for k in launches:
                            launches[k][f"{name} {path}"] = counts[k]
                    phase14[f"gpt2-small {path}"] = time.perf_counter() - t14
                del engine
                torch.cuda.empty_cache()
        mark("5-9 serving")
        # 10. the scoring path (the GPT-2 checkpoint is the co-resident
        # leg's default model)
        scoring = scoring_phase(ckpt, sst2_ckpt, x0, work, power)
        # 12 (a, b) at GPT-2 small: int8 weights, adapters over HTTP
        t12 = time.perf_counter()
        item5_paths = item5_serving(ckpt, GPT2_SMALL, "gpt2-small", work,
                                    power, http_leg=True)
        item5_seconds = time.perf_counter() - t12
        mark("10, 12a scoring, int8 weights")
        # 13 (a, b, d): speculative decoding at GPT-2 small's width
        spec_paths = spec_gpt2_legs(ckpt, Path(tmp), power)
        mark("13 speculation at GPT-2 width")
    check_small_f32(2)
    check_small_f32(4)     # docs-gpt: head dim 32
    check_prefix_f32("gpt_lm", 2)

    # 7. Llama: TinyLlama-1.1B-width serving, flash against full, small
    # f32 streams, the docs-llama training run
    # (and 12 (a, b) at TinyLlama's width on its checkpoint)
    def tinyllama_item5(llama_ckpt):
        item5_paths.update(item5_serving(llama_ckpt, TINYLLAMA,
                                         "tinyllama-1.1b", work, power))
        # 14 (b) at TinyLlama's width: one restore on paged 16 int8
        t14 = time.perf_counter()
        tier_llama_leg(llama_ckpt, power)
        phase14["tinyllama-1.1b int8, page 16"] = time.perf_counter() - t14

    llama_train = llama_phases(scratch, launches, power,
                               then=tinyllama_item5)
    mark("7 llama")
    emit({"case": "phase14_seconds", **phase14,
          "total": sum(phase14.values())})

    # 11. the rest of training: kill and resume, distillation,
    # criteo-widedeep, bench rows, debug checks and a profile
    training = rest_of_training(train_row, sst2_ckpt, work, power)
    mark("11 rest of training")
    # 13 (c): the trained pair phase 11 left in ``work``
    spec_paths.update(spec_trained_leg(work, power))
    mark("13 trained pair")

    # 12 (b, c, d): f32 adapter streams, LoRA fine-tuning, int8 sst2-bert
    t12 = time.perf_counter()
    adapters_f32_leg(power)
    lora_paths = lora_leg(sst2_ckpt, train_row, train_profile, work, power)
    lora_paths["/predict sst2-bert --quantize int8"] = predict_leg(
        sst2_ckpt, "int8", power)
    emit({"case": "phase12_seconds", "gpt2_serving": item5_seconds,
          "f32_lora_predict": time.perf_counter() - t12})
    mark("12 f32 adapters, LoRA, int8 predict")
    emit({"case": "phase_seconds", **stamps})

    summary = []
    for name in SERVING:
        mine = [r for r in rows if r["kernel"] == name]
        main_row = next(r for r in mine
                        if r["format"] == "bf16" and r["L"] == 1024)
        # The main path of a kernel: the bf16-cache serving run of its
        # layout; the other runs' counts stand beside it.
        main_path = "none, page 16" if name.startswith("paged_") else "none"
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name][main_path],
            "launches_per_path": {
                **launches[name],
                **{path: counts[name]
                   for path, counts in item5_paths.items()},
                **{path: counts[name]
                   for path, counts in spec_paths.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        })
    for name in FLASH:
        # The main path of B5-B7: the sst2-bert training run (steps and
        # its test-set evaluation); the row at its shape.
        mine = [r for r in flash_rows if r["kernel"] == name]
        main_row = next(r for r in mine if r["shape"] == "sst2-bert")
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": train_row["launches"][name],
            "launches_per_path": {
                f"train sst2-bert, {SST2_STEPS} steps + test eval":
                train_row["launches"][name],
                f"train docs-llama, {DOCS_LLAMA_STEPS} steps + test eval":
                llama_train["launches"][name],
                **(scoring["launches"] if name == "flash_forward"
                   else {}),
                **training[name],
                **{path: counts[name] for path, counts in lora_paths.items()
                   if counts[name]}},
            "bodies": train_row["bodies"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library_graph_ms": main_row["library_graph_ms"],
        })
    shutil.rmtree(work, ignore_errors=True)
    emit({"case": "run_seconds", "seconds": time.perf_counter() - t_run})
    emit({"kernels": summary})
    print(power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
