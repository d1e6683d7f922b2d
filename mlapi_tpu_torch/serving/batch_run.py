"""One batch's lifecycle: formation, prefill, chained decode chunks.

Counterpart of ``mlapi_tpu/serving/batch_run.py::BatchRun``, cut to
what this port serves:

======================  ================================================
``__init__``            formation: bucket/cache tier, host mirrors
                        (``_pack_rows``), batch padding to a power of 2
``_prefill``            plain prefill, or chunked prefill of a prompt
                        past the largest bucket (flash-extend reads)
``_first_token``        the first token rides the dispatch chain
``_decode_chunk``       one chained decode chunk + the drain policy
``units``               the loop as a generator of ``"decode"`` units
``run``                 drain ``units()`` to exhaustion
======================  ================================================

Continuous admission, compaction, speculation, prefix caching and the
paged cache are not ported: a batch decodes at its formed width until
every row is done or cancelled. Host mirrors (``n_pad``, ``temps``,
``topk``, ``topp``, ``seeds``, ``tok``, ``step``) are the source of
truth; the device holds the KV cache and the chained feedback token.
"""

from __future__ import annotations

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.dispatch import DispatchChain
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.batch_run")


class BatchRun:
    """Decode one coalesced batch, streaming chunks to each request; a
    ``None`` sentinel marks a request's completion (error delivery
    lives in the engine's ``_run_batch``)."""

    def __init__(self, eng, reqs: list) -> None:
        self.eng = eng
        self.reqs = reqs
        self.bucket = max(len(r.row) for r in reqs)
        n_new_max = max(r.n_new for r in reqs)
        self.total = eng._cache_len(self.bucket, n_new_max)
        self.n_new_max = min(n_new_max, self.total - self.bucket)
        b = len(reqs)
        # Pad the batch to a power of two, as the JAX engine does to
        # bound its compiled shapes; dummy rows are fully masked.
        b_pad = 1
        while b_pad < b:
            b_pad *= 2
        self.b, self.b_pad = b, b_pad
        (self.prompt, self.n_pad, self.temps, self.topk, self.topp,
         self.seeds) = eng._pack_rows(reqs, self.bucket, b_pad)
        self.device = eng.device
        self.n_pad_dev = torch.as_tensor(
            self.n_pad, dtype=torch.long, device=self.device
        )
        self.rows: list = list(range(b))
        first = self._prefill()
        self.pos = self.bucket
        self._first_token(first)
        self.chain = DispatchChain(self._deliver)

    # -- formation ----------------------------------------------------

    def _prefill(self):
        """Run the batch's prefill into ``self.cache``; returns the
        ``[B]`` device tensor of first sampled tokens."""
        from mlapi_tpu_torch.models.gpt import (
            extend_chunk_fn, prefill_fn, sample_fn,
        )

        eng = self.eng
        bucket, total = self.bucket, self.total
        prompt = torch.as_tensor(
            self.prompt, dtype=torch.long, device=self.device
        )
        cp = eng.prompt_buckets[-1]
        if bucket > cp and bucket % cp == 0:
            # Chunked prefill: the long prompt runs as cp-wide
            # extend_core blocks, each reading the cache written so far
            # (flash-extend under decode_attn_impl="flash").
            self.cache = eng.model.init_cache(self.b_pad, total)
            logits = None
            for c0 in range(0, bucket, cp):
                faults.fire("prefill_chunk")
                eng.prefill_chunks += 1
                self.cache, logits = extend_chunk_fn(
                    eng.model, self.cache, prompt[:, c0:c0 + cp], c0,
                    self.n_pad_dev,
                )
            return sample_fn(
                logits, self.seeds, self.temps, self.topk, self.topp
            )
        first, self.cache = prefill_fn(
            eng.model, prompt, self.seeds, self.temps, self.n_pad_dev,
            self.topk, self.topp, total_len=total,
        )
        return first

    def _first_token(self, first) -> None:
        """The prefill's sampled token stays on the device as the first
        chunk's feedback and is delivered by the first drain."""
        # step[row]: the row's NEXT sampling-stream index.
        self.step = np.ones((self.b_pad,), np.int64)
        self.done = [False] * self.b
        self.tok = np.zeros((self.b_pad,), np.int64)
        self.produced = [0] * self.b
        # produced as of the DISPATCH frontier (scheduled on the device,
        # possibly not yet drained); ``produced`` is what was delivered.
        self.sched = list(self.produced)
        self.first_chunk = first[:, None]
        self._first = first

    # -- shared bookkeeping -------------------------------------------

    def _deliver(self, toks_host, got, plive):
        self.tok = toks_host[:, -1].copy()
        for i in plive:
            r = self.reqs[i]
            if r.cancelled:
                continue
            want = r.n_new - self.produced[i]
            if want > 0:
                chunk_ids = toks_host[self.rows[i], : min(want, got)]
                r.push({"token_ids": chunk_ids.tolist()})
                self.produced[i] += got
                if want <= got:
                    r.push(None)
                    self.done[i] = True

    def _sdone(self, i: int) -> bool:
        """done[] as of the dispatch frontier."""
        return self.done[i] or self.sched[i] >= self.reqs[i].n_new

    # -- chained chunk dispatch ---------------------------------------

    def _decode_chunk(self, size: int, live: list) -> None:
        """One decode chunk on the dispatch chain; the feedback token
        stays on the device between chunks. A batch with a streaming
        consumer keeps at most one chunk in flight; others drain every
        four chunks."""
        from mlapi_tpu_torch.models.gpt import decode_chunk_fn

        eng = self.eng
        faults.fire("decode")
        eng.chunk_calls += 1
        tok = self.chain.tok_dev
        if tok is None:
            tok = torch.as_tensor(self.tok, device=self.device)
        toks, self.cache, last_tok = decode_chunk_fn(
            eng.model, self.cache, tok, self.pos, self.n_pad_dev,
            self.temps, self.seeds, self.step, self.topk, self.topp,
            chunk=size,
        )
        self.chain.push(toks, size, live)
        for i in live:
            self.sched[i] += size
        self.step = self.step + size
        self.pos += size
        self.chain.tok_dev = last_tok
        if any(self.reqs[i].stream for i in self.chain.pending_live()):
            if len(self.chain) > 1:
                self.chain.drain(len(self.chain) - 1)
        elif len(self.chain) >= 4:
            self.chain.drain()

    # -- the loop -----------------------------------------------------

    def run(self) -> None:
        for _ in self.units():
            pass

    def units(self):
        """The lifecycle as a stream of schedulable units: yields
        ``"decode"`` after each decode-chunk dispatch."""
        reqs, chain = self.reqs, self.chain
        # The deferred first token rides the chain as a width-1 chunk.
        all_rows = list(range(self.b))
        chain.push(self.first_chunk, 1, all_rows)
        for i in all_rows:
            self.sched[i] += 1
        chain.tok_dev = self._first
        while True:
            live = [
                i for i, r in enumerate(reqs)
                if not self._sdone(i) and not r.cancelled
            ]
            if not live:
                chain.drain()
                if not all(self.done):
                    self.eng.cancelled_batches += 1
                break
            # The last chunk may be remainder-sized when the window
            # clamps the cache tier.
            size = min(self.eng.chunk, self.total - self.pos)
            if size <= 0:
                chain.drain()
                break
            self._decode_chunk(size, live)
            yield "decode"
        chain.drain()
        # Safety net: every waiter gets a terminator.
        for i, r in enumerate(reqs):
            if self.done[i] or r.cancelled:
                continue
            _log.error(
                "request truncated at %d/%d tokens (batch window "
                "exhausted)", self.produced[i], r.n_new,
            )
            r.push(RuntimeError(
                f"generation truncated at {self.produced[i]}/"
                f"{r.n_new} tokens (incompatible batch)"
            ))
