"""Generative serving engine: one resident model, batched decoding.

Counterpart of ``mlapi_tpu/serving/engine.py::TextGenerationEngine``.
Prompts are left-padded to a bucket (pads masked, positions shifted,
so the answer does not depend on the bucket), concurrent requests
coalesce into one batch, and each batch prefills once and decodes in
``chunk``-token steps against a KV cache it updates in place, pushing
each chunk to its requests as it lands. With ``kv_page_size`` the
cache is a device pool of pages plus per-row page tables
(``serving/paged_pool.py``) instead of one contiguous cache per batch.

Scope of the port: batches run one at a time through
``BatchRun.run()`` — the ordering of the JAX engine's
``--sched-max-batches 1``, in-lane admission included: while a batch
runs, the collector keeps pulling and stages every arrival the batch
can take (``_admit``), which joins at the next chunk boundary; the
rest wait for the next batch (``_carry``). A request naming a
``prefix`` reuses the prefix's cached KV (``serving/prefix.py``) and
computes only its suffix; prefix requests batch with each other, also
across different prefixes, never with plain ones. The unit scheduler,
speculation, adapters and tenants are not ported. ``chunk`` is
a fixed 8 (the JAX engine probes the device round trip to choose 8 or
16; a local card is the 8 case).
"""

from __future__ import annotations

import asyncio
import bisect
import concurrent.futures
import threading
from typing import Sequence

import numpy as np
import torch

from mlapi_tpu_torch.ops.quant import kv_tree_bytes
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.prefix import PrefixCache
from mlapi_tpu_torch.serving.requests import (
    DrainCancelled,
    GenRequest,
    LatencyStats,
    _SyncSink,
)
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.engine")


class OverloadedError(RuntimeError):
    """The submit queue is full: shed at the door (503 + retry-after)
    rather than queue without bound."""

    def __init__(self, what: str, retry_after_s: float = 2.0):
        super().__init__(f"{what} overloaded: queue full")
        self.retry_after_s = retry_after_s


# The decoder families a checkpoint may name (``models/gpt.DecoderLM``).
GENERATIVE_MODELS = ("gpt_lm", "llama_lm")


class TextGenerationEngine:
    """Serving engine for generative LMs (``gpt_lm``, ``llama_lm``)."""

    def __init__(
        self,
        model,
        *,
        tokenizer,
        meta: dict | None = None,
        default_max_new_tokens: int = 32,
        prompt_buckets: Sequence[int] = (16, 64, 128),
        max_batch: int = 8,
        chunk: int = 8,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        kv_page_size: int | None = None,
        kv_pages: int | None = None,
    ):
        if tokenizer.vocab_size > model.vocab_size:
            raise ValueError(
                f"tokenizer emits ids up to {tokenizer.vocab_size - 1} but "
                f"the model's embedding table has {model.vocab_size} rows"
            )
        # Dense weights stored in the compute dtype once, instead of a
        # cast per use (outputs are unchanged; see each family's
        # cast_dense_).
        self.model = model.cast_dense_()
        self.device = model.device
        self.tokenizer = tokenizer
        self.meta = dict(meta or {})
        self.default_max_new_tokens = default_max_new_tokens
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b < model.max_positions
        ) or (model.max_positions // 2,)
        self.max_batch = int(max_batch)
        self.chunk = max(1, int(chunk))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self.kv_quant = model.kv_quant
        self.decode_attn_impl = model.decode_attn_impl
        # Paged KV cache: kv_pages defaults to the contiguous-equivalent
        # budget (every slot at the default tier, plus the null page),
        # so paging never costs more device memory than contiguous.
        if kv_pages is not None and kv_page_size is None:
            raise ValueError("kv_pages requires kv_page_size")
        self.pool = None
        if kv_page_size is not None:
            from mlapi_tpu_torch.serving.paged_pool import PagePool

            max_total = self._cache_len(
                self.prompt_buckets[-1], self.default_max_new_tokens
            )
            if kv_pages is None:
                per_slot = -(-max_total // int(kv_page_size))
                kv_pages = self.max_batch * per_slot + 1
            self.pool = PagePool(
                model, page_size=int(kv_page_size), num_pages=int(kv_pages),
            )
        # Collector state (started by the app's startup hook).
        self._queue: asyncio.Queue | None = None
        self._task: asyncio.Task | None = None
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._carry: list = []
        # Staged joiners of the running batch (``_admit``) and those it
        # handed back (``_deferred``), shared with the device thread.
        self._admit: list = []
        self._deferred: list = []
        self._alock = threading.Lock()
        # Shared-prefix KV caching: every piece of prefix state lives in
        # the PrefixCache; the engine routes calls to it.
        self.prefix = PrefixCache(self)
        # Stats (read by /metrics and the tests).
        self.requests = 0
        self.batch_calls = 0
        self.chunk_calls = 0
        self.rejected = 0
        self.cancelled_batches = 0
        self.prefill_chunks = 0
        self.admitted = 0
        self.growths = 0
        self.compactions = 0
        # Bytes of prefix KV adopted into pool pages (once per entry
        # residency), and cross-prefix paged batches that copied their
        # prefixes because a shift was not a page multiple.
        self.prefix_adopt_bytes = 0
        self.kv_prefix_copy_fallback = 0
        self.latency = LatencyStats()

    @classmethod
    def from_checkpoint(cls, path, *, device=None, kv_quant=None,
                        decode_attn_impl=None, **kwargs):
        """Build an engine from a checkpoint dir (``checkpoint/io``): the
        model from the manifest's config, its weights loaded onto
        ``device`` (default CUDA; see ``utils/platform``), the cache
        format and cache-read attention set when given."""
        from mlapi_tpu_torch.checkpoint import load_checkpoint, read_manifest
        from mlapi_tpu_torch.models import get_model
        from mlapi_tpu_torch.text import tokenizer_from_fingerprint
        from mlapi_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        meta = read_manifest(path)
        cfg = meta.config
        if cfg.get("model") not in GENERATIVE_MODELS:
            raise ValueError(
                f"{path}: model {cfg.get('model')!r} is not served by the "
                f"port (one of {GENERATIVE_MODELS})"
            )
        # Staged on the host, where the archive is read, then moved.
        model = get_model(cfg["model"], seed=None, device="cpu",
                          **cfg.get("model_kwargs", {}))
        state, meta = load_checkpoint(path, model)
        model.load_state_dict(state)
        model.to(dev)
        model.configure(kv_quant=kv_quant, decode_attn_impl=decode_attn_impl)
        tokenizer = tokenizer_from_fingerprint(
            cfg.get("tokenizer", {"kind": "bytes"})
        )
        return cls(model, tokenizer=tokenizer, meta=meta.to_json(), **kwargs)

    @property
    def queue_depth(self) -> int:
        base = self._queue.qsize() if self._queue is not None else 0
        with self._alock:
            staged = len(self._admit) + len(self._deferred)
        return base + len(self._carry) + staged

    # -- paged-pool accounting (state lives in serving/paged_pool.py) -----
    @property
    def kv_page_size(self) -> int:
        return self.pool.page if self.pool is not None else 0

    @property
    def kv_pages_total(self) -> int:
        return self.pool.pages_total if self.pool is not None else 0

    @property
    def kv_pages_in_use(self) -> int:
        return self.pool.pages_in_use if self.pool is not None else 0

    @property
    def kv_pages_shared(self) -> int:
        return self.pool.pages_shared if self.pool is not None else 0

    @property
    def kv_page_utilization(self) -> float:
        return self.pool.utilization if self.pool is not None else 0.0

    def kv_page_bytes(self) -> int:
        """Exact device bytes of ONE page across every layer (dtype and
        shape arithmetic): a sequence of ``t`` cached tokens holds
        ``ceil(t / page)`` pages."""
        return self.pool.page_bytes if self.pool is not None else 0

    # -- prefix-cache counters (state lives in serving/prefix.py) ---------
    @property
    def prefix_hits(self) -> int:
        return self.prefix.hits

    @property
    def prefix_misses(self) -> int:
        return self.prefix.misses

    @property
    def prefix_fallbacks(self) -> int:
        return self.prefix.fallbacks

    @property
    def prefix_builds(self) -> int:
        """Cold prefills of a prefix (``_build`` ran)."""
        return self.prefix.builds

    # -- shapes ------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.prompt_buckets, n)
        return self.prompt_buckets[min(i, len(self.prompt_buckets) - 1)]

    def _cache_len(self, bucket: int, n_new: int) -> int:
        """KV-cache length for a batch: new-token room of at least the
        default budget, rounded up to power-of-two multiples of
        ``chunk``, clamped to the model's window."""
        want = max(n_new, self.default_max_new_tokens)
        tier = self.chunk
        while tier < want:
            tier *= 2
        return min(self.model.max_positions, bucket + tier)

    def _slot_cache(self) -> dict:
        """Shapes of one batch-1 cache at the default tier: the model's
        own ``init_cache`` on the meta device (no memory; a GQA model's
        KV heads)."""
        total = self._cache_len(
            self.prompt_buckets[-1], self.default_max_new_tokens
        )
        return self.model.init_cache(1, total, device="meta")

    def kv_cache_slot_bytes(self) -> int:
        """Per-slot KV-cache storage bytes at the default bucket/tier,
        from shapes alone."""
        return kv_tree_bytes(self._slot_cache())

    def decode_bytes_per_step(self) -> int:
        """Modeled device bytes one decode step's attention read moves
        per slot at the default bucket/tier. ``flash`` streams the
        stored cache (int8 payload + scales, or the compute-dtype
        tensors): the storage bytes. ``einsum`` reads the stored cache
        AND the full-precision query-head-width operand it dequantizes
        into, unless the two coincide (MHA, no int8)."""
        cache = self._slot_cache()
        stored = kv_tree_bytes(cache)
        if self.model.decode_attn_impl == "flash":
            return stored
        itemsize = torch.empty((), dtype=self.model.cdt).element_size()
        full = 0
        for layer in cache.values():
            for name in ("k", "v", "k_q", "v_q"):
                if name in layer:
                    leaf = layer[name]
                    group = max(1, self.model.num_heads // leaf.shape[2])
                    full += leaf.numel() * group * itemsize
        return full if full == stored else stored + full

    def extend_bytes_per_chunk(self) -> int:
        """The read of one multi-token extend chunk: the decode read's
        model (a chunk streams the same cache once for its whole
        span)."""
        return self.decode_bytes_per_step()

    # -- encoding and packing -----------------------------------------------
    def _encode(self, text: str, n_new: int, temperature: float, seed: int,
                loop, top_k: int = 0, top_p: float = 1.0,
                prefix: str | None = None,
                stream: bool = False) -> GenRequest:
        entry = None
        raw = None
        if prefix:
            raw = self.tokenizer.token_ids(text)
            if not raw:
                # An empty suffix would condition on a pad placeholder
                # behind the prefix: serve prefix + text on the plain
                # path (the same stream), counted as a fallback.
                self.prefix.count_fallback()
                text = prefix + text
                raw = None
            else:
                # The suffix runs as one block against the cached KV,
                # so every nonempty prefix takes the KV path.
                entry = self.prefix.entry(prefix)
        p_len = entry.bucket if entry else 0
        limit = self.model.max_positions - n_new - p_len
        if limit <= 0:
            raise ValueError(
                f"max_new_tokens={n_new}"
                + (f" plus a {p_len}-slot prefix" if p_len else "")
                + f" leaves no room for a prompt "
                  f"(max_positions={self.model.max_positions})"
            )
        if raw is None:
            raw = self.tokenizer.token_ids(text)
        if entry is not None and len(raw) > limit:
            # Left-truncating the suffix would keep the whole prefix and
            # condition on other tokens than prefix + text: refuse.
            raise ValueError(
                f"prefix + text + max_new_tokens exceed the model window "
                f"(suffix is {len(raw)} tokens, {limit} fit behind the "
                f"{p_len}-slot prefix)"
            )
        raw = raw[-limit:] if raw else [self.tokenizer.pad_id]
        # Left-pad to a bucket; a prompt past the largest bucket rounds
        # up to a multiple of it and prefills in fixed-width chunks (or
        # takes its exact length when that multiple would not fit).
        if len(raw) > self.prompt_buckets[-1]:
            cp = self.prompt_buckets[-1]
            bucket = -(-len(raw) // cp) * cp
            if bucket > limit:
                bucket = len(raw)
        else:
            bucket = self._bucket(len(raw))
        bucket = min(bucket, limit)
        row = np.full((bucket,), self.tokenizer.pad_id, np.int32)
        used = min(len(raw), bucket)
        row[-used:] = raw[-used:]
        return GenRequest(
            row, used, n_new, temperature, seed, loop, top_k, top_p,
            prefix=entry, stream=stream, stats=self.latency,
        )

    def _pack_rows(self, reqs, bucket: int, b_pad: int):
        """Host mirrors for a batch: left-padded prompt rows plus the
        pad/sampling vectors; dummy rows (up to ``b_pad``) fully
        masked. Returns ``(prompt, n_pad, temps, topk, topp, seeds)``."""
        prompt = np.full((b_pad, bucket), self.tokenizer.pad_id, np.int32)
        n_pad = np.full((b_pad,), max(bucket - 1, 0), np.int64)
        temps = np.zeros((b_pad,), np.float32)
        topk = np.zeros((b_pad,), np.int64)
        topp = np.ones((b_pad,), np.float32)
        seeds = np.zeros((b_pad,), np.int64)
        for i, r in enumerate(reqs):
            prompt[i, bucket - len(r.row):] = r.row
            n_pad[i] = bucket - r.used
            temps[i] = r.temperature
            topk[i] = r.top_k
            topp[i] = r.top_p
            seeds[i] = r.seed
        return prompt, n_pad, temps, topk, topp, seeds

    # -- the batched decode (runs on the device thread) ---------------------
    def _form_batch(self, reqs: list, admit: bool = False):
        from mlapi_tpu_torch.serving.batch_run import BatchRun

        self.batch_calls += 1
        return BatchRun(self, reqs, admit)

    def _run_batch(self, reqs: list, admit: bool = False) -> None:
        """Serve one coalesced batch (``admit``: joiners staged while it
        runs join it); a failure is delivered to every waiter as its
        terminal frame, joiners included (they are appended to
        ``reqs``)."""
        try:
            with torch.inference_mode():
                self._form_batch(reqs, admit).run()
        except Exception as e:  # noqa: BLE001 — delivered to every waiter
            _log.error("generation batch of %d failed: %s", len(reqs), e)
            for r in reqs:
                try:
                    r.push(e)
                except Exception:  # a dead loop must not mask the others
                    pass

    def _compatible(self, group: list, r) -> bool:
        """Can ``r`` join ``group`` without clamping anyone: the prefix
        region, the widest bucket and the largest budget together must
        fit the window. Prefix requests batch with each other, also
        across different prefixes (each row's prefix right-aligned to
        the common region end ``max(prefix_len)``); prefix and plain
        requests never mix (a plain row would pay the whole region in
        dead cache slots)."""
        if (r.prefix_fp is None) != (group[0].prefix_fp is None):
            return False
        p_len = max(r.prefix_len, *(g.prefix_len for g in group))
        bucket = max(len(r.row), *(len(g.row) for g in group))
        n_new = max(r.n_new, *(g.n_new for g in group))
        return p_len + bucket + n_new <= self.model.max_positions

    def _defer(self, cand) -> None:
        """Hand a staged joiner the running batch cannot take back to
        the collector, for the next batch."""
        with self._alock:
            self._deferred.append(cand)

    def _place(self, r, running) -> None:
        """An arrival while ``running`` (the live batch's request list,
        or ``None``): staged for admission when the batch could take
        it, else carried to the next batch. Only arrivals are staged:
        a joiner the batch hands back waits in the carry for the next
        batch, so nothing goes back and forth."""
        if (
            running is not None
            and len(r.row) <= self.prompt_buckets[-1]
            and self._compatible(list(running), r)
        ):
            with self._alock:
                self._admit.append(r)
            return
        self._carry.append(r)

    # -- asyncio collector ---------------------------------------------------
    async def start(self) -> None:
        if self._task is None:
            self._queue = asyncio.Queue(maxsize=self.max_queue)
            # ONE device thread: batches run serially, in order.
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mlapi-device"
            )
            self._task = asyncio.create_task(
                self._collect_loop(), name="genbatcher"
            )

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001
                _log.warning("collector had died: %r", e)
            self._task = None
        if self._executor is not None:
            executor, self._executor = self._executor, None
            # Off the loop: waits out a batch mid-flight on the card.
            await asyncio.get_running_loop().run_in_executor(
                None, executor.shutdown
            )
        # A batch that ran on past the collector may have handed
        # joiners back after the collector's last sweep.
        with self._alock:
            left = self._admit + self._deferred
            self._admit.clear()
            self._deferred.clear()
        for r in left:
            try:
                r.push(DrainCancelled())
            except Exception:  # noqa: BLE001 — a dead loop
                pass

    async def _collect_loop(self) -> None:
        """Form window-compatible groups of up to ``max_batch`` queued
        requests (waiting up to ``max_wait_ms`` for stragglers) and run
        each on the device thread. While a batch runs, keep pulling:
        an arrival it could take is staged for admission at its next
        chunk boundary, any other is carried to the next group. Pulling
        pauses while the staging list or the carry is full, so a
        backlog fills the bounded queue and sheds at the door."""
        loop = asyncio.get_running_loop()
        reqs: list = []
        get = None      # an in-flight queue pop (the finally must see it)
        batch = None    # the running batch's future
        running = None  # ... and its request list (admission appends)
        try:
            while True:
                with self._alock:
                    self._carry = self._deferred + self._carry
                    self._deferred.clear()
                    if batch is None:
                        # No batch to join: staged requests form the next.
                        self._carry = self._admit + self._carry
                        self._admit.clear()
                if batch is not None:
                    with self._alock:
                        room = (len(self._admit) + len(self._deferred)
                                < self.max_batch)
                    if not (room and len(self._carry) < self.max_batch):
                        await asyncio.wait({batch}, timeout=0.05)
                    else:
                        get = asyncio.ensure_future(self._queue.get())
                        await asyncio.wait(
                            {batch, get}, return_when=asyncio.FIRST_COMPLETED
                        )
                        if not get.done():
                            # The batch ended first: retract the pop
                            # without losing an item it claims meanwhile.
                            get.cancel()
                            await asyncio.wait({get})
                        if not get.cancelled():
                            # Claimed: the finally must see it if the
                            # fault point kills the collector here.
                            reqs, get = [get.result()], None
                            faults.fire("collector_pop")
                            self._place(reqs.pop(), None if batch.done()
                                        else running)
                        get = None
                    if batch.done():
                        batch.result()  # _run_batch delivers its errors
                        batch = running = None
                    continue
                if self._carry:
                    reqs = [self._carry.pop(0)]
                    rest: list = []
                    for r in self._carry:
                        if (len(reqs) < self.max_batch
                                and self._compatible(reqs, r)):
                            reqs.append(r)
                        else:
                            rest.append(r)
                    self._carry = rest
                else:
                    reqs = [await self._queue.get()]
                    faults.fire("collector_pop")
                deadline = loop.time() + self.max_wait_s
                while len(reqs) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0 and self._queue.empty():
                        break
                    if self._queue.empty():
                        # Not wait_for: a pop that completes as the
                        # window closes must not lose its item.
                        get = asyncio.ensure_future(self._queue.get())
                        done, _ = await asyncio.wait({get}, timeout=timeout)
                        if not done:
                            get.cancel()
                            await asyncio.wait({get})
                            if get.cancelled():
                                get = None
                                break
                        nxt, get = get.result(), None
                    else:
                        nxt = self._queue.get_nowait()
                    if self._compatible(reqs, nxt):
                        reqs.append(nxt)
                    else:
                        self._carry.append(nxt)
                        break
                # From here the batch owns its requests' terminal
                # frames, even if this task is cancelled mid-run.
                running, reqs = reqs, []
                batch = loop.run_in_executor(
                    self._executor, self._run_batch, running, True
                )
        finally:
            # Cancellation or a crash must not strand any waiter.
            queued = []
            if get is not None:
                if get.done() and not get.cancelled():
                    queued.append(get.result())
                else:
                    get.cancel()
            if self._queue is not None:
                while not self._queue.empty():
                    queued.append(self._queue.get_nowait())
            with self._alock:
                queued += self._admit + self._deferred
                self._admit.clear()
                self._deferred.clear()
            for r in (*reqs, *self._carry, *queued):
                try:
                    r.push(DrainCancelled())
                except Exception:  # noqa: BLE001 — a dead loop
                    pass
            self._carry = []

    def _check_collector(self) -> None:
        if self._task is None:
            raise RuntimeError("generation engine not started")
        if self._task.done():
            exc = None if self._task.cancelled() else self._task.exception()
            raise RuntimeError(f"generation collector died: {exc!r}") from exc

    async def submit(self, text: str, *, max_new_tokens: int | None = None,
                     temperature: float = 0.0, seed: int = 0,
                     top_k: int = 0, top_p: float = 1.0,
                     prefix: str | None = None,
                     stream: bool = False) -> GenRequest:
        """Queue one prompt for batched decode; consume ``req.queue``
        for ``{"token_ids": [...]}`` chunks until the ``None`` sentinel
        (exceptions are delivered in-band). With ``prefix`` the prompt
        is ``prefix + text`` and the prefix's KV comes from the prefix
        cache; an invalid prefix raises ``ValueError``."""
        self._check_collector()
        n_new = int(max_new_tokens or self.default_max_new_tokens)
        loop = asyncio.get_running_loop()

        def encode():
            return self._encode(
                text, n_new, float(temperature), int(seed), loop,
                int(top_k), float(top_p), prefix=prefix,
                stream=bool(stream),
            )

        if prefix:
            # Off the event loop: a prefix's first use runs its prefill.
            req = await loop.run_in_executor(None, encode)
            # The collector may have stopped during the await.
            self._check_collector()
        else:
            req = encode()
        try:
            self._queue.put_nowait(req)
        except asyncio.QueueFull:
            self.rejected += 1
            raise OverloadedError("generate") from None
        self.requests += 1
        return req

    # -- synchronous single-shot (tests, CLI) ------------------------------
    def generate_text(self, text: str, *, max_new_tokens: int | None = None,
                      temperature: float = 0.0, seed: int = 0,
                      top_k: int = 0, top_p: float = 1.0,
                      prefix: str | None = None) -> dict:
        """One prompt → generated continuation (text + ids), through the
        same ``_run_batch`` the collector uses, on the caller's
        thread."""
        n_new = int(max_new_tokens or self.default_max_new_tokens)
        req = self._encode(
            text, n_new, float(temperature), int(seed), None,
            int(top_k), float(top_p), prefix=prefix,
        )
        out_ids: list[int] = []
        sink = _SyncSink(req, out_ids)
        self._run_batch([sink])
        if sink.error is not None:
            raise sink.error
        return {
            "text": self.tokenizer.decode(out_ids),
            "token_ids": out_ids,
            "prompt_tokens": req.prompt_tokens,
        }

    def warmup(self) -> None:
        """Run one short batch before serving, so the first request does
        not pay the one-time costs: building and loading the CUDA
        kernels (flash impl), the BLAS handles, the allocator's first
        blocks."""
        row = np.full((self.prompt_buckets[0],), self.tokenizer.pad_id,
                      np.int32)
        sink = _SyncSink(GenRequest(row, 1, 2, 0.0, 0, None), [])
        self._run_batch([sink])
        if sink.error is not None:
            raise sink.error
        _log.info(
            "warmed generate on %s (kv_quant=%s, decode_attn_impl=%s)",
            self.device, self.kv_quant, self.decode_attn_impl,
        )
