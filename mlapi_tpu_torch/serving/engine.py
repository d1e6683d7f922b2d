"""Serving engines: one resident model each (counterpart of
``mlapi_tpu/serving/engine.py``).

:class:`InferenceEngine` and :class:`TextClassificationEngine` (end of
the module) classify bucket-padded batches for the scoring path
(``serving/scoring.py``); ``InferenceEngine.from_checkpoint`` builds
whichever engine a checkpoint needs. The rest of this note is about
:class:`TextGenerationEngine`, the generative engine.
Prompts are left-padded to a bucket (pads masked, positions shifted,
so the answer does not depend on the bucket), concurrent requests
coalesce into one batch, and each batch prefills once and decodes in
``chunk``-token steps against a KV cache it updates in place, pushing
each chunk to its requests as it lands. With ``kv_page_size`` the
cache is a device pool of pages plus per-row page tables
(``serving/paged_pool.py``) instead of one contiguous cache per batch.

Batches run as lanes of the unit scheduler (``serving/scheduler.py``):
up to ``sched_max_batches`` (default 2) batches live at once, their
typed units (formation prefill, interleaved prefill chunk, decode
chunk, admission, compaction) interleaved on one dispatch thread;
``sched_max_batches=1`` runs the same machinery one batch at a time.
The one collector forms window-compatible groups and routes each
(``_dispatch_group``): staged for a live lane that can take it at its
next unit boundary (``_admit``), else handed to the scheduler as a
pending group, else it waits. A request naming a ``prefix`` reuses the
prefix's cached KV (``serving/prefix.py``) and computes only its
suffix; prefix requests batch with each other, also across different
prefixes, never with plain ones.

Robustness, as in the JAX engine: a request may carry a deadline
(``deadline_ms``, or the engine's ``default_deadline_ms``) checked at
every dispatch boundary (``_expire_if_due``); with
``admission_control`` a deadline the latency reservoirs say cannot be
met sheds at the door (``admission_estimate_ms``), and queue pressure
engages the brownout rungs (clamp token budgets; evict idle prefix
page sets); ``drain`` stops admission and lets in-flight streams
finish within a budget.

Many-tenant LoRA (``adapter_slots``): one resident base and a device
slot pool of per-tenant adapters (``serving/adapter_store.py``); a
request naming ``adapter`` decodes under base + its delta, batched with
base rows and other tenants. Tenants (``tenants``, a
``serving/registry.TenantLedger`` the app attaches): per-tenant page and
adapter-slot quotas in the scheduler's reservation gate, weighted
deadline slack, and a tenant-scoped brownout rung in :meth:`submit`.

Speculative decoding (``draft``, ``spec_k``, ``spec_sample``): a
smaller same-tokenizer draft proposes ``spec_k`` tokens a round and the
target verifies them in one block (``serving/spec_phase.py``). A solo
greedy row, or under ``spec_sample`` a solo sampled one, speculates
until other work waits and again once it is alone; a freshly formed
all-greedy batch speculates as a whole and realigns its cache for the
chunk loop. Brownout rung 1 suppresses it.

Fused-chunk widths (``fused_single``, on by default, as in the JAX
engine): a batch with no streaming row decodes in tier-wide chunks, one
``"decode"`` unit each, the width shrinking to the live rows' remaining
budgets and dropping to ``chunk`` while a streaming row is live
(``serving/fused_single.py``); ``fused_single=False`` pins ``chunk``.

The host KV tier (``kv_tier_bytes``, optionally ``kv_tier_disk_dir``):
evicted prefix KV spills to host memory in its stored format and a
later miss restores it with no prefill (``serving/kv_tier.py``, seams in
``serving/paged_pool.py`` and ``serving/prefix.py``).

Not ported: the fleet tier of adapters (``AdapterPeer``) and of prefix
KV (peer fetch, disaggregation).
``chunk`` is a fixed 8 (the JAX engine probes the device round trip to
choose 8 or 16; a local card is the 8 case).
"""

from __future__ import annotations

import asyncio
import bisect
import contextlib
import threading
import time
from typing import Sequence

import numpy as np
import torch

from mlapi_tpu_torch.ops.quant import kv_tree_bytes
from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.prefix import PrefixCache
from mlapi_tpu_torch.serving.requests import (
    DeadlineExceeded,
    DrainCancelled,
    GenRequest,
    LatencyStats,
    _SyncSink,
)
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.engine")
_NULL = contextlib.nullcontext()


class OverloadedError(RuntimeError):
    """Shed at the door (503 + retry-after) rather than queue without
    bound: the submit queue is full, the server drains, or a deadline
    cannot be met."""

    def __init__(self, what: str, retry_after_s: float = 2.0,
                 detail: str = "queue full"):
        super().__init__(f"{what} overloaded: {detail}")
        self.retry_after_s = retry_after_s


# The decoder families a checkpoint may name (``models/gpt.DecoderLM``).
GENERATIVE_MODELS = ("gpt_lm", "llama_lm")


class TextGenerationEngine:
    """Serving engine for generative LMs (``gpt_lm``, ``llama_lm``)."""

    kind = "generative"

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
        sched_max_batches: int = 2,
        adapter_slots: int = 0,
        adapter_store_bytes: int = 0,
        adapter_disk_dir: str | None = None,
        draft=None,
        spec_k: int = 4,
        spec_sample: bool = False,
        fused_single: bool = True,
        fused_max_new: int | None = None,
        kv_tier_bytes: int = 0,
        kv_tier_disk_dir: str | None = None,
    ):
        if tokenizer.vocab_size > model.vocab_size:
            raise ValueError(
                f"tokenizer emits ids up to {tokenizer.vocab_size - 1} but "
                f"the model's embedding table has {model.vocab_size} rows"
            )
        # Speculative decoding: the draft model (its weights inside, on
        # the target's device), proposals per round, and whether SAMPLED
        # solo rows speculate too (a deployment flag: their streams keep
        # the target's distribution, but a stream interleaved with
        # admission churn is not byte-reproducible per seed).
        if draft is not None:
            if draft.vocab_size != model.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary"
                )
            if draft.max_positions < model.max_positions:
                raise ValueError(
                    f"draft window ({draft.max_positions}) must cover "
                    f"the target's ({model.max_positions})"
                )
            draft = draft.cast_dense_()
        self.draft_model = draft
        self.spec_k = max(1, int(spec_k))
        self.spec_sample = bool(spec_sample)
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
        # Fused-chunk widths (serving/fused_single.py): fused_max_new
        # caps the width ladder, bounding the largest single dispatch.
        self.fused_single = bool(fused_single)
        self.fused_max_new = int(
            fused_max_new if fused_max_new is not None
            else max(64, default_max_new_tokens)
        )
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
        # The host KV tier (serving/kv_tier.py): an LRU store of evicted
        # prefix KV in host memory, optionally on disk. 0 (the default)
        # turns it off: evictions discard. Attached to the pool (the
        # spill seam); the PrefixCache consults it (the restore seams).
        self.kv_tier = None
        if kv_tier_disk_dir and not kv_tier_bytes:
            raise ValueError(
                "kv_tier_disk_dir requires kv_tier_bytes > 0 (the "
                "bytes budget enables the tier; a silently-ignored "
                "disk dir would store nothing)"
            )
        if kv_tier_bytes:
            from mlapi_tpu_torch.serving.kv_tier import KVTier

            self.kv_tier = KVTier(int(kv_tier_bytes),
                                  disk_dir=kv_tier_disk_dir)
            if self.pool is not None:
                self.pool.tier = self.kv_tier
        # Collector state (started by the app's startup hook).
        self._queue: asyncio.Queue | None = None
        self._task: asyncio.Task | None = None
        # Cross-thread collector wake (a lane retired, a joiner handed
        # back), set through ``_wake_collector``.
        self._kick: asyncio.Event | None = None
        self._aloop: asyncio.AbstractEventLoop | None = None
        # Claimed off the queue, window-incompatible with the group
        # being formed: served next.
        self._carry: list = []
        # Joiners staged for a live lane's admission (``_admit``) and
        # those a lane handed back (``_deferred``), shared with the
        # dispatch thread.
        self._admit: list = []
        self._deferred: list = []
        self._alock = threading.Lock()
        # The group the collector has claimed and not yet handed on: in
        # flight for drain().
        self._forming: list | None = None
        # The unit scheduler (created by start(), stopped by stop()).
        self.sched_max_batches = max(1, int(sched_max_batches))
        self.sched = None
        # Robustness: the deadline of requests that name none (None: no
        # deadline), SLO admission and brownout, graceful drain.
        self.default_deadline_ms: float | None = None
        self.admission_control = True
        self.drain_timeout_s = 10.0
        self.draining = False
        # The fleet backlog a router reports: 0 until the router is
        # ported (ROADMAP Queue A item 7).
        self.router_queue_depth = 0
        # Shared-prefix KV caching: every piece of prefix state lives in
        # the PrefixCache; the engine routes calls to it.
        self.prefix = PrefixCache(self)
        # Many-adapter LoRA: a device slot pool (adapter_slots > 0) and
        # the host store it installs from (default budget 256 MiB). Off,
        # a request naming an adapter is refused (404) and every batch
        # runs the base model's ops unchanged.
        self.adapters = None
        self.adapter_store = None
        if (adapter_store_bytes or adapter_disk_dir) and not adapter_slots:
            raise ValueError(
                "adapter_store_bytes/adapter_disk_dir require "
                "adapter_slots > 0 (the slot pool enables adapter "
                "serving)"
            )
        if adapter_slots:
            from mlapi_tpu_torch.serving.adapter_store import (
                AdapterSlots,
                AdapterStore,
            )

            self.adapters = AdapterSlots(self, int(adapter_slots))
            self.adapter_store = AdapterStore(
                int(adapter_store_bytes) or (1 << 28),
                disk_dir=adapter_disk_dir,
            )
        # Per-tenant quotas, weights and pressure (TenantLedger), set by
        # the app when a tenant flag is given; None: single-tenant.
        self.tenants = None
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
        # Interleaved prefills of long joiners, the longest run of
        # prefill chunks live decode rows waited behind, and the chunks
        # the active one still has to dispatch.
        self.interleaved_prefills = 0
        self.interleave_max_stall = 0
        self.prefill_chunk_queue_depth = 0
        # What was shed at the door, what expired at which boundary,
        # and the brownout rung 1 clamps.
        self.shed_queue_full = 0
        self.shed_deadline_infeasible = 0
        self.shed_draining = 0
        self.deadline_expired_queued = 0
        self.deadline_expired_prefill = 0
        self.deadline_expired_decode = 0
        self.brownout_tokens_clamped = 0
        # The scheduler's units by kind, deadline preemptions, groups
        # held back by the page budget, the most lanes live at once,
        # and the longest run of units one lane got while another was
        # live.
        self.sched_units_prefill = 0
        self.sched_units_decode = 0
        self.sched_units_admit = 0
        self.sched_units_compact = 0
        # Scoring batches of co-resident classifiers run as score units.
        self.sched_units_score = 0
        self.sched_deadline_preempts = 0
        self.sched_pages_deferred = 0
        # Groups held back because their adapters could not all claim a
        # slot (the adapter term of the same gate), or because their
        # TENANT was at its page or adapter-slot quota; and submits whose
        # budget the tenant brownout rung clamped.
        self.sched_adapters_deferred = 0
        self.sched_tenant_pages_deferred = 0
        self.sched_tenant_adapters_deferred = 0
        self.brownout_tenant_clamped = 0
        # Adapter batch runs by application mode, counted once per run
        # at its first adapter dispatch: every row one tenant (grouped,
        # one x @ a @ b per target) or mixed (gathered BGMV).
        self.adapter_grouped_batches = 0
        self.adapter_gathered_batches = 0
        # Speculation: rounds, proposals tested and accepted, paged
        # handoffs realigned by a host table shift or a device repack,
        # runs whose speculation brownout suppressed (once a run), and
        # the scheduler's spec units.
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_realign_table_ops = 0
        self.spec_realign_repacks = 0
        self.brownout_spec_suppressed = 0
        self.sched_units_spec = 0
        # Batch runs that dispatched at least one fused-width chunk.
        self.fused_calls = 0
        self.sched_batches_live_max = 0
        self.sched_lane_stall_max = 0
        # Bytes of prefix KV adopted into pool pages (once per entry
        # residency), and cross-prefix paged batches that copied their
        # prefixes because a shift was not a page multiple.
        self.prefix_adopt_bytes = 0
        self.kv_prefix_copy_fallback = 0
        self.latency = LatencyStats()
        from mlapi_tpu_torch.serving.fused_single import FusedSinglePath
        from mlapi_tpu_torch.serving.spec_phase import SpecPhase

        self.spec = SpecPhase(self)
        self.fused = FusedSinglePath(self)

    @classmethod
    def from_checkpoint(cls, path, *, device=None, kv_quant=None,
                        decode_attn_impl=None, quantize=None,
                        draft_checkpoint=None, spec_sample: bool = False,
                        **kwargs):
        """Build an engine from a checkpoint dir (``checkpoint/io``): the
        model from the manifest's config, its weights loaded onto
        ``device`` (default CUDA; see ``utils/platform``), the cache
        format and cache-read attention set when given. ``quantize=
        "int8"`` serves int8 weights (``models/quantized``), quantized
        on the host before the move, so the card never holds the float
        weights; the engine's ``meta`` then says ``"quantized"``.

        ``draft_checkpoint``: a smaller checkpoint of the same tokenizer
        whose proposals the target verifies (speculative decoding); its
        cache takes the target's ``kv_quant`` and ``decode_attn_impl``.
        ``spec_sample`` also speculates sampled solo rows."""
        from mlapi_tpu_torch.checkpoint import read_manifest
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
        model, info = _load_generative(path, cfg)
        if quantize is not None:
            model = _quantized(model, quantize)
            info["quantized"] = quantize
        model.to(dev)
        model.configure(kv_quant=kv_quant, decode_attn_impl=decode_attn_impl)
        tokenizer = tokenizer_from_fingerprint(
            cfg.get("tokenizer", {"kind": "bytes"})
        )
        draft = None
        if draft_checkpoint is not None:
            dcfg = read_manifest(draft_checkpoint).config
            if dcfg.get("tokenizer") != cfg.get("tokenizer"):
                raise ValueError(
                    "draft checkpoint was trained with a different "
                    "tokenizer than the target"
                )
            draft = _load_generative(draft_checkpoint, dcfg)[0].to(dev)
            # The draft's spec-phase cache rides the target's format and
            # cache-read attention.
            draft.configure(kv_quant=kv_quant,
                            decode_attn_impl=decode_attn_impl)
            info["draft"] = str(draft_checkpoint)
        return cls(model, tokenizer=tokenizer, meta=info, draft=draft,
                   spec_sample=spec_sample, **kwargs)

    @property
    def queue_depth(self) -> int:
        """Requests waiting: the submit queue, the carry, the staged and
        handed-back joiners, and the groups the scheduler has not yet
        laned."""
        base = self._queue.qsize() if self._queue is not None else 0
        sched = self.sched.backlog if self.sched is not None else 0
        with self._alock:
            staged = len(self._admit) + len(self._deferred)
        return base + len(self._carry) + staged + sched

    @property
    def sched_queue_depth(self) -> int:
        """Runnable units: one per live lane and per pending group."""
        return self.sched.queue_depth if self.sched is not None else 0

    @property
    def sched_batches_live(self) -> int:
        return self.sched.batches_live if self.sched is not None else 0

    # -- deadlines, admission control, brownout, drain ----------------------
    def _expire_if_due(self, r, stage: str) -> bool:
        """The deadline check at a dispatch boundary (``stage``:
        queued, prefill or decode). An expired request gets its
        terminal :class:`DeadlineExceeded` frame and is cancelled like
        a disconnect, which frees its row and pages. True when this
        call expired it."""
        d = getattr(r, "deadline", None)
        if d is None or r.cancelled or time.perf_counter() < d:
            return False
        counter = f"deadline_expired_{stage}"
        setattr(self, counter, getattr(self, counter) + 1)
        try:
            r.push(DeadlineExceeded(stage))
        except Exception:  # noqa: BLE001 — a dead consumer loop
            pass
        r.cancel()
        return True

    def admission_estimate_ms(self) -> float:
        """Queue wait + TTFT for a request submitted now, from the p95
        TTFT and p50 inter-token reservoirs: each ``max_batch`` of
        backlog ahead costs one batch turnaround (TTFT plus the default
        budget at the inter-token rate), then the request pays its own
        TTFT. 0 until traffic fills the reservoirs: a cold server never
        sheds on a guess."""
        s = self.latency.summary()
        ttft = s["ttft_p95_ms"] or 0.0
        itl = s["intertoken_p50_ms"] or 0.0
        batch_ms = ttft + self.default_max_new_tokens * itl
        backlog = (self.queue_depth + self.prefill_chunk_queue_depth
                   + self.router_queue_depth) / max(1, self.max_batch)
        return backlog * batch_ms + ttft

    def _brownout_level(self) -> int:
        """Queue pressure → brownout rung: 0 normal, 1 at >= 50 % of
        ``max_queue`` (clamp token budgets, suppress speculation:
        ``BatchRun._spec_brownout``), 2 at >= 75 % (also evict an idle
        prefix page set)."""
        if not self.admission_control:
            return 0
        q = self.queue_depth + min(self.router_queue_depth, self.max_queue)
        if q * 4 >= self.max_queue * 3:
            return 2
        if q * 2 >= self.max_queue:
            return 1
        return 0

    async def drain(self, timeout_s: float | None = None) -> None:
        """Graceful drain: stop admitting (submit sheds 503, /healthz
        reads draining), let in-flight streams finish within
        ``timeout_s``, then end whatever remains with
        :class:`DrainCancelled` frames. Idempotent; ``stop()`` stays the
        caller's job."""
        self.draining = True
        if timeout_s is None:
            timeout_s = self.drain_timeout_s
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0.0, float(timeout_s))
        while loop.time() < deadline:
            with self._alock:
                staged = len(self._admit) + len(self._deferred)
            queued = self._queue is not None and not self._queue.empty()
            if (not queued and not staged and not self._carry
                    and self._forming is None
                    and (self.sched is None or self.sched.idle)):
                return
            await asyncio.sleep(0.05)
        # Budget spent: terminal frames for everything queued or in
        # flight, then cancel the rows (pages come back through the
        # cancellation path).
        leftovers: list = []
        if self._queue is not None:
            while not self._queue.empty():
                leftovers.append(self._queue.get_nowait())
        with self._alock:
            leftovers += self._admit + self._deferred
            self._admit.clear()
            self._deferred.clear()
        # Cancel-only: the collector owns its carry and forming lists.
        leftovers += list(self._carry)
        if self.sched is not None:
            leftovers += self.sched.sweep_requests()
        if self._forming is not None:
            leftovers += list(self._forming)
        for r in leftovers:
            if getattr(r, "cancelled", False):
                continue
            try:
                r.push(DrainCancelled())
            except Exception:  # noqa: BLE001 — a dead loop
                pass
            r.cancel()
        # A bounded moment for the lanes to notice the cancels.
        grace = loop.time() + 2.0
        while (self.sched is not None and not self.sched.idle
               and loop.time() < grace):
            await asyncio.sleep(0.05)

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

    # -- host-tier accounting (state lives in serving/kv_tier.py) ---------
    # Byte counters are dtype and shape arithmetic per blob, never
    # wall-clock; every one reads 0 without a tier.
    @property
    def kv_prefix_restore_hits(self) -> int:
        """Blob applications: entry rebuilds and pool-page restores,
        each a prefill (or adopt) the tier made unnecessary."""
        return self.kv_tier.restore_hits if self.kv_tier else 0

    @property
    def kv_prefix_restore_misses(self) -> int:
        return self.kv_tier.restore_misses if self.kv_tier else 0

    @property
    def kv_prefix_restore_bytes(self) -> int:
        return self.kv_tier.restore_bytes if self.kv_tier else 0

    @property
    def kv_prefix_restore_failures(self) -> int:
        return self.kv_tier.restore_failures if self.kv_tier else 0

    @property
    def kv_prefix_spill_count(self) -> int:
        return self.kv_tier.spill_count if self.kv_tier else 0

    @property
    def kv_prefix_spill_bytes(self) -> int:
        return self.kv_tier.spill_bytes if self.kv_tier else 0

    @property
    def kv_prefix_spill_failures(self) -> int:
        return self.kv_tier.spill_failures if self.kv_tier else 0

    @property
    def kv_tier_bytes_in_use(self) -> int:
        return self.kv_tier.bytes_in_use if self.kv_tier else 0

    @property
    def kv_tier_entries(self) -> int:
        return self.kv_tier.entries if self.kv_tier else 0

    @property
    def kv_tier_evictions(self) -> int:
        return self.kv_tier.evictions if self.kv_tier else 0

    # -- adapter accounting (state lives in serving/adapter_store.py) -----
    @property
    def adapter_slots_total(self) -> int:
        return self.adapters.slots_total if self.adapters else 0

    @property
    def adapter_slots_in_use(self) -> int:
        return self.adapters.slots_in_use if self.adapters else 0

    @property
    def adapter_evictions(self) -> int:
        return self.adapters.evictions if self.adapters else 0

    @property
    def adapter_installs(self) -> int:
        return self.adapters.installs if self.adapters else 0

    @property
    def adapter_slot_bytes(self) -> int:
        """Device bytes ONE resident adapter costs (one slot of every
        pool): ``adapter_resident_bytes == base + N x adapter_slot_bytes``
        for N resident tenants. 0 until the first install."""
        return self.adapters.slot_bytes() if self.adapters else 0

    @property
    def adapter_resident_bytes(self) -> int:
        """The closed form of the amortization: the model's stored
        parameter bytes + slots_in_use x adapter_slot_bytes."""
        if self.adapters is None:
            return 0
        from mlapi_tpu_torch.ops.quant import quantized_bytes

        base = quantized_bytes(self.model)[0]
        return base + self.adapters.slots_in_use * self.adapters.slot_bytes()

    # The fleet tier (AdapterPeer, ROADMAP Queue A item 7) is not
    # ported: its fetch and serve counters read 0.
    adapter_fetch_hits = adapter_fetch_misses = adapter_fetch_bytes = 0
    adapter_fetch_failures = adapter_serve_count = adapter_serve_bytes = 0

    @property
    def adapter_store_bytes_in_use(self) -> int:
        return self.adapter_store.bytes_in_use if self.adapter_store else 0

    @property
    def adapter_store_entries(self) -> int:
        return self.adapter_store.entries if self.adapter_store else 0

    @property
    def adapter_store_evictions(self) -> int:
        return self.adapter_store.evictions if self.adapter_store else 0

    def register_adapter(self, aid: str, payload: dict) -> int:
        """Put a pre-scaled adapter payload (``{layer: {target: {a,
        b}}}``, ``b`` carrying alpha/rank: ``models/lora.export_adapter``)
        into the HOST store under ``aid``; it installs into a device
        slot at its first request. The CLI's ``--adapter ID=PATH`` loads
        through here. Returns the payload bytes."""
        from mlapi_tpu_torch.serving import adapter_store as _as

        if self.adapter_store is None:
            raise ValueError(
                "engine built without adapter slots "
                "(--adapter-slots 0): cannot register adapters"
            )
        if not _as.ADAPTER_ID_RE.match(aid or ""):
            raise ValueError(f"bad adapter id {aid!r}")
        _as.adapter_rank(payload)  # loud on ragged/empty payloads
        return self.adapter_store.put(aid, payload)

    def _resolve_adapter(self, aid: str) -> None:
        """Check that this engine can serve adapter ``aid`` (resident in
        a slot or in the host store) BEFORE the request queues; raises
        ``AdapterUnavailable`` (404) otherwise: feature off, malformed
        id, or not registered."""
        from mlapi_tpu_torch.serving.adapter_store import (
            ADAPTER_ID_RE,
            AdapterUnavailable,
        )

        if self.adapters is None:
            raise AdapterUnavailable(
                "this replica serves no adapters (--adapter-slots 0)"
            )
        if not isinstance(aid, str) or not ADAPTER_ID_RE.match(aid):
            raise AdapterUnavailable(f"malformed adapter id {aid!r:.80}")
        if self.adapters.resident(aid) or self.adapter_store.has(aid):
            return
        raise AdapterUnavailable(
            f"adapter {aid!r} is not registered on this replica"
        )

    # -- shapes ------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.prompt_buckets, n)
        return self.prompt_buckets[min(i, len(self.prompt_buckets) - 1)]

    @property
    def default_tier(self) -> int:
        """The power-of-two (of ``chunk``) tier covering the default
        token budget: the floor of the fused width ladder."""
        tier = self.chunk
        while tier < self.default_max_new_tokens:
            tier *= 2
        return tier

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
                prefix: str | None = None, stream: bool = False,
                deadline_ms: float | None = None,
                adapter: str | None = None) -> GenRequest:
        entry = None
        raw = None
        if adapter is not None:
            self._resolve_adapter(adapter)
            if prefix:
                # The prefix cache holds BASE-model KV: under a tenant's
                # adapted weights it would condition the suffix on the
                # wrong model. Fold the prefix into the prompt (the same
                # answer) and count the declined reuse.
                self.prefix.count_fallback()
                text = prefix + text
                prefix = None
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
            deadline_ms=deadline_ms, adapter=adapter,
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

    # -- the batched decode (runs on the dispatch thread) -------------------
    def _form_batch(self, reqs: list, admit: bool = False,
                    fused_ok: bool = True):
        """The formation preamble shared by ``_run_batch`` and the
        scheduler's lane start: requests whose deadline passed in the
        queue get their terminal frame and never reach the device (the
        sweep edits ``reqs`` in place: admission appends to it and error
        delivery iterates it). ``fused_ok=False`` pins the plain chunk
        width for the whole run; otherwise the fused width is decided
        per boundary (``serving/fused_single.py``). Returns the formed
        :class:`BatchRun`, or ``None`` when every request expired."""
        from mlapi_tpu_torch.serving.batch_run import BatchRun

        alive = [r for r in reqs if not self._expire_if_due(r, "queued")]
        if not alive:
            return None
        reqs[:] = alive
        self.batch_calls += 1
        return BatchRun(self, reqs, admit, fused_ok)

    def _run_batch(self, reqs: list, admit: bool = False,
                   fused_ok: bool = True) -> None:
        """Serve one batch on the caller's thread (the synchronous path:
        ``generate_text``, warmup); a failure is delivered to every
        waiter as its terminal frame."""
        try:
            with torch.inference_mode():
                run = self._form_batch(reqs, admit, fused_ok)
                if run is not None:
                    run.run()
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

    def _spec_should_yield(self) -> bool:
        """Does a speculative phase end at its next round boundary:
        joiners are staged for admission, or (under the unit scheduler)
        other lanes or pending groups have work. A spec round is one
        unit; a solo phase must not hold the dispatch thread while
        another batch waits. (Tests patch it to force a handoff.)"""
        with self._alock:
            if self._admit:
                return True
        s = self.sched
        return s is not None and s.queue_depth > 1

    def _defer(self, cand) -> None:
        """Hand a staged joiner a lane cannot take back to the collector
        and wake it."""
        with self._alock:
            self._deferred.append(cand)
        self._wake_collector()

    # -- asyncio collector ---------------------------------------------------
    async def start(self) -> None:
        if self._task is None:
            from mlapi_tpu_torch.serving.scheduler import UnitScheduler

            # A (re)started engine admits again after an earlier drain.
            self.draining = False
            self._queue = asyncio.Queue(maxsize=self.max_queue)
            self._kick = asyncio.Event()
            self._aloop = asyncio.get_running_loop()
            if self.sched is None:
                self.sched = UnitScheduler(
                    self, max_batches=self.sched_max_batches
                )
            self._task = asyncio.create_task(
                self._collect_loop(), name="genbatcher"
            )

    def _wake_collector(self) -> None:
        """Wake the collector out of its waits from any thread (a lane
        retired, a joiner handed back). A no-op before start() and once
        the loop is closed."""
        loop, ev = self._aloop, self._kick
        if loop is None or ev is None:
            return
        try:
            loop.call_soon_threadsafe(ev.set)
        except RuntimeError:
            pass  # the loop is closed: stop() delivered everything

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
        if self.sched is not None:
            # Off the loop: joins the dispatch thread, which may be
            # mid-unit on the card.
            sched, self.sched = self.sched, None
            await asyncio.get_running_loop().run_in_executor(
                None, sched.stop
            )
        # A lane that ran on past the collector may have handed joiners
        # back after the collector's last sweep.
        err = RuntimeError("generation engine stopped")
        with self._alock:
            left = self._admit + self._deferred
            self._admit.clear()
            self._deferred.clear()
        if self._queue is not None:
            while not self._queue.empty():
                left.append(self._queue.get_nowait())
        for r in left:
            try:
                r.push(err)
            except Exception:  # noqa: BLE001 — a dead loop
                pass

    async def _collect_loop(self) -> None:
        """The one collector: forms window-compatible groups of up to
        ``max_batch`` (waiting up to ``max_wait_ms`` for stragglers; the
        carry is served first, seeded by the earliest deadline) and
        routes each through ``_dispatch_group``. Dispatch blocks while
        the staging list and the scheduler's backlog are full, which
        stops the pop below: a backlog then fills the bounded queue and
        sheds at the door."""
        loop = asyncio.get_running_loop()
        reqs: list = []
        get = None   # an in-flight queue pop (the finally must see it)
        kick = None  # an in-flight kick wait
        try:
            while True:
                # Clear, then sweep: a wake that lands after the clear
                # sets the event again, one before it is seen here.
                self._kick.clear()
                with self._alock:
                    self._carry = self._deferred + self._carry
                    self._deferred.clear()
                    if self.sched is not None and self.sched.batches_live == 0:
                        # No lane to join: staged requests form groups.
                        self._carry = self._admit + self._carry
                        self._admit.clear()
                if self._carry:
                    # The earliest deadline seeds the group; deadline-
                    # less carries keep FIFO order behind the deadlined.
                    seed_i = min(
                        range(len(self._carry)),
                        key=lambda i: (self._carry[i].deadline is None,
                                       self._carry[i].deadline or 0.0, i),
                    )
                    reqs = [self._carry.pop(seed_i)]
                    self._forming = reqs
                    rest: list = []
                    for r in self._carry:
                        if (len(reqs) < self.max_batch
                                and self._compatible(reqs, r)):
                            reqs.append(r)
                        else:
                            rest.append(r)
                    self._carry = rest
                else:
                    # A blocking pop, multiplexed with the kick: a wake
                    # while the queue is idle re-runs the sweep above.
                    get = asyncio.ensure_future(self._queue.get())
                    kick = asyncio.ensure_future(self._kick.wait())
                    await asyncio.wait({get, kick},
                                       return_when=asyncio.FIRST_COMPLETED)
                    kick.cancel()
                    await asyncio.wait({kick})
                    kick = None
                    if not get.done():
                        # The kick won: retract the pop without losing
                        # an item it claims meanwhile.
                        get.cancel()
                        await asyncio.wait({get})
                        if get.cancelled():
                            get = None
                            continue
                    reqs = [get.result()]
                    self._forming = reqs
                    get = None
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
                await self._dispatch_group(reqs)
                reqs = []
                self._forming = None
        finally:
            self._forming = None
            # Cancellation or a crash strands no waiter: what was handed
            # to the scheduler is its own to deliver (its stop()).
            for fut in (kick, get):
                if fut is not None and not fut.done():
                    fut.cancel()
            err = RuntimeError("generation engine stopped")
            queued = []
            if get is not None and get.done() and not get.cancelled():
                queued.append(get.result())
            if self._queue is not None:
                while not self._queue.empty():
                    queued.append(self._queue.get_nowait())
            with self._alock:
                queued += self._admit + self._deferred
                self._admit.clear()
                self._deferred.clear()
            for r in (*reqs, *self._carry, *queued):
                try:
                    r.push(err)
                except Exception:  # noqa: BLE001 — a dead loop
                    pass
            self._carry = []

    async def _dispatch_group(self, reqs: list) -> None:
        """Route one formed group to the cheapest seat:

        1. a live lane whose window fits every request takes the group
           at its next unit boundary (staged once: a joiner the lane
           hands back comes here again and takes a lane of its own);
        2. else the scheduler takes it as a pending group (at most one
           ``max_batch`` of pending requests, so ``max_queue`` keeps
           its meaning), laned in urgency order when a slot and the
           page budget allow;
        3. else wait for a kick (a lane retired, a joiner came back),
           polling every 50 ms. The group stays in ``_forming`` all the
           while, so drain() and the terminal sweep see it."""
        while True:
            sched = self.sched
            if sched is None:
                raise RuntimeError("scheduler stopped")
            self._kick.clear()
            with self._alock:
                room = (self.max_batch - len(self._admit)
                        - len(self._deferred) >= len(reqs))
            if room and all(not r.staged for r in reqs):
                for lane_reqs in sched.lane_groups():
                    if lane_reqs and all(self._compatible(lane_reqs, r)
                                         for r in reqs):
                        for r in reqs:
                            r.staged = True
                        with self._alock:
                            self._admit.extend(reqs)
                        return
            if sched.backlog < self.max_batch:
                sched.submit(reqs)
                return
            waiter = asyncio.ensure_future(self._kick.wait())
            try:
                await asyncio.wait({waiter}, timeout=0.05)
            finally:
                waiter.cancel()

    def _check_collector(self) -> None:
        if self._task is None:
            raise RuntimeError("generation engine not started")
        if self._task.done():
            exc = None if self._task.cancelled() else self._task.exception()
            raise RuntimeError(f"generation collector died: {exc!r}") from exc

    def _shed_draining(self) -> OverloadedError:
        self.shed_draining += 1
        self.rejected += 1
        return OverloadedError(
            "generate", retry_after_s=self.drain_timeout_s,
            detail="server draining: retry against another replica",
        )

    async def submit(self, text: str, *, max_new_tokens: int | None = None,
                     temperature: float = 0.0, seed: int = 0,
                     top_k: int = 0, top_p: float = 1.0,
                     prefix: str | None = None, stream: bool = False,
                     deadline_ms: float | None = None,
                     adapter: str | None = None,
                     tenant: str | None = None) -> GenRequest:
        """Queue one prompt for batched decode; consume ``req.queue``
        for ``{"token_ids": [...]}`` chunks until the ``None`` sentinel
        (exceptions are delivered in-band). With ``prefix`` the prompt
        is ``prefix + text`` and the prefix's KV comes from the prefix
        cache; an invalid prefix raises ``ValueError``. ``adapter``
        decodes under that tenant's LoRA adapter (``AdapterUnavailable``
        when this engine cannot serve it); ``tenant`` names the
        quota and fairness identity, by default the adapter id, else
        the anonymous tenant.

        ``deadline_ms`` is the request's wall-clock budget (the engine's
        ``default_deadline_ms`` when None). The front door sheds with
        :class:`OverloadedError` while draining, and a deadline the
        admission estimate says cannot be met; queue pressure clamps
        budgets (brownout rung 1) and evicts an idle prefix page set
        (rung 2)."""
        self._check_collector()
        if self.draining:
            raise self._shed_draining()
        n_new = int(max_new_tokens or self.default_max_new_tokens)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        tenant = tenant or adapter or ""
        led = self.tenants
        if led is not None and tenant:
            # The tenant brownout rung engages before the fleet-wide
            # ladder: one tenant whose live depth reaches a quarter of
            # the queue has its budgets clamped at half the pressure
            # rung 1 needs.
            if (led.depth(tenant) * 4 >= self.max_queue
                    and n_new > self.default_max_new_tokens):
                n_new = self.default_max_new_tokens
                self.brownout_tenant_clamped += 1
                led.note_brownout(tenant)
        level = self._brownout_level()
        if level >= 1 and n_new > self.default_max_new_tokens:
            # Rung 1: bounded work per admitted request under pressure.
            n_new = self.default_max_new_tokens
            self.brownout_tokens_clamped += 1
        loop = asyncio.get_running_loop()
        if level >= 2 and self.pool is not None:
            # Rung 2: evict an idle (unreferenced) prefix page set, so
            # live sequences keep allocating; off the event loop.
            await loop.run_in_executor(None, self.pool.evict_idle, 1)
        if self.admission_control and deadline_ms is not None \
                and deadline_ms > 0:
            est = self.admission_estimate_ms()
            if est > deadline_ms:
                # It would expire in the queue: shed now, and say when
                # the backlog should have cleared.
                self.shed_deadline_infeasible += 1
                self.rejected += 1
                raise OverloadedError(
                    "generate",
                    retry_after_s=max(1.0, (est - deadline_ms) / 1e3),
                    detail=(f"deadline infeasible: estimated queue wait + "
                            f"TTFT {est:.0f} ms exceeds the "
                            f"{deadline_ms:.0f} ms budget"),
                )

        def encode():
            return self._encode(
                text, n_new, float(temperature), int(seed), loop,
                int(top_k), float(top_p), prefix=prefix,
                stream=bool(stream), deadline_ms=deadline_ms,
                adapter=adapter,
            )

        if prefix and adapter is None:
            # Off the event loop: a prefix's first use runs its prefill.
            req = await loop.run_in_executor(None, encode)
            # The collector may have stopped, or a drain finished,
            # during the await: no collector would pop this request.
            self._check_collector()
            if self.draining:
                raise self._shed_draining()
        else:
            req = encode()
        req.tenant = tenant
        try:
            self._queue.put_nowait(req)
        except asyncio.QueueFull:
            self.rejected += 1
            self.shed_queue_full += 1
            raise OverloadedError("generate") from None
        if led is not None and tenant:
            # Live depth: entered here, left at the terminal frame
            # (GenRequest.finish fires on every delivery path, cancels
            # included).
            led.enter(tenant)
            req.on_done = lambda t=tenant: led.exit(t)
        self.requests += 1
        return req

    # -- synchronous single-shot (tests, CLI) ------------------------------
    def generate_text(self, text: str, *, max_new_tokens: int | None = None,
                      temperature: float = 0.0, seed: int = 0,
                      top_k: int = 0, top_p: float = 1.0,
                      prefix: str | None = None,
                      adapter: str | None = None) -> dict:
        """One prompt → generated continuation (text + ids), through the
        same ``_run_batch`` the collector uses, on the caller's
        thread."""
        n_new = int(max_new_tokens or self.default_max_new_tokens)
        req = self._encode(
            text, n_new, float(temperature), int(seed), None,
            int(top_k), float(top_p), prefix=prefix, adapter=adapter,
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
        if self.draft_model is not None:
            self.spec.warm()
        _log.info(
            "warmed generate on %s (kv_quant=%s, decode_attn_impl=%s%s)",
            self.device, self.kv_quant, self.decode_attn_impl,
            ", draft" if self.draft_model is not None else "",
        )


def _load_generative(path, cfg: dict):
    """A decoder checkpoint's model with its weights, on the host (where
    the archive is read; callers move it), and the manifest's JSON."""
    from mlapi_tpu_torch.checkpoint import load_checkpoint
    from mlapi_tpu_torch.models import get_model

    model = get_model(cfg["model"], seed=None, device="cpu",
                      **cfg.get("model_kwargs", {}))
    state, meta = load_checkpoint(path, model)
    model.load_state_dict(state)
    return model, meta.to_json()


def _quantized(model, quantize: str):
    """``model`` as weight-only int8 (``models/quantized``), with the
    stored and f32 byte counts logged."""
    from mlapi_tpu_torch.models.quantized import QuantizedModel
    from mlapi_tpu_torch.ops.quant import quantized_bytes

    model = QuantizedModel(model)
    stored, full = quantized_bytes(model)
    _log.info("weight-only %s: params %.1f MB (f32 would be %.1f MB)",
              quantize, stored / 1e6, full / 1e6)
    return model


# -- classification --------------------------------------------------------

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class InferenceEngine:
    """Batched classification over a resident model (counterpart of
    ``mlapi_tpu/serving/engine.py::InferenceEngine``).

    Rows are float32 feature vectors (:class:`TextClassificationEngine`:
    token ids). A call pads its rows to the next bucket size and chunks
    past the largest (``max_batch``); each chunk is one forward whose
    logits become ONE fused ``[B, 2]`` float32 tensor (label id,
    max-probability), so a batch costs one device→host copy. The forward
    runs under ``torch.inference_mode()`` entered by the calling thread
    (it is thread-local: a scoring path calls from pool threads or the
    unit scheduler's dispatch thread), so no call builds an autograd
    graph.
    """

    kind = "tabular"
    input_dtype = np.float32

    def __init__(self, model, vocab, feature_names=(), *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 meta: dict | None = None):
        self.model = model
        self.device = model.device
        self.vocab = vocab
        self.feature_names = tuple(feature_names)
        self.num_features = int(
            getattr(model, "num_features", 0) or len(self.feature_names)
            or 1
        )
        self.buckets = tuple(sorted(buckets))
        self.meta = dict(meta or {})

    @classmethod
    def from_checkpoint(cls, path, *, device=None,
                        buckets: Sequence[int] = DEFAULT_BUCKETS,
                        quantize: str | None = None,
                        kv_quant: str | None = None,
                        decode_attn_impl: str | None = None,
                        kv_page_size: int | None = None,
                        kv_pages: int | None = None,
                        **gen_kwargs):
        """The engine a checkpoint dir serves: a ``gpt_lm`` /
        ``llama_lm`` checkpoint goes to
        :meth:`TextGenerationEngine.from_checkpoint` (``gen_kwargs`` and
        the cache options with it); a classifier to a
        :class:`TextClassificationEngine` when its model reads token ids
        (``input_kind == "text"``), else to this class. A classifier
        refuses the cache and decode options with the JAX package's
        messages, and a checkpoint without a label vocab."""
        from mlapi_tpu_torch.checkpoint import load_checkpoint, read_manifest
        from mlapi_tpu_torch.models import get_model
        from mlapi_tpu_torch.text import (
            load_tokenizer,
            tokenizer_from_fingerprint,
        )
        from mlapi_tpu_torch.utils.platform import resolve_device

        if quantize is not None and quantize != "int8":
            raise ValueError(f"unsupported quantize={quantize!r}")
        meta = read_manifest(path)
        cfg = meta.config
        if cfg.get("model") in GENERATIVE_MODELS:
            if kv_page_size is not None:
                gen_kwargs["kv_page_size"] = kv_page_size
            if kv_pages is not None:
                gen_kwargs["kv_pages"] = kv_pages
            return TextGenerationEngine.from_checkpoint(
                path, device=device, kv_quant=kv_quant,
                decode_attn_impl=decode_attn_impl, quantize=quantize,
                **gen_kwargs,
            )
        dev = resolve_device(device)
        model = get_model(cfg["model"], seed=None, device="cpu",
                          **cfg.get("model_kwargs", {}))
        name = type(model).__name__
        if kv_quant is not None:
            if kv_quant != "int8":
                raise ValueError(f"unsupported kv_quant={kv_quant!r}")
            raise ValueError(
                "kv_quant applies to generative checkpoints (they hold KV "
                f"caches); {name} has none"
            )
        if decode_attn_impl is not None:
            if decode_attn_impl not in ("einsum", "flash"):
                raise ValueError(
                    f"unsupported decode_attn_impl={decode_attn_impl!r}"
                )
            raise ValueError(
                "decode_attn_impl applies to generative checkpoints (they "
                f"decode); {name} does not"
            )
        if kv_page_size is not None or kv_pages is not None:
            raise ValueError(
                "kv_page_size/kv_pages apply to generative checkpoints "
                f"(they hold KV caches); {name} has none"
            )
        if gen_kwargs.get("kv_tier_bytes") or gen_kwargs.get(
                "kv_tier_disk_dir"):
            raise ValueError(
                "kv_tier_bytes/kv_tier_disk_dir apply to generative "
                f"checkpoints (they cache prefix KV); {name} has none"
            )
        if any(gen_kwargs.get(k) for k in ("adapter_slots",
                                           "adapter_store_bytes",
                                           "adapter_disk_dir")):
            raise ValueError(
                "adapter_slots/adapter_store_bytes/adapter_disk_dir "
                "apply to generative checkpoints (they serve per-tenant "
                f"LoRA adapters); {name} does not"
            )
        # The generative engine's knobs (sched_max_batches, max_batch,
        # ...) do not shape a classifier: ignored, as the JAX package
        # ignores sched_max_batches here.
        if meta.vocab is None:
            raise ValueError(
                f"checkpoint {path} has no label vocab; cannot serve"
            )
        state, meta = load_checkpoint(path, model)
        model.load_state_dict(state)
        model.requires_grad_(False)
        info = {"step": meta.step, "config_hash": meta.config_hash}
        if quantize is not None:
            # Dispatch below reads the inner model's input kind.
            model = _quantized(model, quantize)
            info["quantized"] = quantize
        model.to(dev)
        if getattr(model, "input_kind", "tabular") == "text":
            tokenizer = (
                tokenizer_from_fingerprint(cfg["tokenizer"])
                if "tokenizer" in cfg else load_tokenizer(model.vocab_size)
            )
            default_len = min(128, getattr(model, "max_positions", 128))
            return TextClassificationEngine(
                model, meta.vocab, tokenizer=tokenizer,
                max_len=cfg.get("max_len", default_len), buckets=buckets,
                meta=info,
            )
        return cls(model, meta.vocab, cfg.get("feature_names", ()),
                   buckets=buckets, meta=info)

    # -- shapes ------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def warmup(self) -> None:
        """One forward at every bucket size before serving: the first
        request then pays no kernel build, library handle or allocator
        growth."""
        for b in self.buckets:
            self._predict_padded(
                np.zeros((b, self.num_features), self.input_dtype))
        _log.info("warmed %d bucket shapes up to batch=%d on %s",
                  len(self.buckets), self.max_batch, self.device)

    def _predict_padded(self, x: np.ndarray) -> np.ndarray:
        """One forward over a padded ``[b, d]`` block → the fused
        ``[b, 2]`` (id, max-prob) array, after one device→host copy."""
        xt = torch.as_tensor(x)
        if not xt.is_floating_point():
            xt = xt.long()
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else _NULL)
        with ctx, torch.inference_mode():
            logits = self.model.apply(xt.to(self.device)).to(torch.float32)
            probs = torch.softmax(logits, dim=-1)
            fused = torch.stack(
                [logits.argmax(dim=-1).to(torch.float32),
                 probs.max(dim=-1).values], dim=-1,
            )
            return fused.cpu().numpy()

    # -- public API ----------------------------------------------------------
    def predict(self, x) -> tuple[np.ndarray, np.ndarray]:
        """Classify ``[n, d]`` rows → (label ids ``[n]`` int32, max-probs
        ``[n]`` float32); pads to a bucket, chunks past the largest."""
        x = np.asarray(x, self.input_dtype)
        if x.ndim != 2:
            raise ValueError(f"expected [n, d] features, got shape {x.shape}")
        n = len(x)
        ids_out = np.empty((n,), np.int32)
        probs_out = np.empty((n,), np.float32)
        start = 0
        while start < n:
            chunk = x[start:start + self.max_batch]
            b = self.bucket_for(len(chunk))
            padded = np.zeros((b, x.shape[1]), self.input_dtype)
            padded[: len(chunk)] = chunk
            fused = self._predict_padded(padded)
            ids_out[start:start + len(chunk)] = fused[: len(chunk), 0].astype(
                np.int32)
            probs_out[start:start + len(chunk)] = fused[: len(chunk), 1]
            start += len(chunk)
        return ids_out, probs_out

    def predict_labels(self, x) -> tuple[list[str], np.ndarray]:
        ids, probs = self.predict(x)
        return self.vocab.decode(ids), probs


class TextClassificationEngine(InferenceEngine):
    """Batched text classification: a tokenizer and a BERT-style model
    (counterpart of ``mlapi_tpu/serving/engine.py::
    TextClassificationEngine``). Rows are fixed-length int32 id vectors
    (``max_len``); the model derives its key mask from ``ids != pad``,
    so bucket-padding rows are all-masked and their answers dropped."""

    kind = "text"
    input_dtype = np.int32

    def __init__(self, model, vocab, *, tokenizer, max_len: int = 128,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 meta: dict | None = None):
        super().__init__(model, vocab, (), buckets=buckets, meta=meta)
        model_vocab = getattr(model, "vocab_size", None)
        if model_vocab is not None and tokenizer.vocab_size > model_vocab:
            # An id past the table would raise in the gather on the card
            # (JAX clamps it): refuse the pairing instead.
            raise ValueError(
                f"tokenizer emits ids up to {tokenizer.vocab_size - 1} but "
                f"the model's embedding table has {model_vocab} rows"
            )
        self.tokenizer = tokenizer
        self.max_len = int(max_len)
        self.num_features = self.max_len  # the row width

    def encode(self, text: str) -> np.ndarray:
        """One request's text → a fixed-length id row."""
        ids, _ = self.tokenizer.encode(text, self.max_len)
        return ids
