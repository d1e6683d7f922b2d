"""One batch's lifecycle: formation, prefill, continuous admission,
chained decode chunks, compaction.

Counterpart of ``mlapi_tpu/serving/batch_run.py::BatchRun``, cut to
what this port serves:

======================  ================================================
``__init__``            formation: bucket/cache tier, the prefix region,
                        host mirrors (``_pack_rows``), batch padding to
                        a power of 2
``_prefill``            shared-prefix prefill (the suffix as one
                        flash-extend block behind the cached prefix),
                        plain prefill, or chunked prefill of a prompt
                        past the largest bucket (flash-extend reads);
                        ``_prefill_paged`` for a paged engine, whose
                        prefix rows share the entry's pages
                        (``_prefill_paged_prefix``)
``_first_token``        the first token's delivery, and the speculation
                        gates (solo rows; freshly formed all-greedy
                        batches)
``_spec_handoff``       the formation-time speculative phase (solo or
                        batched, ``serving/spec_phase.py``), handing off
                        to the chunk loop; ``_paged_realign`` the paged
                        handoff's table shift or repack
``_alloc_rows`` et al.  the page lifecycle of a paged engine: rows map
                        only the pages of slots they reached, released
                        eagerly when a row finishes
``_admit_waiting``      mid-batch admission of staged joiners into free
                        (or grown) rows at a chunk boundary
``_pf_step`` et al.     interleaved chunked prefill: a long-prompt
                        joiner of a paged batch prefills one chunk per
                        decode-chunk boundary into private pages, then
                        joins as a page-table row assignment
``_maybe_shrink``       compaction along the power-of-two chain
``_decode_chunk``       one chained decode chunk + the drain policy
``units``               the loop as a generator of typed units, which
                        the unit scheduler advances one at a time; the
                        deadline sweeps run at its boundaries, and a
                        lone greedy row speculates again there
``run``                 drain ``units()`` to exhaustion
======================  ================================================

Host mirrors (``n_pad``, ``temps``, ``topk``, ``topp``, ``seeds``,
``tok``, ``step``, ``lo``, and a paged engine's page table ``tab``) are the
source of truth, rebound together on every resize; the device holds
the KV cache and the chained feedback token. Anything that mutates
batch state first ``chain.invalidate()``s. Caches are written in place:
a contiguous batch owns its ``[B, total]`` cache, a paged batch writes
the engine pool's tensors through its own table (re-uploaded whenever
the host table changes).

Prefix rows batch at formation only, never by admission (the running
batch's prefix region is a batch-wide layout). A long-prompt joiner of
a contiguous batch is prefilled in one admission once ``pos`` reaches
its bucket, as in the JAX package.

Adapters: ``arow[row]`` is the device row's adapter slot (0, the
all-zero NULL slot, for base rows), a host mirror like ``n_pad``. Every
member's adapter is acquired (installed if need be, and held) before the
prefill, a joiner's before its own prefill, and every hold is released
when the run ends. Each dispatch passes the model the adapter context
:meth:`_lora` picks: none (no adapter row: the base model's ops), grouped
(one tenant: ``x @ a @ b``) or gathered (mixed: BGMV).

Fused widths (``serving/fused_single.py``): a batch formed with no
streaming row decodes in tier-wide chunks, each one ``"decode"`` unit
through the same ``decode_chunk_fn``; the width is set per boundary
after the spec re-engagement check and before compaction, the
interleaved prefill step and the page mapping, which maps the whole
width before the dispatch. Not ported: disaggregation.
"""

from __future__ import annotations

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.dispatch import DispatchChain
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.batch_run")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchRun:
    """Decode one coalesced batch, streaming chunks to each request; a
    ``None`` sentinel marks a request's completion (error delivery
    lives in the engine's ``_run_batch``). With ``admit=True`` (the
    collector's batches) waiting requests staged by the collector join
    the running batch at chunk boundaries."""

    def __init__(self, eng, reqs: list, admit: bool = False,
                 fused_ok: bool = True) -> None:
        self.eng = eng
        self.reqs = reqs  # the engine's list object: admission appends
        self.admit = admit
        # Brownout's speculation suppression counts once per run, however
        # many boundaries re-confirm it.
        self._spec_supp_counted = False
        self.bucket = max(len(r.row) for r in reqs)
        n_new_max = max(r.n_new for r in reqs)
        # The prefix region spans slots [0, p_len) of every row. A
        # same-prefix batch shares one entry's KV (scalar lo); a
        # cross-prefix batch right-aligns each row's own prefix to the
        # common region end p_len, masked by a per-row lo (lo == p_len:
        # an empty region, the dummy rows').
        self.p_len = max(r.prefix_len for r in reqs)
        self.p_lo = reqs[0].prefix_lo
        self.mixed_prefix = bool(self.p_len) and any(
            r.prefix_fp != reqs[0].prefix_fp or r.prefix_len != self.p_len
            for r in reqs
        )
        self.total = eng._cache_len(self.p_len + self.bucket, n_new_max)
        self.n_new_max = min(n_new_max,
                             self.total - self.p_len - self.bucket)
        b = len(reqs)
        # Pad the batch to a power of two, as the JAX engine does to
        # bound its compiled shapes; dummy rows are fully masked. It
        # grows (admission) and shrinks (compaction) along that chain.
        self.b, self.b_pad, self.b_max = b, _pow2(b), _pow2(eng.max_batch)
        # The top fused-chunk width of a batch of non-streaming rows (0
        # pins the plain eng.chunk, as fused_ok=False does), and whether
        # this run was counted in fused_calls.
        self.fused_w = eng.fused.chunk_width(self) if fused_ok else 0
        self._fused_counted = False
        (self.prompt, self.n_pad, self.temps, self.topk, self.topp,
         self.seeds) = eng._pack_rows(reqs, self.bucket, self.b_pad)
        self.lo = np.full((self.b_pad,), self.p_len, np.int64)
        for i, r in enumerate(reqs):
            self.lo[i] = self.p_len - r.prefix_len + r.prefix_lo
        # Per-row adapter slot mirror (0: base), the holds this run took
        # (released at its end), and whether its adapter mode (grouped
        # or gathered) was counted.
        self.arow = np.zeros((self.b_pad,), np.int64)
        self._adapter_holds: list = []
        self._adapter_counted = False
        self.device = eng.device
        # Paged: tab[row, i] maps virtual tile i of device row ``row``
        # to a pool page (0 = the null page).
        self.pool = eng.pool
        self.page = self.pool.page if self.pool is not None else 0
        self.npv = -(-self.total // self.page) if self.pool is not None else 0
        self.tab = (np.zeros((self.b_pad, self.npv), np.int32)
                    if self.pool is not None else None)
        self._tab_dirty = False
        # The active interleaved prefill of a long-prompt joiner (paged
        # batches), and its run of consecutive prefill-chunk dispatches.
        self._pf: dict | None = None
        self._pf_consec = 0
        # rows[i]: request i's row in the (possibly resized) batch.
        self.rows: list = list(range(b))
        self.b_cur = self.b_pad
        self.cache = None
        try:
            # Every member's adapter is made resident and held BEFORE
            # any device work: a miss (unknown id, slots exhausted)
            # fails the formation with nothing half-installed.
            for i, r in enumerate(reqs):
                self.arow[i] = self._acquire_adapter(r)
            s0 = int(self.arow[0])
            if s0 and bool(np.all(self.arow[:b] == s0)):
                # One tenant: the masked dummy rows take its slot too,
                # so the grouped path applies.
                self.arow[:] = s0
            first = self._prefill()
            self.pos = self.p_len + self.bucket
            self._first_token(first)
            self.chain = DispatchChain(self._deliver)
        except BaseException:
            # Formation failed (a PagePoolExhausted included): give
            # every held page and adapter back; the engine delivers the
            # error.
            self._paged_cleanup()
            self._release_adapters()
            raise

    # -- formation ----------------------------------------------------

    def _prefill(self):
        """Run the batch's prefill into ``self.cache``; returns the
        ``[B]`` device tensor of first sampled tokens."""
        from mlapi_tpu_torch.models.gpt import (
            extend_chunk_fn, prefill_fn, prefix_prefill_fn, sample_fn,
        )

        if self.pool is not None:
            return self._prefill_paged()
        eng = self.eng
        bucket, total = self.bucket, self.total
        prompt = self._prompt_dev()
        cp = eng.prompt_buckets[-1]
        if self.p_len:
            # Shared-prefix batch: the prefix KV goes into every row and
            # only the suffix block is computed. A cross-prefix batch
            # passes the per-row right-aligned stack and lo vector.
            kv = (eng.prefix.stacked(self.reqs, self.p_len, self.b_pad)
                  if self.mixed_prefix else self.reqs[0].prefix_kv)
            first, self.cache = prefix_prefill_fn(
                eng.model, kv, prompt, self._n_pad_dev(), self._lo_arg(),
                self.seeds, self.temps, self.topk, self.topp, total=total,
            )
            return first
        if bucket > cp and bucket % cp == 0:
            # Chunked prefill: the long prompt runs as cp-wide
            # extend_core blocks, each reading the cache written so far
            # (flash-extend under decode_attn_impl="flash").
            self.cache = eng.model.init_cache(self.b_pad, total)
            logits = None
            for c0 in range(0, bucket, cp):
                faults.fire("prefill_chunk")
                for r in self.reqs:
                    eng._expire_if_due(r, "prefill")
                eng.prefill_chunks += 1
                self.cache, logits = extend_chunk_fn(
                    eng.model, self.cache, prompt[:, c0:c0 + cp], c0,
                    self._n_pad_dev(), lora=self._lora(),
                )
            return sample_fn(
                logits, self.seeds, self.temps, self.topk, self.topp
            )
        first, self.cache = prefill_fn(
            eng.model, prompt, self.seeds, self.temps, self._n_pad_dev(),
            self.topk, self.topp, total_len=total, lora=self._lora(),
        )
        return first

    def _prefill_paged(self):
        """Paged formation, page-native: each row maps the pages of its
        REAL tokens (pad-slot writes land in the null page), then the
        bucket prefill (``paged_prefill_fn``), or the chunked prefill of
        a long prompt (``paged_extend_fn`` blocks), writes K/V through
        the table straight into the pool."""
        from mlapi_tpu_torch.models.gpt import (
            paged_extend_fn, paged_prefill_fn, sample_fn,
        )
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        eng, bucket = self.eng, self.bucket
        if self.p_len:
            return self._prefill_paged_prefix()
        # Host phase first: an exhausted pool raises before device work.
        for i in range(self.b):
            self._alloc_rows([i], int(self.n_pad[i]), bucket)
        self.cache = paged_cache_tree(self.pool.layers, self.tab)
        self._tab_dirty = False
        prompt = self._prompt_dev()
        n_pad = self._n_pad_dev()
        cp = eng.prompt_buckets[-1]
        if bucket > cp and bucket % cp == 0:
            logits = None
            for c0 in range(0, bucket, cp):
                faults.fire("prefill_chunk")
                for r in self.reqs:
                    eng._expire_if_due(r, "prefill")
                eng.prefill_chunks += 1
                self.cache, logits = paged_extend_fn(
                    eng.model, self.cache, prompt[:, c0:c0 + cp], c0, n_pad,
                    lora=self._lora(),
                )
            return sample_fn(
                logits, self.seeds, self.temps, self.topk, self.topp
            )
        first, self.cache = paged_prefill_fn(
            eng.model, self.cache, prompt, 0, self.seeds, self.temps, n_pad,
            self.topk, self.topp, lora=self._lora(),
        )
        return first

    def _prefill_paged_prefix(self):
        """Paged shared-prefix formation. Every live row's table points
        at its entry's pool pages (one reference per row) and only the
        suffix block is computed. A same-prefix batch shares one page
        set. A cross-prefix batch shares each row's own set at a tile
        shift when every right-alignment shift ``P - prefix_len`` is a
        page multiple (entries page-align their buckets, so this is the
        norm); otherwise it copies widened stacks into private pages,
        counted in ``kv_prefix_copy_fallback``. When ``P`` is not a page
        multiple the suffix's first slots fall in the group-end page, so
        each row copies that page first (COW). Dummy rows keep null
        tables.

        The host phase makes every allocation that can raise before any
        device work; the device phase then adopts (an entry's first
        residency), copies, COWs, and runs one suffix extend."""
        from mlapi_tpu_torch.models.gpt import (
            paged_cow_fn, paged_extend_fn, paged_scatter_fn, sample_fn,
        )
        from mlapi_tpu_torch.ops.quant import kv_tree_bytes, paged_cache_tree

        eng, reqs, pool = self.eng, self.reqs, self.pool
        P, page = self.p_len, self.page
        npp = -(-P // page)
        adopts: list = []   # (fp, kv, pages) to scatter, first use only
        shared: list = []   # (row, entry pages) to COW
        srcs, dsts = [], []
        mixed_copy = False
        try:
            if not self.mixed_prefix:
                # holds=b: every live row's reference is taken with the
                # lookup, so an eviction can drop only the entry's own.
                r0 = reqs[0]
                pages, need = eng.prefix.paged_entry(
                    r0.prefix_fp, r0.prefix_kv, holds=self.b)
                if need:
                    adopts.append((r0.prefix_fp, r0.prefix_kv, pages))
                for i in range(self.b):
                    self.tab[i, :len(pages)] = pages
                    shared.append((i, pages))
            elif all((P - r.prefix_len) % page == 0 for r in reqs):
                # Aligned cross-prefix group: each row shares its own
                # entry's pages, starting at its shift's tile.
                for i, r in enumerate(reqs):
                    pages, need = eng.prefix.paged_entry(
                        r.prefix_fp, r.prefix_kv, holds=1)
                    if need:
                        adopts.append((r.prefix_fp, r.prefix_kv, pages))
                    t0 = (P - r.prefix_len) // page
                    self.tab[i, t0:t0 + len(pages)] = pages
                    shared.append((i, pages))
            else:
                # Sub-page shifts, which page identity cannot express:
                # widened per-row stacks in private pages.
                eng.kv_prefix_copy_fallback += 1
                mixed_copy = True
                self._alloc_rows(range(self.b), 0, npp * page)
            if P % page:
                # The group-end page is partly prefix and the suffix
                # writes into it: each sharing row gets its own copy.
                for i, pages in shared:
                    own = int(pool.alloc(1)[0])
                    srcs.append(int(pages[-1]))
                    dsts.append(own)
                    pool.release([pages[-1]])
                    self.tab[i, npp - 1] = own
            # Suffix pages behind the prefix region.
            self._alloc_rows(range(self.b), npp * page, P + self.bucket)
        except BaseException:
            # An entry registered in this phase holds no bytes yet: it
            # must not outlive the failed formation.
            for fp, _, _ in adopts:
                pool.drop_entry(fp)
            raise
        self.cache = paged_cache_tree(pool.layers, self.tab)
        self._tab_dirty = False
        if mixed_copy:
            stack = eng.prefix.stacked(reqs, P, self.b_pad)
            paged_scatter_fn(self.cache, stack, self.tab[:, :npp], 0)
        for _, kv, pages in adopts:
            # Once per residency: the entry's contiguous KV becomes
            # pool-resident (counted apart from any per-batch copy).
            eng.prefix_adopt_bytes += kv_tree_bytes(kv)
            paged_scatter_fn(self.cache, kv, np.asarray(pages)[None], 0)
        if srcs:
            with pool.lock:
                pool.cow_copies += len(srcs)
            paged_cow_fn(self.cache, srcs, dsts)
        self.cache, logits = paged_extend_fn(
            eng.model, self.cache, self._prompt_dev(), P, self._n_pad_dev(),
            P, self._lo_arg(),
        )
        return sample_fn(logits, self.seeds, self.temps, self.topk, self.topp)

    # -- per-tenant adapters (serving/adapter_store.py) ----------------

    def _acquire_adapter(self, req) -> int:
        """A request's adapter as a resident, held slot (installed from
        the host store on a miss); the hold is released when the run
        ends, so a live batch's adapter is never evicted under it. 0
        (the NULL slot) for a base request."""
        aid = getattr(req, "adapter", None)
        if aid is None:
            return 0
        slot = self.eng.adapters.acquire(aid, self.eng.adapter_store)
        self._adapter_holds.append(aid)
        return slot

    def _release_adapters(self) -> None:
        """Drop every hold this run took (idempotent). The slots stay
        resident, warm for the tenant's next request, and evictable."""
        while self._adapter_holds:
            self.eng.adapters.release(self._adapter_holds.pop())

    def _lora(self):
        """The adapter context of this batch's next dispatch: None when
        no row carries an adapter (the base model's ops), GROUPED (every
        row one tenant: an int slot) or GATHERED (mixed: the per-row
        slot vector, base and dummy rows at the NULL slot). Decided on
        the host per dispatch; the mode is counted once per run."""
        eng = self.eng
        if eng.adapters is None:
            return None
        rows = self.arow[:self.b_cur]
        if not rows.any():
            return None
        grouped = bool(np.all(rows == rows[0]))
        if not self._adapter_counted:
            self._adapter_counted = True
            if grouped:
                eng.adapter_grouped_batches += 1
            else:
                eng.adapter_gathered_batches += 1
        if grouped:
            return eng.adapters.batch_params(slot=int(rows[0]))
        return eng.adapters.batch_params(rows=rows)

    def _lora1(self, slot: int):
        """The context of a one-row dispatch (a joiner's own prefill):
        its tenant's slot, or None for a base joiner."""
        if not slot:
            return None
        return self.eng.adapters.batch_params(slot=slot)

    def _lo_arg(self):
        """The prefix region's start: a per-row upload of the ``lo``
        mirror for a cross-prefix batch, else the shared scalar."""
        if self.mixed_prefix:
            return torch.as_tensor(self.lo, dtype=torch.long,
                                   device=self.device)
        return self.p_lo

    def _prompt_dev(self):
        return torch.as_tensor(self.prompt, dtype=torch.long,
                               device=self.device)

    def _n_pad_dev(self):
        """A fresh upload of the ``n_pad`` mirror (it changes on every
        admission and resize)."""
        return torch.as_tensor(self.n_pad, dtype=torch.long,
                               device=self.device)

    def _spec_brownout(self) -> bool:
        """Brownout rung 1 suppresses speculation; re-decided at every
        consultation (the queue may drain), counted in
        ``brownout_spec_suppressed`` at most once per run."""
        if self.eng._brownout_level() < 1:
            return False
        if not self._spec_supp_counted:
            self._spec_supp_counted = True
            self.eng.brownout_spec_suppressed += 1
        return True

    def _first_token(self, first) -> None:
        """Decide the first token's delivery. The speculative phase
        reads and writes the host token mirror, so a batch it takes
        syncs the first token here; every other batch keeps it on the
        device as the first chunk's feedback, delivered by the first
        drain.

        Speculation is declined for prefix rows (``p_len > 0``), adapter
        rows (the phase drafts and verifies with the base weights, which
        would emit the base model's stream for a tenant row), sampled
        rows without ``spec_sample``, batches of more than one row
        unless every row is greedy and the cache holds a final round,
        and under brownout. (The port has no disaggregated rows, Queue A
        item 7, so none is pushed.)"""
        eng, reqs, b = self.eng, self.reqs, self.b
        temps, topk, topp = self.temps, self.topk, self.topp
        greedy = (temps <= 0.0) & (topk == 0) & (topp >= 1.0)
        base = (eng.draft_model is not None and self.p_len == 0
                and all(getattr(r, "adapter", None) is None for r in reqs))
        self.spec_eligible = (
            base and b == 1 and not reqs[0].cancelled
            and (bool(greedy[0]) or (eng.spec_sample and temps[0] > 0.0))
            and not self._spec_brownout()
        )
        # Batched: a freshly formed all-greedy batch speculates as a
        # whole at per-row positions and realigns the cache before the
        # chunk loop resumes; the final round's block needs k + 1 slots
        # past every row's budget.
        self.spec_batched = (
            base and b > 1 and bool(np.all(greedy[:b]))
            and self.total >= self.bucket + self.n_new_max + eng.spec_k + 1
            and not self._spec_brownout()
        )
        # step[row]: the row's NEXT sampling-stream index, its own
        # produced-token count, so a joiner reproduces its solo stream.
        self.step = np.ones((self.b_pad,), np.int64)
        self.done = [False] * b
        if self.spec_eligible or self.spec_batched:
            self.tok = first.cpu().numpy().astype(np.int64)
            self.produced = [1] * b
            for i, r in enumerate(reqs):
                r.push({"token_ids": [int(self.tok[i])]})
                if r.n_new <= 1:
                    r.push(None)
                    self.done[i] = True
            self.first_chunk = None
        else:
            self.tok = np.zeros((self.b_pad,), np.int64)
            self.produced = [0] * b
            self.first_chunk = first[:, None]
        # produced as of the DISPATCH frontier (scheduled on the device,
        # possibly not yet drained); ``produced`` is what was delivered.
        self.sched = list(self.produced)
        # The solo row's emitted tokens, replayed into a fresh draft
        # cache when it speculates again.
        self.spec_hist = [int(self.tok[0])] if self.spec_eligible else None
        self._first = first

    # -- the page lifecycle (paged engines) ---------------------------

    def _alloc_rows(self, rows, lo_slot: int, hi_slot: int) -> None:
        """Map pool pages for virtual slots ``[lo_slot, hi_slot)`` of
        the given rows, skipping tiles already mapped. Raises
        :class:`PagePoolExhausted` before any table change."""
        if hi_slot <= lo_slot:
            return
        want = [
            (row, i)
            for row in rows
            for i in range(lo_slot // self.page, -(-hi_slot // self.page))
            if self.tab[row, i] == 0
        ]
        if not want:
            return
        pages = self.pool.alloc(len(want))
        for (row, i), pid in zip(want, pages):
            self.tab[row, i] = pid
        self._tab_dirty = True

    def _spec_ensure(self, cache, lo: int, hi: int):
        """The speculative phase's page hook before each verify block:
        map virtual slots ``[lo, hi)`` for every live row (the phase
        writes ahead of the chunk loop's ``_ensure_pages``) and hand back
        the cache with any new table. An exhausted pool raises, as at a
        chunk boundary."""
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        self._alloc_rows(
            sorted({
                self.rows[i] for i, r in enumerate(self.reqs)
                if self.rows[i] is not None and not self.done[i]
                and not r.cancelled
            }),
            lo, min(hi, self.total),
        )
        if self._tab_dirty:
            self._tab_dirty = False
            return paged_cache_tree(cache, self.tab[:self.b_cur])
        return cache

    def _paged_realign(self, cache, delta: np.ndarray, top: int):
        """The batched-speculation handoff's realign, paged: rows shift
        right by ``delta[row]``. When every delta is a page multiple this
        is a HOST table edit: each row's table rolls right by ``delta /
        page`` tiles (the leading tiles go null, masked by the caller's
        ``n_pad`` bump; tail pages shifted off are released), and no
        cache byte moves (``spec_realign_table_ops``). Otherwise the
        live rows map their destination slots and ``paged_realign_fn``
        rewrites them on the device (``spec_realign_repacks``)."""
        from mlapi_tpu_torch.models.gpt import paged_realign_fn
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        eng, page = self.eng, self.page
        if np.all(delta % page == 0):
            for row in range(self.b_cur):
                s = int(delta[row]) // page
                if s == 0:
                    continue
                self.pool.release(self.tab[row, self.npv - s:])
                self.tab[row] = np.roll(self.tab[row], s)
                self.tab[row, :s] = 0
            eng.spec_realign_table_ops += 1
            self._tab_dirty = False
            return paged_cache_tree(cache, self.tab[:self.b_cur])
        # A finished row's shifted bytes are never read again: only live
        # rows map their destination slots (the rest die in the null
        # page).
        for i, r in enumerate(self.reqs):
            row = self.rows[i]
            if row is None or self.done[i] or r.cancelled:
                continue
            self._alloc_rows([row], int(self.n_pad[row] + delta[row]), top)
        if self._tab_dirty:
            self._tab_dirty = False
            cache = paged_cache_tree(cache, self.tab[:self.b_cur])
        eng.spec_realign_repacks += 1
        return paged_realign_fn(cache, delta)

    def _release_row(self, row: int) -> None:
        """Null a row's table and drop its page holds. Chunks already
        enqueued may still write the released pages through the table
        they were given; the stream runs them before any later owner's
        writes, and a row reads only slots it wrote itself."""
        if self.tab[row].any():
            self.pool.release(self.tab[row])
            self.tab[row] = 0
            self._tab_dirty = True

    def _release_finished(self) -> None:
        """Free finished and cancelled rows' pages eagerly (a long batch
        must not sit on dead sequences' pages), and detach each such
        request from its row, which may pass to a joiner."""
        for i, r in enumerate(self.reqs):
            row = self.rows[i]
            if row is not None and (self.done[i] or r.cancelled):
                self._release_row(row)
                self.rows[i] = None

    def _paged_cleanup(self) -> None:
        """Release every page of every row (idempotent; also the error
        path). The pool tensors were written in place and stay with
        the pool."""
        if self.pool is None or self.tab is None:
            return
        if self._pf is not None:
            # An interleaved prefill in progress holds private pages.
            self._pf_abort()
        for row in range(len(self.tab)):
            self._release_row(row)

    def _with_tables(self) -> None:
        """Pair the pool tensors with a fresh upload of the host
        table."""
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        self.cache = paged_cache_tree(self.cache, self.tab[:self.b_cur])
        self._tab_dirty = False

    def _ensure_pages(self, size: int, live: list) -> None:
        """Chunk-boundary allocation: the next ``size`` steps write
        slots ``[pos, pos + size)``; map them for every live row (dummy
        and finished rows write into the null page), then upload any
        table change before the dispatch reads it."""
        self._alloc_rows(
            sorted({self.rows[i] for i in live}),
            self.pos, min(self.pos + size, self.total),
        )
        if self._tab_dirty:
            self._with_tables()

    # -- shared bookkeeping -------------------------------------------

    def _mirrors_take(self, sel: np.ndarray) -> None:
        """Rebind every host mirror through a row gather, all together,
        so no stage sees a half-resized batch."""
        self.n_pad, self.temps, self.topk, self.topp = (
            self.n_pad[sel], self.temps[sel], self.topk[sel],
            self.topp[sel],
        )
        self.seeds, self.tok, self.step, self.lo, self.arow = (
            self.seeds[sel], self.tok[sel], self.step[sel], self.lo[sel],
            self.arow[sel],
        )

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
                if self.spec_hist is not None and i == 0:
                    self.spec_hist.extend(chunk_ids.tolist())
                self.produced[i] += got
                if want <= got:
                    r.push(None)
                    self.done[i] = True

    def _sdone(self, i: int) -> bool:
        """done[] as of the dispatch frontier."""
        return self.done[i] or self.sched[i] >= self.reqs[i].n_new

    # -- speculative phases -------------------------------------------

    def _try_spec(self) -> None:
        """Speculate while this batch is one eligible row: the phase
        hands back to the chunk loop when other work waits, and is
        tried again at later boundaries once the row is alone (its
        history replays into a fresh draft cache)."""
        if self.spec_hist is None or self.done[0] or self.reqs[0].cancelled:
            return
        self.cache, self.pos = self.eng.spec.run_solo(
            self.reqs[0], self.cache, self.pos, self.total, self.bucket,
            self.tok, self.step, self.produced, self.n_pad, self.seeds,
            self.spec_hist, self.temps, self.topk, self.topp,
            ensure=self._spec_ensure if self.pool is not None else None,
        )
        self.sched[0] = self.produced[0]
        if self.produced[0] >= self.reqs[0].n_new:
            self.reqs[0].push(None)
            self.done[0] = True

    def _spec_handoff(self) -> None:
        """The formation-time speculative phase (solo or batched),
        leaving ``(cache, pos, tok, produced)`` ready for the chunk
        loop."""
        self._try_spec()
        if self.spec_batched and not all(self.done):
            paged = self.pool is not None
            self.cache, self.pos = self.eng.spec.run_batched(
                self.reqs, self.cache, self.pos, self.total, self.prompt,
                self.tok, self.step, self.produced, self.done, self.n_pad,
                self.b_pad,
                ensure=self._spec_ensure if paged else None,
                paged_realign=self._paged_realign if paged else None,
            )
            self.sched[:] = self.produced

    # -- continuous admission -----------------------------------------

    def _grow(self) -> list:
        """Double the batch; the new rows are dummies (fully masked)
        until admitted into. Paged growth moves no cache bytes: new
        rows get null tables. Contiguous growth appends zero rows to
        every cache leaf. Returns the new rows."""
        self.chain.invalidate()
        n = self.b_cur
        sel = np.concatenate([np.arange(n), np.zeros(n)]).astype(np.int64)
        if self.pool is not None:
            self.tab = np.vstack([self.tab, np.zeros_like(self.tab)])
            self._tab_dirty = True
        else:
            self.cache = {
                ln: {name: torch.cat([leaf, torch.zeros_like(leaf)])
                     for name, leaf in layer.items()}
                for ln, layer in self.cache.items()
            }
        self._mirrors_take(sel)
        self.n_pad[n:] = self.pos  # mask dummies fully
        self.temps[n:] = 0.0
        self.b_cur = 2 * n
        self.eng.growths += 1
        return list(range(n, 2 * n))

    def _never_admissible(self, r) -> bool:
        """Its budget overruns the running cache's remaining room; pos
        only grows, so this batch can never take it."""
        return self.pos + (r.n_new - 1) > self.total

    def _admissible(self, r) -> bool:
        """Can ``r`` join now: its prompt bucket fits below ``pos``
        (which grows) and its budget inside the cache."""
        return len(r.row) <= self.pos and not self._never_admissible(r)

    def _unstage(self, cand) -> bool:
        """Take ``cand`` off the staging list; False if it was no longer
        there (the collector reclaimed it first)."""
        eng = self.eng
        with eng._alock:
            try:
                eng._admit.remove(cand)
            except ValueError:
                return False
            return True

    def _admit_waiting(self) -> int:
        """Admit staged joiners into free (or grown) rows at a chunk
        boundary; returns the number still staged (the compaction
        policy reads it)."""
        eng, reqs = self.eng, self.reqs
        with eng._alock:
            candidates = list(eng._admit)
        n_live = sum(
            1 for i, r in enumerate(reqs)
            if not self.done[i] and not r.cancelled
        )
        if self._pf is not None:
            n_live += 1  # the interleaved joiner owns its row already
        cp = eng.prompt_buckets[-1]
        for cand in candidates:
            if eng._expire_if_due(cand, "queued"):
                # Its deadline passed while staged: never prefilled.
                self._unstage(cand)
                continue
            if cand.cancelled:
                self._unstage(cand)
                continue
            if self.p_len or cand.prefix_fp is not None:
                # Prefix rows batch at formation only: the next batch.
                if self._unstage(cand):
                    eng._defer(cand)
                continue
            if (getattr(cand, "adapter", None) is not None
                    and not eng.adapters.can_claim([cand.adapter])):
                # Every slot is pinned by live holds: the acquire would
                # fail mid-admission. The next formation (fresh holds)
                # takes it.
                if self._unstage(cand):
                    eng._defer(cand)
                continue
            bkt = len(cand.row)
            if self.pool is not None and bkt > cp and bkt % cp == 0:
                # A long-prompt joiner: its prefill chunks interleave
                # with this batch's decode chunks (``_pf_step``).
                if self._try_start_pf(cand, n_live):
                    n_live += 1
                continue
            if self._never_admissible(cand):
                # A budget past this cache: the next batch.
                if self._unstage(cand):
                    eng._defer(cand)
                continue
            if n_live + 1 > eng.max_batch:
                break
            if not self._admissible(cand):
                continue
            used_rows = self._used_rows()
            free = [j for j in range(self.b_cur) if j not in used_rows]
            grow = not free and self.b_cur < self.b_max
            if not free and not grow:
                break
            # Committed: mirrors (and maybe the layout) change, so the
            # dispatch chain ends here.
            self.chain.invalidate()
            if not self._unstage(cand):
                continue
            if grow:
                free = self._grow()
            row = free[0]
            self._detach(row)
            if self.pool is not None:
                from mlapi_tpu_torch.serving.paged_pool import (
                    PagePoolExhausted,
                )

                # Drop the old holder's pages; the joiner maps only its
                # REAL-token span.
                self._release_row(row)
                try:
                    self._alloc_rows([row], self.pos - cand.used, self.pos)
                except PagePoolExhausted:
                    # The pool is momentarily full of live sequences:
                    # the next batch, not an error.
                    eng._defer(cand)
                    continue
            try:
                # Between the joiner's page alloc and its install.
                faults.fire("table_install")
                # Its adapter is held BEFORE its prefill dispatches; a
                # miss here is the joiner's alone (the except below).
                jslot = self._acquire_adapter(cand)
                ftok = self._install(cand, row, jslot)
            except Exception as e:  # noqa: BLE001 — the joiner's alone
                # The joiner's pages go back and it gets its error; the
                # running batch's mirrors and cache were not touched
                # for it, so it streams on unchanged.
                _log.warning(
                    "admission of joiner failed (%s); running batch "
                    "continues", e,
                )
                if self.pool is not None:
                    self._release_row(row)
                try:
                    cand.push(e)
                except Exception:  # noqa: BLE001 — a dead loop
                    pass
                cand.cancel()
                continue
            self.n_pad[row] = self.pos - cand.used
            self.temps[row] = cand.temperature
            self.topk[row] = cand.top_k
            self.topp[row] = cand.top_p
            self.seeds[row] = cand.seed
            # The row changes owner: its adapter slot ALWAYS follows (a
            # finished tenant's stale slot would adapt this joiner).
            self.arow[row] = jslot
            self.tok[row] = ftok
            self.step[row] = 1
            reqs.append(cand)
            self.rows.append(row)
            self.produced.append(1)
            self.sched.append(1)
            cand.push({"token_ids": [ftok]})
            fin = cand.n_new <= 1
            if fin:
                cand.push(None)
            self.done.append(fin)
            if not fin:
                n_live += 1
            eng.admitted += 1
        with eng._alock:
            return len(eng._admit)

    def _used_rows(self) -> set:
        """Device rows owned by live requests or the interleaved
        joiner."""
        used = {
            self.rows[i] for i, r in enumerate(self.reqs)
            if not self.done[i] and not r.cancelled
        }
        if self._pf is not None:
            used.add(self._pf["row"])
        return used

    def _detach(self, row: int) -> None:
        """The row may still belong to a request that finished or was
        cancelled (in a drain just before, say): detach it, so that
        request never again names (or releases) the new owner's row."""
        for k, held in enumerate(self.rows):
            if held == row:
                self.rows[k] = None

    def _install(self, cand, row: int, slot: int = 0) -> int:
        """The joiner's prefill into ``row``, its prompt ending at slot
        ``pos``; returns its first token. Paged: one page-native
        prefill through a one-row table at virtual offset ``pos -
        bucket``. Contiguous: a ``[1, bucket]`` prefill copied into the
        row (the JAX package's ``admit_scatter_fn``)."""
        from mlapi_tpu_torch.models.gpt import paged_prefill_fn, prefill_fn
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        eng = self.eng
        bkt = len(cand.row)
        ids = torch.as_tensor(cand.row[None], dtype=torch.long,
                              device=self.device)
        n_pad = torch.as_tensor([bkt - cand.used], dtype=torch.long,
                                device=self.device)
        host = (
            np.asarray([cand.seed], np.int64),
            np.asarray([cand.temperature], np.float32),
        )
        topk = np.asarray([cand.top_k], np.int64)
        topp = np.asarray([cand.top_p], np.float32)
        off = self.pos - bkt
        if self.pool is not None:
            cache1 = paged_cache_tree(self.cache, self.tab[row:row + 1])
            first, _ = paged_prefill_fn(
                eng.model, cache1, ids, off, *host, n_pad, topk, topp,
                lora=self._lora1(slot),
            )
            self._tab_dirty = True
        else:
            first, mini = prefill_fn(
                eng.model, ids, *host, n_pad, topk, topp, total_len=bkt,
                lora=self._lora1(slot),
            )
            for ln, layer in self.cache.items():
                for name, leaf in layer.items():
                    leaf[row, off:off + bkt] = mini[ln][name][0]
        return int(first[0])

    # -- interleaved chunked prefill (paged long-prompt joiners) ------
    #
    # A long prompt's prefill is ceil(used / cp) extend dispatches. Run
    # back to back they would stall every stream of the batch for the
    # whole prompt; here ``_admit_waiting`` stages the joiner as
    # ``self._pf``, one prefill chunk dispatches per decode-chunk
    # boundary (``_pf_step``) into the joiner's private pages, and once
    # the chunks are done and ``pos`` reaches the planned activation
    # point A, ``_pf_activate`` installs the joiner by assigning its
    # page-table row. The prompt lands at virtual slots [A - bucket, A);
    # during the window ``pos`` advances by ``chunk`` per boundary, so
    # compaction waits. The joiner's batch row stays a dummy (null
    # table) until activation, and all-pad leading chunks are skipped.

    def _try_start_pf(self, cand, n_live: int) -> bool:
        """Begin the interleaved prefill of ``cand``. True only when
        the window started (the joiner owns a row); otherwise the
        candidate was handed back (a window that can never fit this
        cache, an exhausted pool) or stays staged (another prefill
        active, a full batch)."""
        from mlapi_tpu_torch.serving.paged_pool import PagePoolExhausted

        eng = self.eng
        if self._pf is not None or n_live + 1 > eng.max_batch:
            return False
        cp = eng.prompt_buckets[-1]
        bkt, used = len(cand.row), cand.used
        bkt_eff = -(-used // cp) * cp
        n_run = bkt_eff // cp
        # A covers n_run boundaries, or the catch-up to the prompt's
        # own length, whichever is later; chunks dispatch from the first
        # boundary (their slots depend on A, not on pos).
        m = max(n_run, -(-max(bkt_eff - self.pos, 0) // eng.chunk))
        a = self.pos + m * eng.chunk
        if a + (cand.n_new - 1) > self.total:
            # Can never finish inside this cache: its own batch.
            if self._unstage(cand):
                eng._defer(cand)
            return False
        free = [j for j in range(self.b_cur) if j not in self._used_rows()]
        if not free:
            if self.b_cur >= self.b_max:
                return False
            free = self._grow()
        row = free[0]
        self._detach(row)
        self._release_row(row)  # a finished request's leftover pages
        try:
            # The joiner's adapter is held before any pool pages move.
            pf_slot = self._acquire_adapter(cand)
        except Exception as e:  # noqa: BLE001 — the joiner's alone
            from mlapi_tpu_torch.serving.adapter_store import (
                AdapterSlotsExhausted,
            )

            self._unstage(cand)
            if isinstance(e, AdapterSlotsExhausted):
                # Slots momentarily pinned by live runs: next batch.
                eng._defer(cand)
                return False
            # Unresolvable: its terminal frame; the batch and the pool
            # were not touched.
            try:
                cand.push(e)
            except Exception:  # noqa: BLE001 — a dead loop
                pass
            cand.cancel()
            return False
        # Private table: the prompt's pages belong to ``ptab`` until
        # activation, so decode writes for the dummy row stay in the
        # null page.
        ptab = np.zeros((1, self.npv), np.int32)
        lo_tile = (a - used) // self.page
        hi_tile = -(-a // self.page)
        try:
            pages = self.pool.alloc(hi_tile - lo_tile)
        except PagePoolExhausted:
            # The pool is momentarily full of live sequences.
            if self._unstage(cand):
                eng._defer(cand)
            return False
        if not self._unstage(cand):
            self.pool.release(pages)
            return False
        ptab[0, lo_tile:hi_tile] = pages
        self._pf = {
            "cand": cand, "row": row, "ptab": ptab, "A": a,
            "off": a - bkt, "cp": cp, "skip": (bkt - bkt_eff) // cp,
            "next": 0, "n_run": n_run, "logits": None, "slot": pf_slot,
        }
        eng.interleaved_prefills += 1
        eng.prefill_chunk_queue_depth = n_run
        return True

    def _pf_dispatch_chunk(self) -> None:
        """The next prefill chunk through the joiner's private table
        (its offset is already batch-virtual: activation remaps
        nothing)."""
        from mlapi_tpu_torch.models.gpt import paged_extend_fn
        from mlapi_tpu_torch.ops.quant import paged_cache_tree

        eng, pf = self.eng, self._pf
        cand, cp = pf["cand"], pf["cp"]
        c0 = (pf["skip"] + pf["next"]) * cp
        faults.fire("prefill_chunk")
        eng.prefill_chunks += 1
        cache1 = paged_cache_tree(self.cache, pf["ptab"])
        ids = torch.as_tensor(cand.row[None, c0:c0 + cp], dtype=torch.long,
                              device=self.device)
        n_pad = torch.as_tensor([pf["A"] - cand.used], dtype=torch.long,
                                device=self.device)
        _, pf["logits"] = paged_extend_fn(
            eng.model, cache1, ids, pf["off"] + c0, n_pad,
            lora=self._lora1(pf["slot"]),
        )
        pf["next"] += 1
        eng.prefill_chunk_queue_depth = pf["n_run"] - pf["next"]

    def _pf_abort(self) -> None:
        """Drop an interleaved prefill: its private pages go back;
        nothing was installed, so no batch state unwinds."""
        self.pool.release(self._pf["ptab"])
        self._pf = None
        self.eng.prefill_chunk_queue_depth = 0

    def _pf_step(self, live: list) -> None:
        """At most ONE prefill chunk before this boundary's decode
        chunk (``eng.interleave_max_stall`` records the run)."""
        eng, pf = self.eng, self._pf
        # A joiner whose deadline passed mid-prefill aborts its window.
        eng._expire_if_due(pf["cand"], "prefill")
        if pf["cand"].cancelled:
            self._pf_abort()
            return
        if pf["next"] >= pf["n_run"]:
            return  # chunks done; waiting for pos to reach A
        self._pf_dispatch_chunk()
        if live:
            self._pf_consec += 1
            eng.interleave_max_stall = max(eng.interleave_max_stall,
                                           self._pf_consec)

    def _pf_activate(self) -> None:
        """``pos`` reached A with every chunk dispatched: sample the
        first token from the last chunk's logits (stream index 0, the
        formation's draw) and install the joiner as a live row by
        assigning its table row; no cache bytes move."""
        from mlapi_tpu_torch.models.gpt import sample_fn

        eng, pf = self.eng, self._pf
        cand, row = pf["cand"], pf["row"]
        self.chain.invalidate()  # the mirrors are about to change
        if cand.cancelled:
            self._pf_abort()
            return
        # A raise here fails the batch: ``units()`` appends the joiner
        # so it gets its terminal frame, and the cleanup frees ptab.
        faults.fire("table_install")
        first = sample_fn(
            pf["logits"], np.asarray([cand.seed], np.int64),
            np.asarray([cand.temperature], np.float32),
            np.asarray([cand.top_k], np.int64),
            np.asarray([cand.top_p], np.float32),
        )
        ftok = int(first[0])
        self._detach(row)
        self._release_row(row)
        self.tab[row] = pf["ptab"][0]
        self._tab_dirty = True
        self.n_pad[row] = pf["A"] - cand.used
        self.temps[row] = cand.temperature
        self.topk[row] = cand.top_k
        self.topp[row] = cand.top_p
        self.seeds[row] = cand.seed
        self.arow[row] = pf["slot"]
        self.tok[row] = ftok
        self.step[row] = 1
        self.reqs.append(cand)
        self.rows.append(row)
        self.produced.append(1)
        self.sched.append(1)
        cand.push({"token_ids": [ftok]})
        fin = cand.n_new <= 1
        if fin:
            cand.push(None)
        self.done.append(fin)
        eng.admitted += 1
        self._pf = None
        eng.prefill_chunk_queue_depth = 0

    def _pf_flush(self) -> None:
        """No live decode row is left to stall: run the remaining
        chunks back to back, jump ``pos`` to A (the slots between
        belong to no one) and activate."""
        pf = self._pf
        self.chain.drain()
        if pf["cand"].cancelled:
            self._pf_abort()
            return
        while pf["next"] < pf["n_run"]:
            self._pf_dispatch_chunk()
        self.pos = pf["A"]
        self._pf_activate()

    # -- resize -------------------------------------------------------

    def _maybe_shrink(self, live: list, pending_n: int) -> None:
        """Halve the batch when enough rows finished (one halving per
        chunk); never while joiners wait. Paged compaction releases the
        dropped rows' pages and gathers the table, moving no cache
        bytes; contiguous compaction gathers the cache rows."""
        want_b = max(_pow2(len(live)), self.b_cur // 2)
        if want_b >= self.b_cur or pending_n:
            return
        self.chain.invalidate()
        sel = [self.rows[i] for i in live]
        sel += [sel[0]] * (want_b - len(sel))
        sel = np.asarray(sel, np.int64)
        if self.pool is not None:
            keep = {self.rows[i] for i in live}
            for row in range(self.b_cur):
                if row not in keep:
                    self._release_row(row)
            # Pad rows get null tables: a duplicated row would alias
            # live pages.
            self.tab = self.tab[sel]
            self.tab[len(live):] = 0
            self._tab_dirty = True
            self._mirrors_take(sel)
            self.n_pad[len(live):] = self.pos
            self.temps[len(live):] = 0.0
        else:
            idx = torch.as_tensor(sel, device=self.device)
            self.cache = {
                ln: {name: leaf.index_select(0, idx)
                     for name, leaf in layer.items()}
                for ln, layer in self.cache.items()
            }
            self._mirrors_take(sel)
        self.rows = [None] * len(self.reqs)
        for row, i in enumerate(live):
            self.rows[i] = row
        self.b_cur = want_b
        self.eng.compactions += 1

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
            eng.model, self.cache, tok, self.pos, self._n_pad_dev(),
            self.temps, self.seeds, self.step, self.topk, self.topp,
            chunk=size, prefix_len=self.p_len, prefix_lo=self._lo_arg(),
            lora=self._lora(),
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
        """The lifecycle as a stream of typed units: yields
        ``"prefill"``, ``"decode"``, ``"spec"``, ``"admit"`` or
        ``"compact"`` after each. Every page goes back to the pool when
        the generator ends, raises or is closed."""
        try:
            yield from self._units()
        except BaseException:
            if self._pf is not None:
                # The interleaved joiner left the staging list but was
                # never installed: the error delivery must reach it.
                self.reqs.append(self._pf["cand"])
            raise
        finally:
            self._paged_cleanup()
            self._release_adapters()

    def _units(self):
        eng, reqs, chain = self.eng, self.reqs, self.chain
        self._spec_handoff()
        if self.spec_eligible or self.spec_batched:
            # The phase ran (it yields at round boundaries when other
            # work waits: engine._spec_should_yield).
            yield "spec"
        if self.first_chunk is not None:
            # The deferred first token rides the chain as a width-1
            # chunk.
            all_rows = list(range(self.b))
            chain.push(self.first_chunk, 1, all_rows)
            for i in all_rows:
                self.sched[i] += 1
            chain.tok_dev = self._first
        while True:
            if (self._pf is not None and self._pf["next"] >= self._pf["n_run"]
                    and self.pos >= self._pf["A"]):
                # The interleaved prefill is done and decode reached its
                # activation point: install the joiner.
                self._pf_activate()
                yield "admit"
            # Deadline sweep: an expired row gets its terminal frame and
            # is cancelled like a disconnect.
            for i, r in enumerate(reqs):
                if not self.done[i]:
                    eng._expire_if_due(r, "decode")
            if self.pool is not None:
                # Before admission, so joiners can take these pages.
                self._release_finished()
            pending_n = 0
            if self.admit and eng._admit:
                pending_n = self._admit_waiting()
                yield "admit"
            live = [
                i for i, r in enumerate(reqs)
                if not self._sdone(i) and not r.cancelled
            ]
            if not live:
                if self._pf is not None:
                    # Nothing left to stall: finish the interleaved
                    # prefill back to back; the joiner becomes the
                    # batch's only live row.
                    self._pf_flush()
                    yield "prefill"
                    continue
                chain.drain()
                if not all(self.done):
                    eng.cancelled_batches += 1
                break
            # Speculate again once the batch is one eligible row (its
            # joiners left); never during an interleaved prefill (rounds
            # would move pos off its activation plan), and the brownout
            # test last, so it counts only an engagement it blocked.
            if (
                self.spec_hist is not None and self.b_cur == 1
                and live == [0] and not pending_n and self._pf is None
                and reqs[0].n_new - self.sched[0] > 1
                and self.pos + 1 + eng.spec_k + 1 <= self.total
                and not self._spec_brownout()
            ):
                chain.invalidate()
                self._try_spec()
                yield "spec"
                if self.done[0]:
                    continue
            # Fused width: tier-wide chunks for a batch with no live
            # streaming row, shrunk to the live rows' remaining budgets
            # (serving/fused_single.py). Counted once a run, at its
            # first fused-width dispatch.
            w = self.fused_w and eng.fused.width_at(self, live)
            if w and not self._fused_counted:
                self._fused_counted = True
                eng.fused_calls += 1
            # The last chunk may be remainder-sized when the window
            # clamps the cache tier.
            size = min(w or eng.chunk, self.total - self.pos)
            if size <= 0:
                chain.drain()
                break
            b_before = self.b_cur
            # An interleaved prefill pins the row plan: no compaction.
            self._maybe_shrink(live, pending_n + (self._pf is not None))
            if self.b_cur != b_before:
                yield "compact"
            if self._pf is not None:
                pfc = eng.prefill_chunks
                self._pf_step(live)
                if eng.prefill_chunks != pfc:
                    yield "prefill"
            if self.pool is not None:
                # Map the chunk's write range before the dispatch: an
                # exhausted pool fails here, its metadata consistent.
                self._ensure_pages(size, live)
            self._decode_chunk(size, live)
            self._pf_consec = 0
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
