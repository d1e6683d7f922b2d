"""Block-granular KV page pool for generative serving.

Counterpart of ``mlapi_tpu/serving/paged_pool.py::PagePool`` without
its host tier. The device holds one pool of fixed-size KV pages per
cache leaf per layer (``layers``); a batch maps each of its rows'
virtual tiles to pool pages through a host page table. Everything that
moved cache bytes in the contiguous layout (admission rows, growth,
compaction, a shared prefix in every row) becomes page-table
bookkeeping here, in plain numpy, under one lock: the free list,
per-page reference counts, and the page sets of prefix entries, which
rows share by reference.

Invariants:

- Page id 0 is the NULL page: never allocated, pinned at one
  reference. Unallocated table entries point at it; dummy and finished
  rows write their dead tokens into it; no row reads it unmasked.
- A page with one reference is privately owned and writable; more
  than one means shared (prefix pages), and a writer copies it first
  (``models/gpt.paged_cow_fn`` and a table rewrite).
- ``alloc`` fires the ``pool_alloc`` fault seam BEFORE it touches the
  free list. When the free list is short it evicts prefix-entry page
  sets that no row references, least recently used first, and raises
  :class:`PagePoolExhausted` only when that is not enough, so a reject
  leaves the pool consistent.
- A release below zero references fails loudly: the page may already
  belong to someone else.

Unlike the JAX package, whose programs donate the pool arrays and get
new ones back, the port's pools are written in place and never change
identity, so a failed launch cannot consume them (there is no
``PagePoolPoisoned``).

With a :class:`~mlapi_tpu_torch.serving.kv_tier.KVTier` attached
(``self.tier``, ``--kv-tier-bytes``), eviction SPILLS the victim's pages
to host memory before it frees them: the victim is claimed (popped)
under the lock, its pages are gathered on the stream that writes the
pool and copied to the host outside the lock, and only then released,
so the bytes exist somewhere at every instant; an ``alloc`` that finds
no free pages and no victim while another eviction is in flight waits
for that release. A later miss restores the blob into fresh pages
(:meth:`restore_entry`) instead of adopting the entry's contiguous KV
again. Without a tier, eviction releases the pages and the entry's
contiguous KV adopts into fresh pages on its next use.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.paged_pool")

NULL_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free KV pages: the pool is sized too small for the offered
    concurrency. A capacity signal, surfaced loudly (HTTP 503 with
    ``retry-after``)."""


class PagePool:
    def __init__(self, model, *, page_size: int, num_pages: int):
        from mlapi_tpu_torch.ops.quant import kv_page_bytes, make_paged_pools

        if page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(
                f"kv_pages must be >= 2 (one null + one usable), got "
                f"{num_pages}"
            )
        self.page = int(page_size)
        self.num_pages = int(num_pages)
        # One [num_pages, page, H, D | 1] tensor per cache leaf per layer,
        # on the model's device, written in place by every batch.
        self.layers = make_paged_pools(model, self.num_pages, self.page)
        self.page_bytes = kv_page_bytes(model, self.page)
        self.lock = threading.Lock()
        # An eviction spills outside the lock; an alloc that finds no
        # free pages and no victim waits on this for one in flight.
        self._evict_cond = threading.Condition(self.lock)
        self._evicting = 0
        self.ref = np.zeros((self.num_pages,), np.int64)
        self.ref[NULL_PAGE] = 1  # pinned forever
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        # Prefix fingerprint -> the entry's page ids, LRU order. Each
        # page of a set holds one reference for the entry itself.
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.exhaustions = 0
        # Counted under the lock: the device thread moves them while
        # /metrics reads them from the event loop.
        self.cow_copies = 0
        self.entry_evictions = 0
        # The host tier (serving/kv_tier.py), attached by the engine
        # when kv_tier_bytes > 0; None: eviction discards.
        self.tier = None

    # -- accounting (read by /metrics) ---------------------------------
    @property
    def pages_total(self) -> int:
        """Allocatable pages (the null page is bookkeeping, not
        capacity)."""
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        with self.lock:
            return self.pages_total - len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages referenced more than once (the null page excluded)."""
        with self.lock:
            return int(np.sum(self.ref[NULL_PAGE + 1:] > 1))

    @property
    def utilization(self) -> float:
        return self.pages_in_use / max(1, self.pages_total)

    # -- allocation ----------------------------------------------------
    def alloc(self, n: int) -> np.ndarray:
        """Pop ``n`` free pages (one reference each). Under pressure,
        evict prefix-entry page sets that no row references, LRU first;
        still short: raise :class:`PagePoolExhausted`."""
        if n == 0:
            return np.zeros((0,), np.int32)
        # Injection point, before any free-list change: an armed test
        # forces exhaustion here and the pool stays consistent.
        if faults.armed:
            faults.fire(
                "pool_alloc",
                exc=PagePoolExhausted(
                    f"KV page pool exhausted (injected fault): need {n} "
                    f"pages"
                ),
            )
        while True:
            with self.lock:
                if len(self._free) >= n:
                    out = np.asarray([self._free.pop() for _ in range(n)],
                                     np.int32)
                    self.ref[out] = 1
                    return out
                victim = self._pop_victim_locked()
                if victim is None:
                    if self._evicting:
                        # Another thread's eviction is mid-spill: its
                        # pages free the moment it ends.
                        self._evict_cond.wait(timeout=5.0)
                        continue
                    self.exhaustions += 1
                    raise PagePoolExhausted(
                        f"KV page pool exhausted: need {n} pages, "
                        f"{len(self._free)} free of {self.pages_total} "
                        f"(page={self.page} tokens); raise --kv-pages or "
                        f"lower concurrency"
                    )
                self._evicting += 1
            # Outside the lock: the victim's pages keep their entry
            # references (the set is popped, so no other thread can find
            # or free them) while the spill copies them to the host.
            self._spill_and_release(*victim)

    def _pop_victim_locked(self):
        """Claim (pop) the least recently used prefix-entry page set
        whose pages only the entry holds (one reference each), or
        ``None``. The pop is the claim: the pages keep the entry's
        references until :meth:`_spill_and_release` frees them."""
        victim = next(
            (fp for fp, pages in self._entries.items()
             if np.all(self.ref[pages] == 1)),
            None,
        )
        if victim is None:
            return None
        return victim, self._entries.pop(victim)

    def _spill_and_release(self, fp, pages) -> None:
        """Spill a claimed victim to the host tier (when attached), then
        free its pages. Runs outside the lock (the caller counted it in
        ``_evicting``). The gather runs on the stream that writes the
        pool, and its ``.cpu()`` copy completes before the release, so
        no later write can reach the pages first. A spill failure (an
        injected ``tier_spill`` raise included) leaves the tier
        untouched and falls back to discarding, counted; it never
        strands pages. The PrefixCache entry survives either way."""
        from mlapi_tpu_torch.serving.kv_tier import to_host

        try:
            if self.tier is not None:
                try:
                    idx = torch.as_tensor(
                        np.asarray(pages, np.int64),
                        device=next(iter(self.layers["layer_0"].values()))
                        .device,
                    )
                    payload = {
                        ln: {name: to_host(leaf.index_select(0, idx))
                             for name, leaf in layer.items()}
                        for ln, layer in self.layers.items()
                    }
                    self.tier.spill(fp, payload, self.page)
                except Exception as e:
                    self.tier.count_spill_failure()
                    _log.debug("tier spill failed (%s); evicting cold", e)
        finally:
            with self.lock:
                # Before the release: a failing release must not leave
                # waiters on a phantom eviction.
                self._evicting -= 1
                self._release_locked(np.asarray(pages))
                self.entry_evictions += 1

    def _blob_geometry_ok(self, blob) -> bool:
        """Does a host blob match this pool's page size and every
        layer's leaf shapes and dtypes?"""
        from mlapi_tpu_torch.serving.kv_tier import host_dtype

        if blob.page != self.page:
            return False
        for ln, layer in self.layers.items():
            pl = blob.payload.get(ln)
            if pl is None:
                return False
            for name, leaf in layer.items():
                a = pl.get(name)
                if (a is None or tuple(a.shape[1:]) != tuple(leaf.shape[1:])
                        or a.dtype != host_dtype(leaf.dtype)):
                    return False
        return True

    def _scatter_blob(self, pages, blob, *, fire: str | None) -> None:
        """Write a blob's ``[n, page, ...]`` payload into pool pages
        ``pages`` of every leaf, in place (``index_copy_``, on the
        stream that writes the pool). On any failure the pages go back
        (``kv_pages_in_use`` conserved); the fault point fires before
        the first write."""
        from mlapi_tpu_torch.serving.kv_tier import to_device

        try:
            if fire is not None:
                faults.fire(fire)
            dev = next(iter(self.layers["layer_0"].values())).device
            idx = torch.as_tensor(np.asarray(pages, np.int64), device=dev)
            for ln, layer in self.layers.items():
                for name, leaf in layer.items():
                    leaf.index_copy_(0, idx, to_device(
                        blob.payload[ln][name], leaf.dtype, dev))
        except BaseException:
            self.release(pages)
            raise

    def restore_entry(self, fp, blob, holds: int = 0):
        """Fill fresh pool pages from a spilled tier blob and register
        them as ``fp``'s entry page set (with ``holds`` row references,
        as :meth:`put_entry_pages`). Pages are ALLOCATED first (a
        :class:`PagePoolExhausted` leaves nothing installed and nothing
        written), the ``tier_restore`` fault point fires before any
        write, registration comes last. Returns the page ids, or
        ``None`` when the blob does not match this pool's geometry
        (then dropped from the tier). Dispatch thread only."""
        if not self._blob_geometry_ok(blob):
            self.tier.drop(blob.fp)
            return None
        pages = self.alloc(blob.num_pages)
        self._scatter_blob(pages, blob, fire="tier_restore")
        self.put_entry_pages(fp, pages, holds=holds)
        self.tier.count_restore(blob)
        return pages

    def evict_idle(self, n: int = 1) -> int:
        """Drop up to ``n`` idle (unreferenced, LRU-first) prefix-entry
        page sets, the eviction ``alloc`` runs under pressure (claimed
        under the lock, spilled and freed outside it); returns how many
        went."""
        dropped = 0
        while dropped < n:
            with self.lock:
                victim = self._pop_victim_locked()
                if victim is not None:
                    self._evicting += 1
            if victim is None:
                break
            self._spill_and_release(*victim)
            dropped += 1
        return dropped

    def retain(self, pages) -> None:
        """One more holder of each page (null entries ignored)."""
        pages = np.asarray(pages).ravel()
        pages = pages[pages != NULL_PAGE]
        if len(pages):
            with self.lock:
                np.add.at(self.ref, pages, 1)

    def release(self, pages) -> None:
        """Drop one hold per page; pages at zero references return to
        the free list. Null entries are ignored, so callers can release
        whole table rows."""
        pages = np.asarray(pages).ravel()
        pages = pages[pages != NULL_PAGE]
        if len(pages):
            with self.lock:
                self._release_locked(pages)

    def _release_locked(self, pages) -> None:
        np.subtract.at(self.ref, pages, 1)
        if np.any(self.ref[pages] < 0):
            bad = pages[self.ref[pages] < 0]
            self.ref[bad] = 0
            raise AssertionError(
                f"KV page(s) {sorted(set(int(p) for p in bad))} "
                "released below zero references"
            )
        freed = np.unique(pages[self.ref[pages] == 0])
        if len(freed):
            self._free.extend(int(p) for p in freed)
            # Wake an alloc waiting out an in-flight eviction.
            self._evict_cond.notify_all()

    def is_shared(self, page: int) -> bool:
        with self.lock:
            return bool(self.ref[page] > 1)

    # -- prefix-entry page sets ----------------------------------------
    def entry_pages(self, fp, holds: int = 0) -> np.ndarray | None:
        """The pool-resident page set of a prefix entry, if any (marked
        most recently used), with ``holds`` row references taken in the
        same critical section, so an eviction cannot free the set
        between the lookup and its use."""
        with self.lock:
            pages = self._entries.get(fp)
            if pages is not None:
                self._entries.move_to_end(fp)
                if holds:
                    np.add.at(self.ref, pages, holds)
            return pages

    def put_entry_pages(self, fp, pages, holds: int = 0) -> None:
        """Register an entry's freshly allocated page set (each page's
        one reference is the entry's own hold) with ``holds`` row
        references added under the same lock, so the set is never seen
        evictable while a batch is about to use it."""
        with self.lock:
            pages = np.asarray(pages, np.int32)
            if holds:
                np.add.at(self.ref, pages, holds)
            self._entries[fp] = pages

    def drop_entry(self, fp) -> None:
        """Release a prefix entry's page set (no-op if it was never
        paged in or was evicted already); rows sharing the pages keep
        their holds, and the pages free when the last one goes."""
        with self.lock:
            pages = self._entries.pop(fp, None)
            if pages is not None:
                self._release_locked(pages)
