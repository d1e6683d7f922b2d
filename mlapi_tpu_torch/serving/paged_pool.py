"""Block-granular KV page pool for generative serving.

Counterpart of the page-lifecycle subset of
``mlapi_tpu/serving/paged_pool.py::PagePool``. The device holds one
pool of fixed-size KV pages per cache leaf per layer (``layers``); a
batch maps each of its rows' virtual tiles to pool pages through a
host page table. Everything that moved cache bytes in the contiguous
layout (admission rows, growth, compaction) becomes page-table
bookkeeping here, in plain numpy, under one lock.

Invariants:

- Page id 0 is the NULL page: never allocated, pinned at one
  reference. Unallocated table entries point at it; dummy and finished
  rows write their dead tokens into it; no row reads it unmasked.
- ``alloc`` fires the ``pool_alloc`` fault seam BEFORE it touches the
  free list and raises :class:`PagePoolExhausted` when the free list is
  short, so a reject leaves the pool consistent.
- A release below zero references fails loudly: the page may already
  belong to someone else.

Unlike the JAX package, whose programs donate the pool arrays and get
new ones back, the port's pools are written in place and never change
identity, so a failed launch cannot consume them (there is no
``PagePoolPoisoned``). Prefix-entry page sets, eviction and the host
tier are not ported.
"""

from __future__ import annotations

import threading

import numpy as np

from mlapi_tpu_torch.serving import faults

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
        self.ref = np.zeros((self.num_pages,), np.int64)
        self.ref[NULL_PAGE] = 1  # pinned forever
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        self.exhaustions = 0

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
        """Pop ``n`` free pages (one reference each), or raise
        :class:`PagePoolExhausted` with the free list untouched."""
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
        with self.lock:
            if len(self._free) < n:
                self.exhaustions += 1
                raise PagePoolExhausted(
                    f"KV page pool exhausted: need {n} pages, "
                    f"{len(self._free)} free of {self.pages_total} "
                    f"(page={self.page} tokens); raise --kv-pages or "
                    f"lower concurrency"
                )
            out = np.asarray([self._free.pop() for _ in range(n)], np.int32)
            self.ref[out] = 1
            return out

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
        if not len(pages):
            return
        with self.lock:
            np.subtract.at(self.ref, pages, 1)
            if np.any(self.ref[pages] < 0):
                bad = pages[self.ref[pages] < 0]
                self.ref[bad] = 0
                raise AssertionError(
                    f"KV page(s) {sorted(set(int(p) for p in bad))} "
                    "released below zero references"
                )
            freed = np.unique(pages[self.ref[pages] == 0])
            self._free.extend(int(p) for p in freed)

    def is_shared(self, page: int) -> bool:
        with self.lock:
            return bool(self.ref[page] > 1)
