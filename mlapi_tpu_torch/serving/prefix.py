"""Shared-prefix KV caching for generative serving.

Counterpart of ``mlapi_tpu/serving/prefix.py::PrefixCache`` without its
host tier and peer fetch. One :class:`PrefixCache` per engine owns the
LRU of prefilled prefix KVs, the per-key build events (concurrent first
requests for the SAME prefix share one build; hits on other prefixes
never wait), the widened KVs of cross-prefix batches, and the
hit/miss/fallback/build counters ``/metrics`` exports. Device work (the
prefix's prefill, a widening) runs through the engine's model; every
piece of prefix state lives here.

A prefix is built on the thread that encodes its first request (an
encode executor thread under ``submit``): a fresh ``[1, bucket]`` cache
on the engine's stream, which orders it before any batch that reads it.
Pool pages are written on the device thread only, at formation
(``BatchRun._prefill_paged_prefix``).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from mlapi_tpu_torch.serving.requests import _PrefixEntry


class PrefixCache:
    def __init__(self, engine, max_entries: int = 8):
        self.eng = engine
        self.max_entries = max_entries
        # text -> _PrefixEntry, LRU-bounded (each entry holds a
        # [1, prefix_bucket] KV cache on the device).
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # Guards the LRU, the build events and the counters; never held
        # across device work.
        self._lock = threading.Lock()
        self._building: dict = {}
        # Right-aligned [1, P] widenings of entries for cross-prefix
        # batches, keyed (fp, P), LRU-bounded.
        self._wide: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.fallbacks = 0
        self.builds = 0

    def count_fallback(self) -> None:
        """A prefix request served through the plain path instead (an
        empty suffix)."""
        with self._lock:
            self.fallbacks += 1

    def entry(self, text: str) -> _PrefixEntry:
        """The KV of a shared prompt prefix, prefilled on first use and
        LRU-cached after. Concurrent first requests for the same prefix
        share one build (a per-key event); the lock guards the dict
        only, so hits on other prefixes never wait behind a build."""
        while True:
            with self._lock:
                entry = self._entries.get(text)
                if entry is not None:
                    self._entries.move_to_end(text)
                    self.hits += 1
                    return entry
                ev = self._building.get(text)
                if ev is None:
                    ev = threading.Event()
                    self._building[text] = ev
                    break
            # Another thread builds it: wait, then look again (a failed
            # build leaves it absent, and this caller builds it).
            ev.wait(timeout=600.0)
        try:
            entry = self._build(text)
            with self._lock:
                self._entries[text] = entry
                self.misses += 1
                while len(self._entries) > self.max_entries:
                    old, _ = self._entries.popitem(last=False)  # LRU
                    if self.eng.pool is not None:
                        # The entry's hold on its pages goes; rows that
                        # share them keep theirs.
                        self.eng.pool.drop_entry(old)
            return entry
        finally:
            with self._lock:
                self._building.pop(text, None)
            ev.set()

    def _plan(self, text: str):
        """Tokenize and bucket one prefix: ``(ids, bucket, lo)``."""
        eng = self.eng
        ids = eng.tokenizer.token_ids(text)
        if not ids:
            raise ValueError("prefix tokenizes to nothing")
        # Room for at least the smallest suffix bucket and one token.
        cap = eng.model.max_positions - eng.prompt_buckets[0] - 1
        if len(ids) > cap:
            raise ValueError(
                f"prefix is {len(ids)} tokens; at most {cap} fit the model "
                f"window (max_positions={eng.model.max_positions})"
            )
        bucket = min(max(eng._bucket(len(ids)), len(ids)), cap)
        if eng.pool is not None:
            # Page-align the bucket at store time: region ends and the
            # shifts between entries then fall on page boundaries, so
            # cross-prefix batches share pages instead of copying, and a
            # same-prefix batch's suffix starts on a fresh page (no COW).
            # Where the window cannot fit the aligned bucket the entry
            # stays unaligned: its rows copy the group-end page on write.
            aligned = -(-bucket // eng.pool.page) * eng.pool.page
            if aligned <= cap:
                bucket = aligned
        return ids, bucket, bucket - len(ids)

    def _build(self, text: str) -> _PrefixEntry:
        """Tokenize, validate and prefill one prefix, outside the lock:
        a plain prefill of ``[1, bucket]`` into a cache of that length
        (the prompt attends in full, no cache-read kernel)."""
        eng = self.eng
        ids, bucket, lo = self._plan(text)
        with self._lock:
            self.builds += 1
        row = np.full((1, bucket), eng.tokenizer.pad_id, np.int64)
        row[0, lo:] = ids
        with torch.inference_mode():
            kv, _ = eng.model.prefill_core(
                torch.as_tensor(row, device=eng.device),
                torch.as_tensor([lo], dtype=torch.long, device=eng.device),
                bucket,
            )
        return _PrefixEntry(text, kv, bucket, lo, len(ids))

    def paged_entry(self, fp, kv, holds: int):
        """Pool residency of a prefix entry (paged engines): ``(pages,
        need_adopt)``, the entry's page ids with ``holds`` row
        references already taken (in the pool's critical section, so a
        concurrent eviction cannot free them), and whether its
        contiguous KV must still be scattered into them (once per
        residency). Host-only: the caller adopts after every allocation
        of its batch has succeeded."""
        pool = self.eng.pool
        pages = pool.entry_pages(fp, holds=holds)
        if pages is not None:
            return pages, False
        p = next(iter(kv["layer_0"].values())).shape[1]
        pages = pool.alloc(-(-p // pool.page))
        pool.put_entry_pages(fp, pages, holds=holds)
        return pages, True

    @staticmethod
    def widen(kv, own_len: int, p_len: int):
        """``[1, own_len]`` prefix KV -> ``[1, p_len]``, right-aligned
        (its real content ends at the common region end)."""
        if own_len == p_len:
            return kv
        off = p_len - own_len
        out = {}
        for ln, layer in kv.items():
            out[ln] = {}
            for name, a in layer.items():
                wide = a.new_zeros((1, p_len) + tuple(a.shape[2:]))
                wide[:, off:] = a
                out[ln][name] = wide
        return out

    def stacked(self, reqs, p_len: int, b_pad: int):
        """The ``[b_pad, p_len]`` prefix-KV stack of a cross-prefix
        batch: each live row's own prefix right-aligned to the common
        region end (cached per ``(fp, p_len)``, so a widening runs once
        per prefix and width), dummy rows zero (fully masked by ``lo ==
        p_len``)."""
        rows = []
        with torch.inference_mode():
            for r in reqs:
                key = (r.prefix_fp, p_len)
                with self._lock:
                    wide = self._wide.get(key)
                    if wide is not None:
                        self._wide.move_to_end(key)
                if wide is None:
                    wide = self.widen(r.prefix_kv, r.prefix_len, p_len)
                    with self._lock:
                        self._wide[key] = wide
                        while len(self._wide) > 2 * self.max_entries:
                            self._wide.popitem(last=False)
                rows.append(wide)
            return {
                ln: {
                    name: torch.cat(
                        [w[ln][name] for w in rows]
                        + [torch.zeros_like(rows[0][ln][name])]
                        * (b_pad - len(rows))
                    )
                    for name in layer
                }
                for ln, layer in rows[0].items()
            }
