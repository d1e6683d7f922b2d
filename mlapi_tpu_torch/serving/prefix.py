"""Shared-prefix KV caching for generative serving.

Counterpart of ``mlapi_tpu/serving/prefix.py::PrefixCache`` without its
peer fetch. One :class:`PrefixCache` per engine owns the LRU of
prefilled prefix KVs, the per-key build events (concurrent first
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

The host tier (``serving/kv_tier.py``, ``--kv-tier-bytes``): this cache
is the client of both its seams. An entry falling off this dict's LRU
spills its contiguous KV to the tier before it goes, and a device-cache
miss consults the tier before a cold prefill: :meth:`entry` rebuilds
the entry from a spilled blob (no prefill: ``builds`` does not move),
and :meth:`paged_entry` restores an evicted pool page set from the blob
(``PagePool.restore_entry``) instead of adopting the contiguous KV
again. A restore writes the bytes that were spilled, so greedy streams
cannot tell evict-then-restore from never evicted. Without a tier every
path here is the tier-less one.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.requests import _PrefixEntry
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.prefix")


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
            # A device-cache miss: the host tier first (a spilled blob
            # rebuilds the entry with no prefill), then the cold build.
            # Either way it is a miss; the tier counts the restore.
            entry = self._restore(text)
            if entry is None:
                entry = self._build(text)
            tier = self.eng.kv_tier
            if tier is not None:
                # What a later spill must attach (the pool's spill seam
                # knows page ids, not buckets).
                tier.note_meta(text, bucket=entry.bucket, lo=entry.lo,
                               used=entry.used)
            evicted = []
            with self._lock:
                self._entries[text] = entry
                self.misses += 1
                while len(self._entries) > self.max_entries:
                    old, old_e = self._entries.popitem(last=False)  # LRU
                    evicted.append(old_e)
                    if self.eng.pool is not None:
                        # The entry's hold on its pages goes; rows that
                        # share them keep theirs. The pool does not
                        # spill here: the entry's contiguous KV below
                        # holds the same bytes.
                        self.eng.pool.drop_entry(old)
            for old_e in evicted:
                # Outside the lock: the spill copies a [1, P] cache to
                # the host, and other prefixes' lookups must not wait.
                self._spill_entry(old_e)
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

    # -- host-tier seams (serving/kv_tier.py; no-ops without a tier) ----
    def _restore(self, text: str) -> _PrefixEntry | None:
        """The tier consult on a device-cache miss: a spilled blob of
        ``text`` rebuilds the entry from its stored bytes (no prefill),
        else ``None`` (the cold build). Geometry drift drops the blob
        and goes cold; any other failure (an injected ``tier_restore``
        raise included) is counted and goes cold. The JAX package's
        next source, a warm peer's blob, is not ported (ROADMAP Queue A
        item 7c)."""
        tier = self.eng.kv_tier
        if tier is None:
            return None
        blob = tier.lookup(text)   # absent: a counted restore miss
        if blob is None:
            return None
        entry = None
        try:
            faults.fire("tier_restore")
            entry = self._entry_from_blob(text, blob)
        except Exception as e:
            tier.count_restore_failure()
            _log.debug("tier entry restore failed (%s); cold prefill", e)
        if entry is not None:
            tier.count_restore(blob)
        return entry

    def _entry_from_blob(self, text: str, blob) -> _PrefixEntry | None:
        """Blob payload ``{layer: {leaf: [n, page, ...]}}`` → the
        ``[1, bucket]`` contiguous entry KV on the device, the bytes the
        build produced (slots past ``bucket`` in the last page are
        sliced off). ``None`` when the blob's recorded geometry is not
        what a cold build would produce today (the blob is dropped), or
        when it carries no metadata (kept: a pool-page restore can still
        use it)."""
        from mlapi_tpu_torch.serving.kv_tier import to_device

        if blob.bucket is None:
            return None
        ids, bucket, lo = self._plan(text)
        if (blob.bucket != bucket or blob.lo != lo or blob.used != len(ids)
                or blob.num_pages * blob.page < bucket):
            self.eng.kv_tier.drop(text)
            _log.debug("tier blob geometry drifted for %r; cold prefill",
                       text)
            return None
        like = self.eng.model.init_cache(1, 1, device="meta")
        kv = {
            ln: {
                name: to_device(
                    a.reshape((1, a.shape[0] * a.shape[1]) + a.shape[2:])
                    [:, :bucket], like[ln][name].dtype, self.eng.device)
                for name, a in layer.items()
            }
            for ln, layer in blob.payload.items()
        }
        return _PrefixEntry(text, kv, bucket, lo, len(ids))

    def _spill_entry(self, entry: _PrefixEntry) -> None:
        """Spill an entry the dict's LRU dropped to the host tier, from
        its own contiguous ``[1, P]`` KV (never the pool's tensors),
        page-shaped at the pool's page size (paged engines, so the blob
        is interchangeable with a pool spill) or as one bucket-wide page
        (contiguous engines). A failure (an injected ``tier_spill``
        raise included) falls back to discarding, counted."""
        from mlapi_tpu_torch.serving.kv_tier import payload_from_contiguous

        tier = self.eng.kv_tier
        if tier is None:
            return
        pool = self.eng.pool
        page = pool.page if pool is not None else entry.bucket
        try:
            tier.note_meta(entry.fp, bucket=entry.bucket, lo=entry.lo,
                           used=entry.used)
            tier.spill(entry.fp, payload_from_contiguous(entry.kv, page),
                       page)
        except Exception as e:
            tier.count_spill_failure()
            _log.debug("tier entry spill failed (%s); evicting cold", e)

    def paged_entry(self, fp, kv, holds: int):
        """Pool residency of a prefix entry (paged engines): ``(pages,
        need_adopt)``, the entry's page ids with ``holds`` row
        references already taken (in the pool's critical section, so a
        concurrent eviction cannot free them), and whether its
        contiguous KV must still be scattered into them (once per
        residency). The caller adopts after every allocation of its
        batch has succeeded. With a tier, a set that was evicted (and
        spilled) is restored from its blob first, alloc-first
        (``PagePool.restore_entry``): a :class:`PagePoolExhausted`
        there propagates with nothing half-installed, any other
        failure (an injected ``tier_restore`` raise included) is
        counted and falls back to the adopt, pages conserved."""
        pool = self.eng.pool
        pages = pool.entry_pages(fp, holds=holds)
        if pages is not None:
            return pages, False
        tier = self.eng.kv_tier
        if tier is not None:
            from mlapi_tpu_torch.serving.paged_pool import PagePoolExhausted

            blob = tier.lookup(fp)   # absent: a counted restore miss
            if blob is not None:
                try:
                    # Alloc-first: exhaustion propagates with nothing
                    # installed (the adopt below would need the same
                    # pages and fail the same way).
                    pages = pool.restore_entry(fp, blob, holds=holds)
                except PagePoolExhausted:
                    raise
                except Exception as e:
                    tier.count_restore_failure()
                    _log.debug("tier page restore failed (%s); adopting",
                               e)
                    pages = None
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
