"""Host-RAM (optionally disk-backed) spill tier under the KV page pool.

Counterpart of ``mlapi_tpu/serving/kv_tier.py``. When the page pool
evicts an unreferenced prefix page set, or the prefix cache's own LRU
drops an entry, the victim's KV is copied to host memory as numpy blobs
in its STORED format (int8 payload and f32 scales, or the float cache
dtype) and kept under an LRU bytes budget. A later miss restores the
bytes into fresh pool pages, or rebuilds the entry, with no prefill.

Wired at two seams outside this file:

- **Spill**: ``PagePool._spill_and_release`` gathers the victim's pool
  pages and registers the blob here BEFORE the pages are freed, and
  ``PrefixCache._spill_entry`` spills an entry the prefix dict's LRU
  dropped, from the entry's own contiguous KV (the same bytes).
- **Restore**: ``PrefixCache.entry`` and ``paged_entry`` consult the
  tier on a device-cache miss.

Everything here is host metadata and numpy under one lock; no device
tensor is held. numpy has no bfloat16, so a bf16 leaf travels as its
raw bits in a ``uint16`` array (:func:`to_host`, :func:`to_device`):
the bytes, and so the byte accounting, are the cache's own. Byte
counts are dtype and shape arithmetic (a spilled set of ``n`` pages
costs ``n x kv_page_bytes``), never wall-clock.

Disk mode (``disk_dir``): payloads live in ``.npz`` files, only the
index stays in RAM, and the bytes budget bounds disk use. Files are
pid-scoped; a new tier sweeps those of dead owners, and a restore
validates shapes and page size against the live pool.
"""

from __future__ import annotations

import collections
import os
import threading

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.kv_tier")

# Leaves whose dtype numpy lacks travel as raw bits of the same width.
_BITS = {torch.bfloat16: np.uint16}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a cache leaf of ``dtype`` is held in on the
    host."""
    if dtype in _BITS:
        return np.dtype(_BITS[dtype])
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor → a host numpy array of the same bytes (one
    device-to-host copy)."""
    if t.dtype in _BITS:
        t = t.view(torch.int16)
        return t.cpu().numpy().view(_BITS[torch.bfloat16])
    return t.cpu().numpy()


def to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array (as :func:`to_host` made it) → a ``dtype`` tensor
    on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype in _BITS:
        t = t.view(torch.int16).view(dtype)
    return t.to(device)


class KVTierBlob:
    """One spilled prefix page set, host-resident: the per-layer
    ``{leaf: [num_pages, page, ...]}`` numpy payload in the cache's
    stored format, plus what rebuilding a ``_PrefixEntry`` without a
    prefill needs (``bucket`` / ``lo`` / ``used`` are ``None`` if the
    entry was never registered: a pool-page restore still works, an
    entry rebuild treats it as a miss)."""

    __slots__ = (
        "fp", "payload", "page", "num_pages", "nbytes",
        "bucket", "lo", "used",
    )

    def __init__(self, fp, payload, page, nbytes, bucket, lo, used):
        self.fp = fp
        self.payload = payload
        self.page = int(page)
        first = next(iter(next(iter(payload.values())).values()))
        self.num_pages = int(first.shape[0])
        self.nbytes = int(nbytes)
        self.bucket = bucket
        self.lo = lo
        self.used = used


class _Stored:
    """Index record: payload in RAM or a path on disk, plus the
    metadata that survives either way."""

    __slots__ = ("payload", "path", "page", "nbytes",
                 "bucket", "lo", "used")

    def __init__(self, payload, path, page, nbytes, bucket, lo, used):
        self.payload = payload      # None when disk-backed
        self.path = path            # None when RAM-resident
        self.page = page
        self.nbytes = nbytes
        self.bucket = bucket
        self.lo = lo
        self.used = used


def payload_bytes(payload: dict) -> int:
    """Exact blob bytes from dtype and shape arithmetic: an ``n``-page
    set costs exactly ``n x kv_page_bytes(model, page)``."""
    return sum(
        int(np.prod(a.shape)) * a.dtype.itemsize
        for layer in payload.values()
        for a in layer.values()
    )


def payload_from_contiguous(kv, page: int) -> dict:
    """A contiguous ``[1, P]`` cache (a prefix entry's KV, on the
    device) → the page-shaped ``[ceil(P / page), page, ...]`` numpy
    payload, zero past ``P``: the bytes the entry's adopted pool pages
    hold for every slot ``< P`` (slots past ``P`` are never read)."""
    out: dict = {}
    for ln, layer in kv.items():
        out[ln] = {}
        for name, leaf in layer.items():
            a = to_host(leaf)               # [1, P, ...]
            p = a.shape[1]
            n = -(-p // page)
            if n * page != p:
                pad = np.zeros((1, n * page - p) + a.shape[2:], a.dtype)
                a = np.concatenate([a, pad], axis=1)
            out[ln][name] = np.ascontiguousarray(
                a.reshape((n, page) + a.shape[2:])
            )
    return out


class KVTier:
    """LRU bytes-budgeted store of spilled prefix page sets, keyed by
    prefix fingerprint. Thread-safe: encode threads (entry build and
    restore, the dict-LRU spill) and the dispatch thread (pool spill,
    page restore) use it concurrently."""

    def __init__(self, max_bytes: int, disk_dir: str | None = None):
        if max_bytes <= 0:
            raise ValueError(
                f"kv_tier_bytes must be > 0 to enable the tier, got "
                f"{max_bytes}"
            )
        self.max_bytes = int(max_bytes)
        self.disk_dir = disk_dir
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            self._sweep_stale(disk_dir)
        self._lock = threading.Lock()
        # fp -> _Stored, LRU order (front = coldest).
        self._blobs: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self._seq = 0
        # Entry metadata the PrefixCache notes at build and restore (the
        # pool knows page ids, not buckets); a bounded LRU.
        self._meta: collections.OrderedDict = collections.OrderedDict()
        self._meta_cap = 4096
        self.spill_count = 0
        self.spill_bytes = 0
        self.spill_failures = 0
        self.restore_hits = 0
        self.restore_misses = 0
        self.restore_bytes = 0
        self.restore_failures = 0
        self.evictions = 0

    @staticmethod
    def _sweep_stale(disk_dir: str) -> None:
        """Unlink blob files of DEAD former owners (pid-scoped names; the
        index is per-process, so they are unreachable). A file whose
        owner is alive, or that this process cannot signal (EPERM) or
        parse, is left alone."""
        for name in os.listdir(disk_dir):
            if not (name.startswith("kvtier-") and name.endswith(".npz")):
                continue
            try:
                pid = int(name.split("-")[1])
            except (IndexError, ValueError):
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                try:
                    os.unlink(os.path.join(disk_dir, name))
                    _log.debug("swept stale tier blob %s", name)
                except OSError:
                    pass
            except OSError:
                pass  # EPERM etc.: a live process we cannot signal

    # -- accounting ----------------------------------------------------
    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._blobs)

    # -- entry metadata ------------------------------------------------
    def note_meta(self, fp, *, bucket: int, lo: int, used: int) -> None:
        """Record the entry-rebuild metadata of ``fp`` (the PrefixCache
        calls it whenever it creates or restores an entry); a later
        spill attaches it."""
        with self._lock:
            self._meta[fp] = (int(bucket), int(lo), int(used))
            self._meta.move_to_end(fp)
            while len(self._meta) > self._meta_cap:
                self._meta.popitem(last=False)

    # -- spill ---------------------------------------------------------
    def spill(self, fp, payload: dict, page: int) -> int:
        """Register a spilled page set (replacing any earlier blob of
        ``fp``), evicting LRU blobs past the bytes budget; returns the
        blob's bytes. The ``tier_spill`` fault point fires FIRST: an
        injected raise leaves the tier untouched and the caller falls
        back to discarding. Disk mode registers the blob in RAM, then
        writes the ``.npz`` outside the lock and swaps the payload for
        the path (a blob replaced or evicted meanwhile unlinks the new
        file)."""
        faults.fire("tier_spill")
        return self._register(fp, payload, page, count_spill=True)

    def stage(self, fp, payload: dict, page: int, *,
              bucket: int, lo: int, used: int) -> int:
        """Register a blob that was not evicted here (its metadata
        given), with :meth:`spill`'s LRU, budget and disk mechanics but
        no fault point and no spill counters."""
        self.note_meta(fp, bucket=bucket, lo=lo, used=used)
        return self._register(fp, payload, page, count_spill=False)

    def _register(self, fp, payload: dict, page: int,
                  count_spill: bool) -> int:
        nbytes = payload_bytes(payload)
        with self._lock:
            meta = self._meta.get(fp)
            bucket, lo, used = meta if meta else (None, None, None)
            old = self._blobs.pop(fp, None)
            if old is not None:
                self._discard_locked(old)
            if nbytes > self.max_bytes:
                # It can never fit: an eviction of itself, rather than
                # thrashing the whole tier out.
                self.evictions += 1
                _log.debug(
                    "tier blob (%d bytes) exceeds the %d-byte budget; "
                    "not stored", nbytes, self.max_bytes,
                )
                return nbytes
            path = None
            if self.disk_dir:
                path = os.path.join(
                    self.disk_dir, f"kvtier-{os.getpid()}-{self._seq}.npz"
                )
                self._seq += 1
            stored = _Stored(
                payload, None, int(page), nbytes, bucket, lo, used
            )
            self._blobs[fp] = stored
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._blobs) > 1:
                _, victim = self._blobs.popitem(last=False)  # LRU
                self._discard_locked(victim)
                self.evictions += 1
            if count_spill:
                self.spill_count += 1
                self.spill_bytes += nbytes
        if path is not None:
            try:
                np.savez(
                    path,
                    **{
                        f"{ln}|{name}": a
                        for ln, layer in payload.items()
                        for name, a in layer.items()
                    },
                )
            except Exception as e:
                # The disk refused: the blob stays in RAM, restorable,
                # the budget still enforced.
                _log.debug("tier disk write failed (%s); RAM blob", e)
                return nbytes
            with self._lock:
                live = self._blobs.get(fp)
                if live is stored and live.payload is payload:
                    live.path = path
                    live.payload = None
                else:
                    # Replaced or evicted while writing: an orphan file.
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        return nbytes

    def drop(self, fp) -> None:
        """Forget ``fp``'s blob (no-op if absent): a restore proved it
        can never apply to the live pool or model (geometry or metadata
        drift). Not counted as an eviction, which measures budget
        pressure."""
        with self._lock:
            stored = self._blobs.pop(fp, None)
            if stored is not None:
                self._discard_locked(stored)
                _log.debug("dropped inapplicable tier blob for %r", fp)

    def _discard_locked(self, stored: _Stored) -> None:
        self._bytes -= stored.nbytes
        if stored.path is not None:
            try:
                os.unlink(stored.path)
            except OSError:
                pass

    # -- restore -------------------------------------------------------
    def lookup(self, fp) -> KVTierBlob | None:
        """The blob of ``fp`` (LRU-touched), its payload read back from
        disk if need be; ``None`` counts a restore miss. The blob stays:
        a restore is a read, and a later eviction of the restored pages
        spills the same bytes again."""
        with self._lock:
            stored = self._blobs.get(fp)
            if stored is None:
                self.restore_misses += 1
                return None
            self._blobs.move_to_end(fp)
            payload = stored.payload
            path = stored.path
            page = stored.page
            nbytes = stored.nbytes
            bucket, lo, used = stored.bucket, stored.lo, stored.used
        if payload is None:
            try:
                with np.load(path) as z:
                    payload = {}
                    for key in z.files:
                        ln, name = key.split("|", 1)
                        payload.setdefault(ln, {})[name] = z[key]
            except Exception as e:
                # A vanished or corrupt file is a miss: drop the record
                # if it is still the one read (a concurrent respill may
                # have replaced it, unlinking this file).
                _log.debug("tier disk blob unreadable (%s); dropping", e)
                with self._lock:
                    if self._blobs.get(fp) is stored:
                        self._blobs.pop(fp)
                        self._discard_locked(stored)
                    self.restore_misses += 1
                return None
        return KVTierBlob(fp, payload, page, nbytes, bucket, lo, used)

    def count_restore(self, blob: KVTierBlob) -> None:
        """A blob was applied (pool pages written, or an entry rebuilt):
        count the hit and its bytes."""
        with self._lock:
            self.restore_hits += 1
            self.restore_bytes += blob.nbytes

    def count_spill_failure(self) -> None:
        """A spill fell back to discarding (from the dispatch thread or
        an encode thread, hence under the lock)."""
        with self._lock:
            self.spill_failures += 1

    def count_restore_failure(self) -> None:
        """A restore fell back to the cold path."""
        with self._lock:
            self.restore_failures += 1
