"""Many-adapter LoRA serving: one resident base, paged adapters
(counterpart of ``mlapi_tpu/serving/adapter_store.py``, without the
fleet tier).

The base model's weights stay on the card ONCE and each tenant adds only
its ``(a, b)`` pairs, so N resident tenants cost exactly ``base_bytes +
N x slot_bytes`` (dtype and shape arithmetic). Two tiers:

- :class:`AdapterStore`, the host tier: registered adapter payloads
  under an LRU bytes budget, optionally spilled to disk as their exact
  wire image (:func:`serialize_adapter`, WIRE_VERSION 1: byte-identical
  to the JAX package's; this wire code and the store are a copy of its
  numpy code).
- :class:`AdapterSlots`, the device tier: per layer and adapted target
  one ``a [S+1, d_in, r]`` and one ``b [S+1, r, d_out]`` tensor; slot 0
  is the permanently-zero NULL slot, so base rows in a mixed batch
  gather an exactly-zero delta. An install writes one slot of every
  pool IN PLACE (``index_copy_`` into the preallocated tensors), so a
  failed install leaves the pools readable: the JAX package's donated
  scatter and its ``AdapterPoolPoisoned`` have no counterpart here.
  Hold-free residents evict LRU under pressure.

A batch's adapter context (:meth:`AdapterSlots.batch_params`) is handed
to the model call explicitly (``lora=``; ``models/lora.lora_apply``):
per layer the full slot pools plus an int ``"slot"`` (every row one
tenant, the grouped path) or a per-row ``"rows"`` tensor (mixed
tenants, the gathered BGMV of ``ops/bgmv.py``). A batch without adapter
rows passes no context and runs the base model's ops unchanged.

Threading: only the dispatch thread installs or evicts. Encode threads
resolve ids against the host store; ``/metrics`` and the scheduler read
lock-guarded host maps.

The fleet tier (``AdapterPeer``, ``GET /adapter/<id>``) waits for
ROADMAP Queue A item 7.
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.adapter_store")

WIRE_VERSION = 1
# Header line length cap, same rationale as the KV peer wire: a few
# dozen layers of leaf manifests fit in a few KB; anything larger is
# a corrupt/hostile response, refused before allocation.
_MAX_HEADER_BYTES = 1 << 20

# Adapter ids ride URL paths, HTTP headers, and disk filenames raw —
# the grammar is locked down so none of those channels needs escaping
# (and a hostile id can never traverse paths or split headers).
ADAPTER_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class AdapterUnavailable(RuntimeError):
    """A request named an adapter this replica cannot resolve — not
    registered, not in the host store, and not fetchable from a warm
    peer. Surfaced as the request's terminal error (HTTP 404): the
    caller named a tenant that does not exist here, which is their
    bug or a fleet-provisioning gap, never something to paper over
    with silent base-model output."""


class AdapterSlotsExhausted(RuntimeError):
    """No free adapter slot and every resident adapter is held by a
    live batch: the slot pool is sized too small for the offered
    tenant concurrency — a capacity-planning signal, surfaced loudly
    (the same contract as ``PagePoolExhausted``) with nothing
    half-installed."""


def adapter_bytes(payload: dict) -> int:
    """Exact adapter bytes from dtype/shape arithmetic — the closed
    form every counter and the bench assert; never wall-clock."""
    return sum(
        int(np.prod(ab[k].shape)) * ab[k].dtype.itemsize
        for layer in payload.values()
        for ab in layer.values()
        for k in ("a", "b")
    )


def adapter_rank(payload: dict) -> int:
    """The payload's LoRA rank (``a`` is ``[d_in, r]``)."""
    for layer in payload.values():
        for ab in layer.values():
            return int(ab["a"].shape[1])
    raise ValueError("empty adapter payload")


def serialize_adapter(aid: str, payload: dict) -> bytes:
    """An adapter payload → wire bytes: one JSON header line —
    ``{"v": 1, "adapter", "rank", "nbytes", "leaves": [[layer,
    target, ab, shape, dtype], ...]}`` — followed by each leaf's raw
    C-order bytes in header order (the ``GET /kv/prefix`` framing,
    applied to adapter weights). The payload is the CANONICAL
    effective pair — ``b`` pre-scaled by alpha/rank at registration —
    so the delta is exactly ``x @ a @ b`` with no scale riding the
    wire."""
    leaves = []
    chunks = []
    for ln in sorted(payload):
        for target in sorted(payload[ln]):
            for ab in ("a", "b"):
                arr = np.ascontiguousarray(payload[ln][target][ab])
                leaves.append([ln, target, ab, list(arr.shape), arr.dtype.str])
                chunks.append(arr.tobytes())
    header = json.dumps(
        {
            "v": WIRE_VERSION,
            "adapter": aid,
            "rank": adapter_rank(payload),
            "nbytes": adapter_bytes(payload),
            "leaves": leaves,
        }
    ).encode()
    return header + b"\n" + b"".join(chunks)


def deserialize_adapter(aid: str, data: bytes):
    """Wire bytes → ``(payload, rank, nbytes)`` for ``aid``. Raises
    ``ValueError`` on ANY inconsistency — unparseable header, an
    adapter id that does not match the one requested, ``a``/``b``
    shapes that are not ``[d, r]`` / ``[r, d]`` at one consistent
    rank, a leaf whose size disagrees with its manifest, trailing
    bytes, or a total that disagrees with the header's ``nbytes`` —
    so a corrupt wire response (or stale disk file) is dropped as a
    counted miss, never installed."""
    nl = data.find(b"\n", 0, _MAX_HEADER_BYTES)
    if nl < 0:
        raise ValueError("no header line in adapter blob")
    try:
        head = json.loads(data[:nl])
    except Exception as e:
        raise ValueError(f"unparseable adapter header: {e}") from None
    if not isinstance(head, dict) or head.get("v") != WIRE_VERSION:
        raise ValueError(f"unknown adapter blob version {head!r:.80}")
    try:
        wire_aid = head["adapter"]
        if aid is not None and wire_aid != aid:
            raise ValueError(
                f"blob names adapter {wire_aid!r:.80}, wanted {aid!r}"
            )
        rank = int(head["rank"])
        if rank < 1:
            raise ValueError("rank must be >= 1")
        nbytes = int(head["nbytes"])
        leaves = head["leaves"]
        if not isinstance(leaves, list) or not leaves:
            raise ValueError("leaf manifest is not a non-empty list")
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"incomplete adapter header: {e}") from None
    payload: dict = {}
    off = nl + 1
    total = 0
    for leaf in leaves:
        try:
            ln, target, ab, shape, dtype = leaf
            shape = tuple(int(s) for s in shape)
            dt = np.dtype(dtype)
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad leaf manifest {leaf!r:.80}: {e}") from None
        if ab not in ("a", "b"):
            raise ValueError(f"leaf {ln}/{target} kind {ab!r:.20} not a|b")
        # Non-positive dims refused for the same reason as the KV
        # wire: a negative dim defeats the truncation check below.
        if (
            len(shape) != 2
            or any(s <= 0 for s in shape)
            or (ab == "a" and shape[1] != rank)
            or (ab == "b" and shape[0] != rank)
        ):
            raise ValueError(
                f"leaf {ln}/{target}/{ab} shape {shape} is not a rank-"
                f"{rank} {'[d, r]' if ab == 'a' else '[r, d]'} matrix"
            )
        size = int(np.prod(shape)) * dt.itemsize
        if off + size > len(data):
            raise ValueError("truncated adapter payload")
        tgt = payload.setdefault(ln, {}).setdefault(target, {})
        if ab in tgt:
            raise ValueError(f"duplicate leaf {ln}/{target}/{ab}")
        tgt[ab] = np.frombuffer(
            data, dtype=dt, count=int(np.prod(shape)), offset=off
        ).reshape(shape)
        off += size
        total += size
    for ln, layer in payload.items():
        for target, ab in layer.items():
            if "a" not in ab or "b" not in ab:
                raise ValueError(f"leaf {ln}/{target} missing a or b")
    if off != len(data):
        raise ValueError("trailing bytes after adapter payload")
    if total != nbytes:
        raise ValueError(
            f"adapter payload is {total} bytes, header says {nbytes}"
        )
    return payload, rank, nbytes


def save_adapter(path: str, aid: str, payload: dict) -> int:
    """Write an adapter artifact: the file IS the wire image, so the
    CLI's ``--adapter id=path``, the disk-backed store, and the peer
    wire all share one format and one validator. Returns the payload
    bytes (header excluded — the closed form)."""
    data = serialize_adapter(aid, payload)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return adapter_bytes(payload)


def load_adapter(path: str):
    """Read + validate an adapter artifact → ``(aid, payload, rank,
    nbytes)``. Raises ``ValueError`` on any corruption (same
    validator as the wire)."""
    with open(path, "rb") as f:
        data = f.read()
    nl = data.find(b"\n", 0, _MAX_HEADER_BYTES)
    if nl < 0:
        raise ValueError(f"no header line in adapter file {path!r}")
    try:
        aid = json.loads(data[:nl]).get("adapter")
    except Exception as e:
        raise ValueError(f"unparseable adapter file {path!r}: {e}") from None
    if not isinstance(aid, str) or not ADAPTER_ID_RE.match(aid):
        raise ValueError(f"bad adapter id in file {path!r}: {aid!r:.80}")
    payload, rank, nbytes = deserialize_adapter(aid, data)
    return aid, payload, rank, nbytes


class _StoredAdapter:
    """Index record: payload in RAM or a wire-image path on disk."""

    __slots__ = ("payload", "path", "rank", "nbytes")

    def __init__(self, payload, path, rank, nbytes):
        self.payload = payload      # None when disk-backed
        self.path = path            # None when RAM-resident
        self.rank = rank
        self.nbytes = nbytes


class AdapterStore:
    """LRU bytes-budgeted host store of adapter payloads, keyed by
    adapter id — the ``KVTier`` mechanics applied to weights instead
    of KV. Thread-safe: encode executor threads stage peer fetches
    and resolve ids concurrently with CLI/HTTP registration and the
    dispatch thread's install reads."""

    def __init__(self, max_bytes: int, disk_dir: str | None = None):
        if max_bytes <= 0:
            raise ValueError(
                f"adapter_store_bytes must be > 0, got {max_bytes}"
            )
        self.max_bytes = int(max_bytes)
        self.disk_dir = disk_dir
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            self._sweep_stale(disk_dir)
        self._lock = threading.Lock()
        # aid -> _StoredAdapter, LRU-ordered (front = coldest).
        self._blobs: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self._seq = 0
        self.evictions = 0

    @staticmethod
    def _sweep_stale(disk_dir: str) -> None:
        """Unlink adapter files left by DEAD former owners (filenames
        are pid-scoped and the index is per-process — same restart-
        loop hygiene as ``KVTier._sweep_stale``). Live siblings and
        unparseable names are left alone."""
        for name in os.listdir(disk_dir):
            if not (name.startswith("adstore-") and name.endswith(".bin")):
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
                    _log.debug("swept stale adapter blob %s", name)
                except OSError:
                    pass
            except OSError:
                pass  # EPERM etc.: a live process we can't signal

    # -- accounting ----------------------------------------------------
    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._blobs)

    def has(self, aid: str) -> bool:
        with self._lock:
            return aid in self._blobs

    def ids(self) -> list:
        with self._lock:
            return list(self._blobs)

    # -- registration --------------------------------------------------
    def put(self, aid: str, payload: dict) -> int:
        """Register ``aid``'s payload (replacing any prior blob),
        evicting LRU blobs past the bytes budget. Disk mode registers
        RAM-resident first and moves the wire image to its file AFTER
        releasing the lock — the write must not block concurrent
        lookups; a blob replaced or evicted mid-write just unlinks
        the fresh file (same swap discipline as ``KVTier``)."""
        nbytes = adapter_bytes(payload)
        rank = adapter_rank(payload)
        with self._lock:
            old = self._blobs.pop(aid, None)
            if old is not None:
                self._discard_locked(old)
            if nbytes > self.max_bytes:
                # Can't ever fit: count it as an eviction of itself
                # rather than thrashing the whole store out.
                self.evictions += 1
                _log.debug(
                    "adapter %r (%d bytes) exceeds the %d-byte budget; "
                    "not stored", aid, nbytes, self.max_bytes,
                )
                return nbytes
            path = None
            if self.disk_dir:
                path = os.path.join(
                    self.disk_dir, f"adstore-{os.getpid()}-{self._seq}.bin"
                )
                self._seq += 1
            stored = _StoredAdapter(payload, None, rank, nbytes)
            self._blobs[aid] = stored
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._blobs) > 1:
                _, victim = self._blobs.popitem(last=False)  # LRU
                self._discard_locked(victim)
                self.evictions += 1
        if path is not None:
            try:
                data = serialize_adapter(aid, payload)
                with open(path, "wb") as f:
                    f.write(data)
            except Exception as e:
                _log.debug("adapter disk write failed (%s); RAM blob", e)
                return nbytes
            with self._lock:
                live = self._blobs.get(aid)
                if live is stored and live.payload is payload:
                    live.path = path
                    live.payload = None
                else:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        return nbytes

    def drop(self, aid: str) -> None:
        """Forget ``aid``'s blob (no-op if absent): an install proved
        it can never apply to the live model (shape/rank drift), so
        keeping it would repeat the failed validation on every
        request. Not counted as an eviction (``evictions`` measures
        budget pressure, not invalidation)."""
        with self._lock:
            stored = self._blobs.pop(aid, None)
            if stored is not None:
                self._discard_locked(stored)
                _log.debug("dropped inapplicable adapter blob %r", aid)

    def _discard_locked(self, stored: _StoredAdapter) -> None:
        self._bytes -= stored.nbytes
        if stored.path is not None:
            try:
                os.unlink(stored.path)
            except OSError:
                pass

    # -- lookup --------------------------------------------------------
    def get(self, aid: str):
        """``(payload, rank, nbytes)`` for ``aid`` (LRU-touched),
        loaded back from disk if spilled, or ``None``. A vanished or
        corrupt disk file is a miss, not a crash — dropped from the
        index unless a concurrent re-put already replaced it."""
        with self._lock:
            stored = self._blobs.get(aid)
            if stored is None:
                return None
            self._blobs.move_to_end(aid)
            payload = stored.payload
            path = stored.path
            rank = stored.rank
            nbytes = stored.nbytes
        if payload is None:
            try:
                with open(path, "rb") as f:
                    data = f.read()
                payload, rank, nbytes = deserialize_adapter(aid, data)
            except Exception as e:
                _log.debug("adapter disk blob unreadable (%s); dropping", e)
                with self._lock:
                    if self._blobs.get(aid) is stored:
                        self._blobs.pop(aid)
                        self._discard_locked(stored)
                return None
        return payload, rank, nbytes


def _kernel_of(node):
    """The 2-D float kernel a target node holds (a ``{kernel, bias}``
    module, or a bare 2-D parameter), or None (an int8 ``QuantLeaf``
    is none: the slot pool adapts float kernels, as the JAX package's
    does)."""
    kernel = getattr(node, "kernel", None) if isinstance(
        node, torch.nn.Module) else node
    if isinstance(kernel, torch.Tensor) and kernel.ndim == 2:
        return kernel
    return None


class AdapterSlots:
    """The device-resident adapter slot pool: per layer and adapted
    target, one ``a [S+1, d_in, r]`` and one ``b [S+1, r, d_out]``
    tensor; slot 0 is the permanently-zero NULL slot and slots ``1..S``
    hold resident tenants, evicted LRU when no live batch holds them.

    The pools materialize at the FIRST install, at that adapter's rank,
    which is then fixed (a later mismatch is refused). Targets are
    ``models/lora.DEFAULT_TARGETS`` that the model's ``layer_0`` holds as
    float kernels; the pools take the kernel's stored dtype (the compute
    dtype, once the engine has cast its dense kernels), which is the
    dtype the delta is computed in. Only the dispatch thread installs or
    evicts; ``lock`` guards the host maps for /metrics' and the
    scheduler's reads."""

    def __init__(self, engine, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"adapter_slots must be >= 1, got {n_slots}")
        self.eng = engine
        self.n_slots = int(n_slots)
        self.lock = threading.Lock()
        self.rank: int | None = None
        # {layer: {target: {"a": [S+1, d_in, r], "b": [S+1, r, d_out]}}},
        # None until the first install fixes the rank.
        self.pools = None
        self._slot_of: collections.OrderedDict = collections.OrderedDict()
        self._holds: dict[str, int] = {}
        self._free: list[int] = list(range(self.n_slots, 0, -1))
        self.installs = 0
        self.evictions = 0

    # -- accounting ----------------------------------------------------
    @property
    def slots_total(self) -> int:
        return self.n_slots

    @property
    def slots_in_use(self) -> int:
        with self.lock:
            return len(self._slot_of)

    def resident(self, aid: str) -> bool:
        with self.lock:
            return aid in self._slot_of

    def slot_bytes(self) -> int:
        """One slot's exact bytes (one slot row of every pool tensor),
        the per-tenant increment of ``base_bytes + N x slot_bytes``; 0
        until the first install materializes the pools."""
        if self.pools is None:
            return 0
        return sum(
            int(np.prod(leaf.shape[1:])) * leaf.element_size()
            for layer in self.pools.values()
            for pair in layer.values()
            for leaf in pair.values()
        )

    # -- scheduler gate ------------------------------------------------
    def can_claim(self, aids) -> bool:
        """Worst-case admission check for the scheduler's reservation
        gate: could every adapter in ``aids`` be made resident RIGHT NOW
        (resident already, a free slot, or an LRU-evictable slot, one
        hold-free and not itself requested, for each that is not)?"""
        need = set(aids)
        with self.lock:
            missing = sum(1 for a in need if a not in self._slot_of)
            if missing == 0:
                return True
            free = len(self._free)
            evictable = sum(
                1 for a in self._slot_of
                if a not in need and self._holds.get(a, 0) == 0
            )
            return missing <= free + evictable

    # -- resolution (dispatch thread) -----------------------------------
    def acquire(self, aid: str, store: AdapterStore | None) -> int:
        """Resolve ``aid`` to a resident slot, installing from the host
        store on a miss, and bump its hold count (a held adapter cannot
        be evicted until :meth:`release`). Raises
        :class:`AdapterUnavailable` when the store has no blob (or the
        blob cannot apply to this model) and
        :class:`AdapterSlotsExhausted` when no slot can be freed, in
        both cases with nothing half-installed and every hold
        unchanged."""
        with self.lock:
            slot = self._slot_of.get(aid)
            if slot is not None:
                self._holds[aid] = self._holds.get(aid, 0) + 1
                self._slot_of.move_to_end(aid)
                return slot
        got = store.get(aid) if store is not None else None
        if got is None:
            raise AdapterUnavailable(
                f"adapter {aid!r} is not registered on this replica"
            )
        payload, rank, _ = got
        try:
            slot = self.install(aid, payload, rank)
        except ValueError as e:
            # Shape/rank drift against the live model: the blob can
            # never apply; drop it so the next request 404s fast.
            if store is not None:
                store.drop(aid)
            raise AdapterUnavailable(
                f"adapter {aid!r} does not fit this model: {e}"
            ) from None
        with self.lock:
            self._holds[aid] = self._holds.get(aid, 0) + 1
        return slot

    def release(self, aid: str) -> None:
        """Drop one hold on ``aid`` (batch teardown). Loud on a
        double-release: a negative hold would let a live batch's adapter
        be evicted under it."""
        with self.lock:
            held = self._holds.get(aid, 0)
            assert held > 0, f"adapter hold double-release for {aid!r}"
            self._holds[aid] = held - 1

    def install(self, aid: str, payload: dict, rank: int) -> int:
        """Install ``payload`` into a slot (dispatch thread only):
        materialize the pools on first use, validate every leaf against
        the model's kernels, fire the ``adapter_install`` fault point,
        take a slot (the free list first, else evict the LRU hold-free
        resident, else raise :class:`AdapterSlotsExhausted`), then copy
        the pairs into that slot of every pool in place. The id is
        published only after the copy, so a failure at any point
        leaves nothing half-installed (a failed copy returns the slot to
        the free list; the slot is unreachable until reinstalled)."""
        if self.pools is None:
            self._materialize(rank)
        if rank != self.rank:
            raise ValueError(
                f"rank {rank} adapter in a rank-{self.rank} slot pool "
                f"(the engine's rank is fixed by the first install)"
            )
        self._validate(aid, payload)
        # Before the slot allocation: an injected failure lands on
        # untouched state (no slot popped, no victim evicted).
        faults.fire("adapter_install")
        with self.lock:
            if aid in self._slot_of:
                return self._slot_of[aid]
            if self._free:
                slot = self._free.pop()
            else:
                victim = next(
                    (a for a in self._slot_of
                     if self._holds.get(a, 0) == 0),
                    None,
                )
                if victim is None:
                    raise AdapterSlotsExhausted(
                        f"all {self.n_slots} adapter slots are held by "
                        f"live batches; cannot install {aid!r}"
                    )
                slot = self._slot_of.pop(victim)
                self._holds.pop(victim, None)
                self.evictions += 1
                _log.debug("evicted adapter %r from slot %d for %r",
                           victim, slot, aid)
        try:
            for ln, layer in self.pools.items():
                for target, pair in layer.items():
                    for ab, leaf in pair.items():
                        src = torch.from_numpy(
                            np.array(payload[ln][target][ab]))
                        leaf.index_copy_(0, torch.tensor(
                            [slot], device=leaf.device),
                            src.to(leaf.device, leaf.dtype)[None])
        except BaseException:
            with self.lock:
                self._free.append(slot)
            raise
        with self.lock:
            self._slot_of[aid] = slot
            self._slot_of.move_to_end(aid)
            self.installs += 1
        return slot

    def _materialize(self, rank: int) -> None:
        """The zero-filled pools: ``S + 1`` slots per adapted target on
        the model's device. Slot 0 is never allocated, so it stays
        zero."""
        from mlapi_tpu_torch.models.lora import DEFAULT_TARGETS

        model = self.eng.model
        n_layers = int(getattr(model, "num_layers", 0))
        if not n_layers:
            raise ValueError("the model holds no layer_{n} blocks")
        layer0 = model.layer(0)
        targets = [
            t for t in DEFAULT_TARGETS
            if _kernel_of(getattr(layer0, t, None)) is not None
        ]
        if not targets:
            raise ValueError(
                f"no LoRA targets among {DEFAULT_TARGETS} in the model"
            )
        pools: dict = {}
        for n in range(n_layers):
            layer = model.layer(n)
            pools[f"layer_{n}"] = {}
            for t in targets:
                kernel = _kernel_of(getattr(layer, t))
                d_in, d_out = kernel.shape
                kw = dict(dtype=kernel.dtype, device=kernel.device)
                pools[f"layer_{n}"][t] = {
                    "a": torch.zeros((self.n_slots + 1, d_in, rank), **kw),
                    "b": torch.zeros((self.n_slots + 1, rank, d_out), **kw),
                }
        self.pools = pools
        self.rank = int(rank)

    def _validate(self, aid: str, payload: dict) -> None:
        """Every pool leaf must have its counterpart in the payload at
        the kernel's exact shape, and nothing extra: installing a subset
        would serve a tenant half their fine-tune."""
        for ln, layer in self.pools.items():
            got = payload.get(ln)
            if got is None:
                raise ValueError(f"adapter {aid!r} missing layer {ln}")
            for target, pair in layer.items():
                p = got.get(target)
                if p is None:
                    raise ValueError(
                        f"adapter {aid!r} missing {ln}/{target}"
                    )
                for ab in ("a", "b"):
                    want = tuple(pair[ab].shape[1:])
                    have = tuple(p[ab].shape)
                    if want != have:
                        raise ValueError(
                            f"adapter {aid!r} {ln}/{target}/{ab} shape "
                            f"{have} != model's {want}"
                        )
        extra = {
            (ln, t)
            for ln, layer in payload.items()
            for t in layer
            if ln not in self.pools or t not in self.pools[ln]
        }
        if extra:
            raise ValueError(
                f"adapter {aid!r} carries leaves the model does not "
                f"adapt: {sorted(extra)[:4]}"
            )

    # -- the batch's adapter context (dispatch thread) ------------------
    def batch_params(self, *, slot=None, rows=None) -> dict:
        """The adapter context of one dispatch (``models/lora``): per
        layer the full pools plus the marker, an int ``"slot"``
        (grouped: every row one tenant) or a ``"rows"`` tensor
        (gathered BGMV: per-row slots, 0 for base rows). No device work
        but the ``rows`` upload."""
        if rows is None:
            mark = {"slot": int(slot)}
        else:
            dev = next(iter(next(iter(self.pools.values())).values()))[
                "a"].device
            mark = {"rows": torch.as_tensor(np.asarray(rows, np.int64),
                                            device=dev)}
        return {ln: {**layer, **mark} for ln, layer in self.pools.items()}
