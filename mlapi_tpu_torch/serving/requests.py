"""Request-side data types for generative serving.

Counterpart of ``mlapi_tpu/serving/requests.py``: one
:class:`GenRequest` per in-flight generation (the handoff between the
asyncio front and the device thread), :class:`_SyncSink` adapting the
synchronous ``generate_text`` path onto the same batch machinery, the
engine's :class:`LatencyStats` reservoirs, the terminal frames
:class:`DeadlineExceeded` (a request's deadline passed) and
:class:`DrainCancelled` (the server stopped under a stream), and
:class:`_PrefixEntry`, one cached shared-prompt prefix.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time

from mlapi_tpu_torch.serving import faults

# Guards GenRequest.finish's check-then-set: the device thread's
# terminal push and the event loop's cancel may both reach it.
_FINISH_LOCK = threading.Lock()


class DeadlineExceeded(Exception):
    """A request's wall-clock deadline passed before its generation
    finished: the stream's terminal frame (``"code":
    "deadline_exceeded"``), a 504 on a unary request. ``stage`` names
    the boundary that noticed: ``queued`` (never dispatched),
    ``prefill`` or ``decode``, as the ``deadline_expired_{stage}``
    counters split it."""

    code = "deadline_exceeded"

    def __init__(self, stage: str):
        super().__init__(f"deadline exceeded while {stage}")
        self.stage = stage


class DrainCancelled(Exception):
    """The server stopped with this stream still in flight: a terminal
    frame (503-mapped), not a dropped connection."""

    code = "draining"

    def __init__(self):
        super().__init__("server draining: generation cancelled")


class LatencyStats:
    """Bounded reservoirs of per-request latency samples recorded at
    token delivery: TTFT (submit → first chunk) and the per-token share
    of each later chunk gap. Thread-safe (pushes come from the device
    thread, scrapes from the event loop)."""

    def __init__(self, cap: int = 2048):
        self._ttft_ms: collections.deque = collections.deque(maxlen=cap)
        self._itl_ms: collections.deque = collections.deque(maxlen=cap)
        self._lock = threading.Lock()

    def record_first(self, ms: float) -> None:
        with self._lock:
            self._ttft_ms.append(ms)

    def record_gap(self, ms_per_token: float) -> None:
        with self._lock:
            self._itl_ms.append(ms_per_token)

    @staticmethod
    def _q(xs: list, q: float) -> float | None:
        if not xs:
            return None
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def summary(self) -> dict:
        """p50/p95 of both series in ms (``None`` until samples)."""
        with self._lock:
            t, i = list(self._ttft_ms), list(self._itl_ms)
        t.sort()
        i.sort()
        r = lambda v: None if v is None else round(v, 2)  # noqa: E731
        return {
            "ttft_p50_ms": r(self._q(t, 0.50)),
            "ttft_p95_ms": r(self._q(t, 0.95)),
            "intertoken_p50_ms": r(self._q(i, 0.50)),
            "intertoken_p95_ms": r(self._q(i, 0.95)),
        }


def _record_push(sink, item) -> None:
    """Fold one delivered chunk into the engine's latency reservoirs."""
    if sink.stats is None or not isinstance(item, dict):
        return
    now = time.perf_counter()
    n = len(item.get("token_ids", ())) or 1
    if sink.t_last is None:
        sink.stats.record_first((now - sink.t0) * 1e3)
    else:
        sink.stats.record_gap((now - sink.t_last) * 1e3 / n)
    sink.t_last = now


class GenRequest:
    """One in-flight generation: its encoded prompt plus an asyncio
    queue the device thread feeds with ``{"token_ids": [...]}`` chunks,
    an exception, or the ``None`` end sentinel."""

    __slots__ = (
        "row", "used", "n_new", "temperature", "seed", "queue", "loop",
        "cancelled", "top_k", "top_p", "stream", "prompt_tokens", "stats",
        "t0", "t_last", "prefix_fp", "prefix_kv", "prefix_len",
        "prefix_lo", "deadline", "staged", "adapter", "tenant", "on_done",
        "_done_fired",
    )

    def __init__(self, row, used, n_new, temperature, seed, loop,
                 top_k=0, top_p=1.0, prefix=None, stream=False,
                 stats: LatencyStats | None = None,
                 deadline_ms: float | None = None, adapter=None,
                 tenant: str = ""):
        self.row = row            # [bucket] int32 ids, left-padded
        self.used = used          # real prompt tokens in the row
        self.n_new = n_new
        self.temperature = temperature
        self.seed = seed
        self.loop = loop
        self.top_k = top_k        # 0 disables
        self.top_p = top_p        # 1.0 disables
        # Incremental consumer (NDJSON stream or stop-sequence watcher):
        # the decode loop keeps at most one chunk in flight for it.
        self.stream = stream
        self.prompt_tokens = used
        # Shared-prefix KV entry (the engine's prefix cache): the row's
        # cache holds the entry's KV in slots [0, prefix_len), its own
        # left pads below prefix_lo.
        if prefix is not None:
            self.prefix_fp = prefix.fp
            self.prefix_kv = prefix.kv
            self.prefix_len = prefix.bucket
            self.prefix_lo = prefix.lo
            # Tokens that conditioned the output: prefix and suffix.
            self.prompt_tokens = prefix.used + used
        else:
            self.prefix_fp = None
            self.prefix_kv = None
            self.prefix_len = 0
            self.prefix_lo = 0
        self.queue: asyncio.Queue = asyncio.Queue()
        self.cancelled = False    # set when the consumer disconnects
        # Staged for a live lane's admission at most once: a joiner the
        # lane hands back forms a group of its own instead.
        self.staged = False
        self.stats = stats
        self.t0 = time.perf_counter()
        self.t_last: float | None = None
        # Absolute expiry on the perf_counter clock, checked at every
        # dispatch boundary (``engine._expire_if_due``); None: none.
        self.deadline = (
            self.t0 + deadline_ms / 1e3 if deadline_ms else None
        )
        # The tenant's LoRA adapter id (serving/adapter_store.py), or
        # None for the base model; rows of different adapters batch
        # together (the gathered path).
        self.adapter = adapter
        # The quota and fairness identity (serving/registry.py's
        # TenantLedger): by default the adapter id, else "" (anonymous).
        self.tenant = tenant
        # Fired once at the terminal frame, whichever path ends the
        # request (the tenant ledger's depth exit).
        self.on_done = None
        self._done_fired = False

    def push(self, item) -> None:
        """Thread-safe enqueue from the device thread."""
        faults.fire("stream_push")
        _record_push(self, item)
        if item is None or isinstance(item, BaseException):
            self.finish()
        self.loop.call_soon_threadsafe(self.queue.put_nowait, item)

    def finish(self) -> None:
        """Terminal-frame hook, idempotent: fires ``on_done`` exactly
        once, whether a sentinel, an error frame or a cancel ends the
        request, and whichever thread gets here first."""
        with _FINISH_LOCK:
            if self._done_fired:
                return
            self._done_fired = True
        cb = self.on_done
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — bookkeeping, not delivery
                pass

    def cancel(self) -> None:
        """Consumer is gone: the decode loop stops spending device time
        on this row (a plain bool read cross-thread; worst case one
        extra chunk decodes). The tenant ledger's exit fires here too:
        a cancelled row may retire without a terminal push."""
        self.cancelled = True
        self.finish()


class _PrefixEntry:
    """One cached shared-prompt prefix: its device-resident KV (a
    ``[1, bucket]``-shaped cache dict), the bucket it was padded to, its
    own left-pad count ``lo``, and its real token count."""

    __slots__ = ("fp", "kv", "bucket", "lo", "used")

    def __init__(self, fp, kv, bucket, lo, used):
        self.fp = fp
        self.kv = kv
        self.bucket = bucket
        self.lo = lo
        self.used = used


class _SyncSink:
    """Adapter so the synchronous ``generate_text`` path reuses
    ``_run_batch`` verbatim: collects token chunks into a list."""

    def __init__(self, req: GenRequest, out_ids: list):
        self.row, self.used, self.n_new = req.row, req.used, req.n_new
        self.temperature, self.seed = req.temperature, req.seed
        self.top_k, self.top_p = req.top_k, req.top_p
        self.prefix_fp, self.prefix_kv = req.prefix_fp, req.prefix_kv
        self.prefix_len, self.prefix_lo = req.prefix_len, req.prefix_lo
        self.stream = req.stream
        self.stats, self.t0, self.t_last = req.stats, req.t0, None
        self.adapter, self.tenant = req.adapter, req.tenant
        self._out = out_ids
        self.error: Exception | None = None
        self.cancelled = False

    def push(self, item) -> None:
        faults.fire("stream_push")
        _record_push(self, item)
        if isinstance(item, Exception):
            self.error = item
        elif item is not None:
            self._out.extend(item["token_ids"])
