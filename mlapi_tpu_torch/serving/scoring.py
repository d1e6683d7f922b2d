"""The scoring path: micro-batches of single-row requests, each
formed batch one device call (counterpart of
``mlapi_tpu/serving/scoring.py``).

:class:`ScorePath` serves a classification engine
(``InferenceEngine`` / ``TextClassificationEngine``): ``submit`` queues
one row; the collector takes an in-flight slot, then the first row and
every row that arrives within ``max_wait_ms`` (up to ``max_batch``),
fails rows whose deadline passed in the queue (``DeadlineExceeded``,
504), and fires the batch without awaiting it. A batch runs on one of
two backends:

- **Score units.** When a generative engine is co-resident (a
  multi-model process), the batch goes to its
  :class:`~mlapi_tpu_torch.serving.scheduler.UnitScheduler` as a typed
  ``score`` unit: the dispatch thread runs the device call between the
  lanes' units, under one policy (``sched_dispatches`` counts these).
- **Worker threads.** Otherwise a :class:`_WorkerPool` thread runs it.

Either way the runner fires the ``score_dispatch`` fault point, calls
``engine.predict_labels`` (which enters ``torch.inference_mode()`` on
its own thread) and resolves the batch's futures on the event loop; a
watchdog (``dispatch_timeout_s``) fails a wedged call's requests and
frees its slot. ``drain`` sheds new submits with a 503 and lets queued
and in-flight batches finish within a budget. N requests queued with no
await between them become ``ceil(N / max_batch)`` device calls.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time

import numpy as np

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.engine import OverloadedError as _EngineOverloaded
from mlapi_tpu_torch.serving.requests import DeadlineExceeded, LatencyStats
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.scoring")


class _WorkerPool:
    """Reusable daemon worker threads that heal around wedged device
    calls: ``submit`` hands work to an idle worker, or spawns a fresh
    one when none is idle. A worker stuck inside a device call never
    returns to the idle set — it is out of circulation, and the next
    batch gets a new thread — so the path recovers without paying a
    thread start per batch. Steady-state thread count equals peak
    concurrent batches (≤ the path's max_inflight)."""

    def __init__(self, name: str):
        self._name = name
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._spawned = 0

    def submit(self, fn) -> None:
        with self._lock:
            spawn = self._idle == 0
            if spawn:
                self._spawned += 1
                n = self._spawned
            else:
                self._idle -= 1
            work = self._work
        if spawn:
            threading.Thread(
                target=self._run, args=(work,),
                name=f"{self._name}-{n}", daemon=True,
            ).start()
        work.put(fn)

    def close(self) -> None:
        """Release every live worker. Workers are bound to the queue
        they were spawned with; swapping in a fresh queue makes stale
        sentinels (destined for forever-wedged workers) and any stale
        work die with the old queue instead of poisoning a restarted
        pool."""
        with self._lock:
            n = self._spawned
            self._spawned = 0
            self._idle = 0
            old = self._work
            self._work = queue.SimpleQueue()
        for _ in range(n):
            old.put(None)

    def _run(self, work: queue.SimpleQueue) -> None:
        while True:
            fn = work.get()
            if fn is None:
                return  # pool closed
            try:
                fn()
            except Exception:  # noqa: BLE001 — workers must survive
                _log.exception("dispatch worker error")
            finally:
                with self._lock:
                    if work is self._work:
                        self._idle += 1
                    else:
                        return  # pool closed while we were busy


class OverloadedError(_EngineOverloaded):
    """A scoring request shed at the door (503 + ``retry-after``): the
    queue is full, the path drains, or a drain budget ran out. The
    engine's :class:`~mlapi_tpu_torch.serving.engine.OverloadedError`
    with the JAX scoring path's messages (``"predict queue full"``, or
    ``detail``)."""

    def __init__(self, what: str, retry_after_s: float = 1.0,
                 detail: str | None = None):
        RuntimeError.__init__(self, detail or f"{what} queue full")
        self.retry_after_s = retry_after_s


class ScorePath:
    """Coalesces single-row scoring requests into batched device
    dispatches — typed ``score`` units when a generative scheduler is
    co-resident, pool-worker calls otherwise."""

    def __init__(
        self,
        engine,
        *,
        model_id: str = "default",
        max_batch: int | None = None,
        max_wait_ms: float = 0.2,
        max_queue: int = 8192,
        max_inflight: int = 16,
        dispatch_timeout_s: float = 30.0,
        default_deadline_ms: float | None = None,
        sched_source=None,
    ):
        self.engine = engine
        self.model_id = model_id
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_inflight = max_inflight
        self.dispatch_timeout_s = dispatch_timeout_s
        # Wall-clock budget applied when a request names none (None =
        # no deadline): classification's one dispatch boundary is the
        # queue→batch handoff, where expired entries fail with
        # DeadlineExceeded (504) instead of burning device time.
        self.default_deadline_ms = default_deadline_ms
        # Zero-arg callable resolving to the co-resident generative
        # engine's UnitScheduler (or None). A callable, not the
        # scheduler itself: the scheduler is created by
        # ``engine.start()`` AFTER the app wires the registry, and a
        # restarted engine gets a fresh one.
        self._sched_source = sched_source
        # Per-model reservoir: /metrics latency family and the
        # scheduler's score-unit aging target (its TTFT p95) read
        # THIS model's observations.
        self.latency = LatencyStats()
        # Graceful drain: submit sheds while True; in-flight batches
        # finish (their resolvers set results), the queue empties.
        self.draining = False
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        # True while the collect loop holds popped rows it has not
        # yet dispatched (the straggler window): those rows are in
        # neither the queue nor ``inflight``, and drain() must treat
        # the window as live work or it can declare the path idle
        # with a batch still forming.
        self._collecting = False
        self._inflight: asyncio.Semaphore | None = None
        self._task: asyncio.Task | None = None
        self._resolvers: set[asyncio.Task] = set()
        self._pool = _WorkerPool("score-dispatch")
        # Stats (read by /metrics and the coalescing test).
        self.device_calls = 0
        self.requests = 0
        self.timeouts = 0
        self.rejected = 0
        self.inflight = 0
        self.shed_draining = 0
        self.deadline_expired = 0
        # Batches routed through the co-resident UnitScheduler as
        # typed score units (vs the pool-worker backend) — the
        # counters-not-wall-clock evidence that interleaving happened.
        self.sched_dispatches = 0
        # The fleet backlog a router reports: 0 until the router is
        # ported (ROADMAP Queue A item 7).
        self.router_queue_depth = 0

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def _sched(self):
        if self._sched_source is None:
            return None
        try:
            return self._sched_source()
        except Exception:  # noqa: BLE001 — a dead source means no sched
            return None

    async def start(self) -> None:
        if self._task is None:
            self._inflight = asyncio.Semaphore(self.max_inflight)
            self._task = asyncio.create_task(
                self._collect_loop(), name=f"scorepath-{self.model_id}"
            )

    async def stop(self) -> None:
        """Graceful shutdown: no awaiting ``submit()`` may hang.

        In-flight batches are allowed to finish (their resolvers set
        results); anything still queued gets a clean exception.
        """
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._resolvers:
            await asyncio.gather(*list(self._resolvers), return_exceptions=True)
        self._pool.close()  # release idle dispatch workers
        while not self._queue.empty():
            _, fut, _, _ = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(RuntimeError("scoring path stopped"))

    async def drain(self, timeout_s: float = 10.0) -> None:
        """Graceful drain: shed new submits (503 + retry-after), let
        queued and in-flight batches finish inside the budget; when
        the budget runs out, anything still QUEUED sheds with the
        same documented 503 + retry-after (``stop()`` would fail it
        with an opaque RuntimeError → 500), while dispatched batches
        are left to resolve — late but clean."""
        self.draining = True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0.0, timeout_s)
        while loop.time() < deadline:
            if (
                self._queue.empty()
                and self.inflight == 0
                and not self._collecting
            ):
                return
            await asyncio.sleep(0.05)
        while not self._queue.empty():
            _, fut, _, _ = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(OverloadedError(
                    "predict", retry_after_s=5.0,
                    detail="drain budget exhausted: retry against "
                           "another replica",
                ))

    async def submit(
        self, row: np.ndarray, *, deadline_ms: float | None = None
    ) -> tuple[str, float]:
        """Queue one feature row; resolves to (label, probability).

        Raises :class:`OverloadedError` immediately when the queue is
        full — under overload, fast-fail beats queueing: a blocked
        ``put`` here would grow latency without bound while every
        queued request eventually times out anyway."""
        if self._task is None:
            raise RuntimeError("scoring path not started")
        loop = asyncio.get_running_loop()
        if self.draining:
            self.shed_draining += 1
            self.rejected += 1
            raise OverloadedError(
                "predict", retry_after_s=5.0,
                detail="server draining: retry against another replica",
            )
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (
            loop.time() + deadline_ms / 1e3 if deadline_ms else None
        )
        fut: asyncio.Future = loop.create_future()
        try:
            self._queue.put_nowait(
                (np.asarray(row, np.float32), fut, deadline,
                 time.perf_counter())
            )
        except asyncio.QueueFull:
            self.rejected += 1
            raise OverloadedError("predict") from None
        self.requests += 1
        return await fut

    async def _collect_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # Acquire the in-flight slot BEFORE collecting: while every
            # slot is busy, arrivals pile up in the queue, and the slot
            # that frees drains them as ONE large batch (collecting
            # first would freeze each batch at whatever the straggler
            # window caught).
            await self._inflight.acquire()
            rows = []
            try:
                rows.append(await self._queue.get())
                # No await between the pop resuming and this flag, so
                # drain() can never observe the popped row in neither
                # the queue nor the collection window.
                self._collecting = True
                if self.max_wait_s > 0:
                    deadline = loop.time() + self.max_wait_s
                    while len(rows) < self.max_batch:
                        timeout = deadline - loop.time()
                        if timeout <= 0:
                            break
                        try:
                            rows.append(
                                await asyncio.wait_for(
                                    self._queue.get(), timeout
                                )
                            )
                        except asyncio.TimeoutError:
                            break
                else:
                    while (
                        len(rows) < self.max_batch
                        and not self._queue.empty()
                    ):
                        rows.append(self._queue.get_nowait())
            except asyncio.CancelledError:
                # stop() cancelled us mid-collection: rows already
                # popped are no longer in the queue, so stop()'s drain
                # can't see them — fail their futures here or their
                # submit() callers hang forever.
                self._collecting = False
                for _, fut, _, _ in rows:
                    if not fut.done():
                        fut.set_exception(
                            RuntimeError("scoring path stopped")
                        )
                raise

            # Deadline check at the ONE dispatch boundary this path
            # owns (queue → device batch): entries whose wall-clock
            # budget passed while queued fail with DeadlineExceeded
            # (504) instead of occupying batch rows.
            now = loop.time()
            expired = [
                f for _, f, d, _ in rows if d is not None and now > d
            ]
            if expired:
                self.deadline_expired += len(expired)
                for f in expired:
                    if not f.done():
                        f.set_exception(DeadlineExceeded("queued"))
                rows = [
                    rf for rf in rows
                    if rf[2] is None or now <= rf[2]
                ]
                if not rows:
                    self._inflight.release()
                    self._collecting = False
                    continue

            batch = np.stack([r for r, _, _, _ in rows])
            futures = [f for _, f, _, _ in rows]
            t_oldest = min(t for _, _, _, t in rows)
            slack = min(
                (d for _, _, d, _ in rows if d is not None),
                default=None,
            )
            # Fire the batch without awaiting its completion: up to
            # max_inflight device round trips overlap, while this loop
            # goes straight back to collecting the next batch.
            self.inflight += 1
            self._collecting = False  # rows now covered by inflight
            work = self._dispatch(loop, batch, t_oldest, slack, now)
            resolver = asyncio.create_task(self._resolve(work, futures))
            self._resolvers.add(resolver)
            resolver.add_done_callback(self._resolvers.discard)

    def _dispatch(self, loop, batch: np.ndarray, t_oldest: float,
                  loop_deadline: float | None,
                  loop_now: float) -> asyncio.Future:
        """Run one device call — as a typed ``score`` unit on the
        co-resident UnitScheduler's dispatch thread when one is live
        (interleaving between decode chunks under the weighted-slack
        policy), else on a pool worker thread. The pool heals around
        wedged calls (see :class:`_WorkerPool`): a stranded worker
        stays stranded, and fresh batches get fresh threads — the
        path recovers instead of exhausting a fixed pool whose every
        worker is stuck."""
        fut: asyncio.Future = loop.create_future()
        self.device_calls += 1

        def runner():
            t0 = time.perf_counter()
            try:
                faults.fire("score_dispatch")
                out = self.engine.predict_labels(batch)
            except Exception as e:  # noqa: BLE001
                loop.call_soon_threadsafe(self._finish_future, fut, None, e)
            else:
                t1 = time.perf_counter()
                # Queue wait + device time of the batch's OLDEST row:
                # the per-model first-result latency the score-unit
                # urgency ages against.
                self.latency.record_first((t1 - t_oldest) * 1e3)
                loop.call_soon_threadsafe(self._finish_future, fut, out, None)

        def fail(err: BaseException) -> None:
            # Scheduler stopped with this unit still queued: the
            # batch's futures get the engine-stopped error — the same
            # terminal contract lanes get.
            try:
                loop.call_soon_threadsafe(self._finish_future, fut, None, err)
            except RuntimeError:
                pass  # loop already closed; nobody is waiting

        sched = self._sched()
        if sched is not None:
            # The loop-clock deadline converts to the dispatch
            # thread's perf_counter domain through "seconds from now"
            # — both clocks are monotonic, only the epoch differs.
            deadline = (
                time.perf_counter() + (loop_deadline - loop_now)
                if loop_deadline is not None else None
            )
            try:
                sched.submit_score(
                    runner, fail, n_rows=int(batch.shape[0]),
                    deadline=deadline, stats=self.latency,
                )
            except RuntimeError:
                # Stopped between the liveness check and the submit:
                # fall back to the pool backend for this batch.
                self._pool.submit(runner)
            else:
                self.sched_dispatches += 1
                return fut
        else:
            self._pool.submit(runner)
        return fut

    @staticmethod
    def _finish_future(fut: asyncio.Future, result, exc) -> None:
        # The watchdog may have abandoned this future already; a late
        # arrival is dropped silently (nobody is waiting for it).
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    async def _resolve(self, work: asyncio.Future, futures) -> None:
        try:
            # The watchdog is a failure detector, not flow control: a
            # wedged device call fails its own requests and frees the
            # in-flight slot instead of deadlocking the whole path.
            labels, probs = await asyncio.wait_for(
                asyncio.shield(work), self.dispatch_timeout_s
            )
        except Exception as e:
            if isinstance(e, asyncio.TimeoutError):
                self.timeouts += 1
                work.cancel()  # nobody will consume a late result
                e = RuntimeError(
                    f"device call exceeded {self.dispatch_timeout_s}s "
                    "(wedged accelerator or transport?)"
                )
            _log.error("batch of %d failed: %s", len(futures), e)
            for f in futures:
                if not f.done():
                    f.set_exception(e)
            return
        finally:
            self.inflight -= 1
            self._inflight.release()
        for f, label, prob in zip(futures, labels, probs):
            if not f.done():
                f.set_result((label, float(prob)))
