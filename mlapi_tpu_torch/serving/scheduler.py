"""The unit scheduler: one typed-unit queue over concurrent batches.

Counterpart of ``mlapi_tpu/serving/scheduler.py::UnitScheduler``, its
generation lanes:

- **Lanes.** Each formed request group becomes a lane: a
  :class:`~mlapi_tpu_torch.serving.batch_run.BatchRun` and its
  ``units()`` generator, which yields a typed unit (``prefill``,
  ``decode``, ``spec``, ``admit``, ``compact``) after each piece of
  device work.
  ``max_batches`` lanes may be live at once; at 1 the same machinery
  runs one batch at a time, so the two modes run the same code and
  give the same greedy streams wherever they form the same batches.
- **One dispatch thread.** Every lane advances on this thread, one unit
  at a time: the CUDA stream stays serial and only the order across
  batches is policy. The thread runs under ``torch.inference_mode()``
  (thread-local, so it is entered here, not by the caller).
- **Policy.** Every candidate gets an urgency in seconds: the least
  deadline slack of its live requests, else a relaxed constant that
  tightens from the engine's ``LatencyStats`` (a pending group queued
  past twice the TTFT p95 competes at that p95; a running lane at the
  inter-token p50). The least urgency wins; exact ties go to the lane
  picked least recently, so equal lanes alternate. A lane whose slack
  is inside about one formation blocks new group starts.
- **Page budget.** Paged lanes share the engine's pool. A lane reserves
  its worst case (``_page_need``, plus ``spec_k + 1`` slots a row for a
  speculative verify block when a draft is attached) at start, and a
  pending group starts beside live lanes only if its worst case and the
  live reservations fit the pool; otherwise it waits
  (``sched_pages_deferred``, once per episode). With no lane live a
  group starts regardless.
- **Score units.** A co-resident scoring path
  (``serving/scoring.py::ScorePath``) hands each formed batch in as a
  ``score`` unit (``submit_score``): a FIFO beside the lanes whose head
  competes with the most urgent lane each dispatch slot. Deadlines on
  either side decide by least slack (an override of alternation counts
  as a preemption); with none anywhere score and lane units strictly
  alternate, so neither can starve the other. A deadline-less score
  unit's urgency ages from its model's first-result p95 (floor 5 ms) to
  zero. Each counts in ``sched_units_score``, enters the trace as
  ``(0, "score")`` and the head-of-line streak as pseudo-lane 0.
- **Faults.** The ``sched_unit`` point fires before each unit, the
  formation and score units included: a raise kills that lane (its
  generator is closed, its pages go back, its waiters get the error) or
  fails that scoring batch only.

- **Adapters and tenants.** The start gate has an adapter-slot term:
  a group whose adapters could not all claim a slot now (free, or
  evictable because no live run holds it) waits
  (``sched_adapters_deferred``). With a ``TenantLedger`` on the engine
  it also has per-tenant terms (``_tenant_split``, ``_tenant_block``):
  a tenant already holding reservations may not grow past its page or
  adapter-slot quota (``sched_tenant_pages_deferred``,
  ``sched_tenant_adapters_deferred``, and the ledger's per-tenant
  deferrals); and a candidate's slack is divided by its highest tenant
  weight.

A spec unit is one speculative phase of a lane (``serving/spec_phase.py``),
which ends at a round boundary once other lanes or pending groups have
work (``engine._spec_should_yield``). The reference's
``_rebind_pool`` and ``_writeback_pool`` have no counterpart: the port's
pool tensors are written in place and never donated, so no lane's view
of them goes stale.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.scheduler")

# The kinds a lane's generator yields (score units come from
# ``submit_score``, never from a lane).
UNIT_KINDS = ("prefill", "decode", "spec", "admit", "compact")

# Urgency (seconds) of work nobody waits on with a deadline and that
# the latency reservoirs do not yet flag: above any real deadline,
# finite so the order stays total.
_RELAXED_S = 3600.0


class _Group:
    """A formed request group waiting for a lane."""

    __slots__ = ("reqs", "t_submit", "deferred_counted")

    def __init__(self, reqs: list):
        self.reqs = reqs
        self.t_submit = time.perf_counter()
        # One sched_pages_deferred per deferral episode, not per check.
        self.deferred_counted = False


class _Lane:
    """One live BatchRun and its unit generator."""

    __slots__ = ("lane_id", "run", "gen", "last_pick", "reserved",
                 "tenant_pages", "tenant_adapters")

    def __init__(self, lane_id: int, run, gen, pick_seq: int,
                 reserved: int = 0, tenant_pages: dict | None = None,
                 tenant_adapters: dict | None = None):
        self.lane_id = lane_id
        self.run = run
        self.gen = gen
        self.last_pick = pick_seq
        # Worst-case page footprint, fixed at lane start.
        self.reserved = reserved
        # The same reservation split by tenant (tenant -> pages, tenant
        # -> adapter-id set), fixed at lane start: the quota gate sums
        # these, so a tenant's held footprint only shrinks.
        self.tenant_pages = tenant_pages or {}
        self.tenant_adapters = tenant_adapters or {}

    @property
    def reqs(self) -> list:
        return self.run.reqs


class _ScoreUnit:
    """One formed scoring batch as a typed unit: ``fn`` runs the device
    call on the dispatch thread and resolves the batch's futures
    thread-safely; ``fail`` delivers the stop-path error without
    running it."""

    __slots__ = ("fn", "fail", "n_rows", "deadline", "stats", "weight",
                 "t_submit", "target")

    def __init__(self, fn, fail, n_rows: int, deadline: float | None,
                 stats, weight: float):
        self.fn = fn
        self.fail = fail
        self.n_rows = n_rows
        self.deadline = deadline   # perf_counter domain, or None
        self.stats = stats         # the scoring model's LatencyStats
        self.weight = max(float(weight), 1e-6)
        self.t_submit = time.perf_counter()
        # The deadline-less aging target: the scoring model's observed
        # first-result p95 (floor 5 ms), frozen at submit so the
        # dispatch thread never sorts a reservoir.
        self.target = 0.005
        if stats is not None:
            t95 = stats.summary()["ttft_p95_ms"]
            if t95:
                self.target = max(t95 / 1e3, 0.005)


def _min_slack(reqs, now: float) -> float | None:
    """Least deadline slack (s) among live deadlined requests, or
    ``None`` when none carries a deadline."""
    best = None
    for r in reqs:
        d = getattr(r, "deadline", None)
        if d is None or getattr(r, "cancelled", False):
            continue
        s = d - now
        if best is None or s < best:
            best = s
    return best


class UnitScheduler:
    """The engine's typed-unit queue over concurrent BatchRuns, created
    by ``engine.start()`` and stopped by ``engine.stop()``."""

    def __init__(self, eng, max_batches: int = 2):
        self.eng = eng
        self.max_batches = max(1, int(max_batches))
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: list[_Group] = []
        self._lanes: list[_Lane] = []
        # The group claimed off _pending whose formation is running:
        # in neither list, yet in flight for idle/backlog/drain.
        self._forming_group: _Group | None = None
        # Score units from co-resident scoring paths, FIFO (their
        # batches are alike, so arrival order is deadline order), and
        # whether the last dispatch was one (the alternation state).
        self._score: collections.deque = collections.deque()
        self._last_was_score = False
        self._stopped = False
        self._pick_seq = 0
        self._lane_seq = 0
        # Cross-lane head-of-line accounting (sched_lane_stall_max).
        self._last_lane = -1
        self._streak = 0
        # The LatencyStats snapshot, refreshed every 32 picks.
        self._summary_cache = None
        self._summary_seq = -1000
        # Bounded unit trace of (lane_id, kind): the interleaving the
        # tests read, never wall-clock.
        self.trace: collections.deque = collections.deque(maxlen=2048)
        self._thread = threading.Thread(
            target=self._loop, name="unitsched", daemon=True
        )
        self._thread.start()

    # -- intake / shutdown (event-loop side) ---------------------------

    def submit(self, reqs: list) -> None:
        """Hand a formed group to the unit queue."""
        with self._work:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            self._pending.append(_Group(reqs))
            self._work.notify_all()

    def submit_score(self, fn, fail, *, n_rows: int = 0,
                     deadline: float | None = None, stats=None,
                     weight: float = 1.0) -> None:
        """Hand one formed scoring batch to the unit queue (event-loop
        side, from ScorePath). Raises once stopped, so the caller falls
        back to its worker pool."""
        with self._work:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            self._score.append(
                _ScoreUnit(fn, fail, n_rows, deadline, stats, weight)
            )
            self._work.notify_all()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the dispatch thread; whatever is still pending or live
        gets the engine-stopped error as its terminal frame."""
        with self._work:
            self._stopped = True
            self._work.notify_all()
        self._thread.join(timeout=timeout_s)

    # -- observability -------------------------------------------------

    @property
    def backlog(self) -> int:
        """Requests formed but not running: pending groups and the one
        mid-formation (counted into ``engine.queue_depth``)."""
        with self._lock:
            n = sum(len(g.reqs) for g in self._pending)
            if self._forming_group is not None:
                n += len(self._forming_group.reqs)
            return n

    @property
    def queue_depth(self) -> int:
        """One runnable unit per live lane, one formation per pending or
        forming group, and every queued score unit."""
        with self._lock:
            return (len(self._pending) + len(self._lanes)
                    + (1 if self._forming_group is not None else 0)
                    + len(self._score))

    @property
    def batches_live(self) -> int:
        with self._lock:
            return len(self._lanes)

    def lane_groups(self) -> list:
        """Copies of each live lane's request list, for the collector's
        admission check (a lane that retires after the snapshot leaves
        its staged joiners to the collector's sweep)."""
        with self._lock:
            return [list(ln.run.reqs) for ln in self._lanes]

    @property
    def idle(self) -> bool:
        with self._lock:
            return (not self._pending and not self._lanes
                    and self._forming_group is None and not self._score)

    def sweep_requests(self) -> list:
        """Drain's sweep once its budget is spent: pop every pending
        group's requests and list every live lane's and the forming
        group's (cancel-only: their generators own them and notice at
        the next boundary)."""
        with self._lock:
            out: list = []
            for g in self._pending:
                out += g.reqs
            self._pending.clear()
            for lane in self._lanes:
                out += list(lane.run.reqs)
            if self._forming_group is not None:
                out += list(self._forming_group.reqs)
            return out

    # -- the dispatch loop ---------------------------------------------

    def _loop(self) -> None:
        # inference_mode is thread-local: units run on this thread.
        with torch.inference_mode():
            while True:
                with self._work:
                    while (not self._stopped and not self._lanes
                           and not self._pending and not self._score):
                        self._work.wait(timeout=0.1)
                    if self._stopped:
                        break
                try:
                    started = self._maybe_start()
                    su = self._claim_score()
                    if su is not None:
                        self._dispatch_score(su)
                        continue
                    lane = self._pick()
                    if lane is not None:
                        self._advance(lane)
                        self._last_was_score = False
                    elif not started:
                        # Pending work blocked on the page budget with
                        # no lane live to release: wait a tick.
                        time.sleep(0.002)
                except Exception:  # noqa: BLE001 — the loop must survive
                    _log.exception("unit scheduler internal error")
                    time.sleep(0.01)
            # Stopped: the collector's error contract for what is left
            # (a normal shutdown drains first).
            err = RuntimeError("generation engine stopped")
            with self._lock:
                pending, self._pending = self._pending, []
                lanes, self._lanes = self._lanes, []
                score = list(self._score)
                self._score.clear()
            for su in score:
                try:
                    su.fail(err)  # the batch's futures get the error
                except Exception:  # noqa: BLE001
                    _log.exception("score-unit fail delivery failed")
            for lane in lanes:
                try:
                    lane.gen.close()
                except Exception:  # noqa: BLE001 — cleanup below
                    pass
                try:
                    # A never-advanced generator's close() runs no
                    # finally: release the lane's pages directly.
                    lane.run._paged_cleanup()
                except Exception:  # noqa: BLE001
                    _log.exception("lane cleanup failed")
                self._deliver_error(lane.run.reqs, err)
            for g in pending:
                self._deliver_error(g.reqs, err)

    @staticmethod
    def _deliver_error(reqs, err) -> None:
        for r in reqs:
            if getattr(r, "cancelled", False):
                continue
            try:
                r.push(err)
            except Exception:  # noqa: BLE001 — a dead consumer
                pass

    # -- policy --------------------------------------------------------

    def _weight_of(self, reqs) -> float:
        """The highest tenant weight among a candidate's requests (1.0
        without a ledger or for anonymous tenants). Slack is divided by
        it: a weight-2 tenant's 100 ms compete like 50 ms, winning ties
        without starving weight-1 traffic."""
        led = getattr(self.eng, "tenants", None)
        if led is None:
            return 1.0
        w = 1.0
        for r in reqs:
            t = getattr(r, "tenant", "") or ""
            if t:
                w = max(w, led.weight(t))
        return w

    @staticmethod
    def _tenant_split(reqs, row_pages: int) -> tuple[dict, dict]:
        """(tenant -> worst-case pages, tenant -> adapter-id set) of a
        group; anonymous tenants are unquotaed and left out."""
        pages: dict = {}
        adapters: dict = {}
        for r in reqs:
            t = getattr(r, "tenant", "") or ""
            if not t:
                continue
            pages[t] = pages.get(t, 0) + row_pages
            a = getattr(r, "adapter", None)
            if a is not None:
                adapters.setdefault(t, set()).add(a)
        return pages, adapters

    def _tenant_block(self, g: _Group, row_pages: int):
        """The per-tenant term of the start gate (the caller holds the
        lock): a tenant already HOLDING reservations may not grow past
        its quota; one holding nothing starts regardless (a quota below
        one group must fail loudly downstream, not starve). Returns the
        blocking ``(kind, tenant)`` or None."""
        led = getattr(self.eng, "tenants", None)
        if led is None or not self._lanes:
            return None
        need_pages, need_adapters = self._tenant_split(g.reqs, row_pages)
        for t, need in need_pages.items():
            quota = led.quota_pages_of(t)
            if quota is None:
                continue
            held = sum(ln.tenant_pages.get(t, 0) for ln in self._lanes)
            if held and need + held > quota:
                return ("pages", t)
        for t, ads in need_adapters.items():
            quota = led.quota_slots_of(t)
            if quota is None:
                continue
            held = set()
            for ln in self._lanes:
                held |= ln.tenant_adapters.get(t, set())
            if held and len(held | ads) > quota:
                return ("slots", t)
        return None

    def _urgency_group(self, g: _Group, now: float, summary) -> float:
        w = self._weight_of(g.reqs)
        slack = _min_slack(g.reqs, now)
        if slack is not None:
            return slack / w
        # A deadline-less group queued past twice the TTFT p95 competes
        # like a near-due deadline; cold reservoirs keep it relaxed.
        ttft = (summary["ttft_p95_ms"] or 0.0) / 1e3
        if ttft > 0.0 and (now - g.t_submit) > 2.0 * ttft:
            return ttft / w
        return _RELAXED_S / w

    def _urgency_lane(self, lane: _Lane, now: float, summary) -> float:
        w = self._weight_of(lane.run.reqs)
        slack = _min_slack(lane.run.reqs, now)
        if slack is not None:
            return slack / w
        # A deadline-less running lane competes at the inter-token p50:
        # equal for all such lanes, so they alternate.
        itl = (summary["intertoken_p50_ms"] or 0.0) / 1e3
        return (itl if itl > 0.0 else _RELAXED_S) / w

    # -- score units -----------------------------------------------------

    @staticmethod
    def _urgency_score(su: _ScoreUnit, now: float) -> float:
        """Weighted urgency of a queued scoring batch: its deadline slack,
        else its aging target minus its wait (reaching 0 within one
        target, so lanes delay it at most that long)."""
        if su.deadline is not None:
            return (su.deadline - now) / su.weight
        return max(su.target - (now - su.t_submit), 0.0) / su.weight

    def _claim_score(self) -> _ScoreUnit | None:
        """Score or lane for this dispatch slot: pop the head score unit
        when scoring wins. With no lane live it always wins; with a
        deadline on either side the least weighted urgency wins (an
        override of alternation for a real deadline counts in
        ``sched_deadline_preempts``); with none anywhere the two
        alternate."""
        with self._lock:
            if not self._score:
                return None
            su = self._score[0]
            lanes = list(self._lanes)
        if not lanes:
            with self._lock:
                return self._score.popleft() if self._score else None
        now = time.perf_counter()
        u_score = self._urgency_score(su, now)
        summary = self._cached_summary()
        u_lane = min(self._urgency_lane(ln, now, summary) for ln in lanes)
        score_deadlined = su.deadline is not None
        lane_deadlined = any(
            _min_slack(ln.run.reqs, now) is not None for ln in lanes
        )
        alternation = not self._last_was_score
        if score_deadlined or lane_deadlined:
            take = u_score <= u_lane
            if take != alternation and (
                score_deadlined if take else lane_deadlined
            ):
                self.eng.sched_deadline_preempts += 1
        else:
            take = alternation
        if not take:
            return None
        with self._lock:
            return self._score.popleft() if self._score else None

    def _dispatch_score(self, su: _ScoreUnit) -> None:
        """One score unit on this thread: the device call inline (``fn``
        resolves its futures), then the accounting lanes get: the kind
        counter, the trace, the head-of-line streak as pseudo-lane 0."""
        eng = self.eng
        with self._lock:
            n_live = len(self._lanes)
        try:
            faults.fire("sched_unit")
            su.fn()
        except Exception as e:  # noqa: BLE001 — unit-scoped failure
            _log.error("score unit of %d rows failed: %s", su.n_rows, e)
            try:
                su.fail(e)
            except Exception:  # noqa: BLE001
                _log.exception("score-unit fail delivery failed")
        eng.sched_units_score += 1
        self.trace.append((0, "score"))
        # A score unit is one more live party for the streak gauge.
        self._note_dispatch(0, n_live + 1)
        self._last_was_score = True
        self._pick_seq += 1

    def _pick(self) -> _Lane | None:
        """The least-urgency lane; exact ties go least recently picked.
        A pick that overrides that order for a real deadline counts as
        a preemption."""
        now = time.perf_counter()
        with self._lock:
            lanes = list(self._lanes)
        if not lanes:
            return None
        if len(lanes) == 1:
            chosen = lanes[0]
        else:
            summary = self._cached_summary()
            scored = [(self._urgency_lane(ln, now, summary), ln.last_pick, ln)
                      for ln in lanes]
            scored.sort(key=lambda t: (t[0], t[1]))
            chosen = scored[0][2]
            fair = min(scored, key=lambda t: t[1])[2]
            if chosen is not fair and _min_slack(
                chosen.run.reqs, now
            ) is not None:
                self.eng.sched_deadline_preempts += 1
        self._pick_seq += 1
        chosen.last_pick = self._pick_seq
        return chosen

    # -- lane lifecycle ------------------------------------------------

    def _page_need(self, reqs) -> int:
        """Worst-case pool footprint of a group from the batch geometry
        BatchRun builds: every row spans the group's full cache length.
        Prefix sharing and early finishes only use less."""
        return len(reqs) * self._row_pages(reqs)

    def _row_pages(self, reqs) -> int:
        """Per-row worst-case pages of a group (rows re-pack to its
        geometry), with a speculative verify block's headroom when a
        draft is attached."""
        eng = self.eng
        span = eng._cache_len(
            max(r.prefix_len for r in reqs) + max(len(r.row) for r in reqs),
            max(r.n_new for r in reqs),
        ) + (eng.spec_k + 1 if eng.draft_model is not None else 0)
        return -(-span // eng.pool.page)

    def _claim_next_group(self) -> _Group | None:
        """Pop the most urgent pending group that passes the start gate,
        under one lock hold: its page worst case plus every live lane's
        reservation within the pool (prefix-entry pages are evictable
        and do not count), its adapters claimable, then its tenants'
        quotas. With no lane live a group starts regardless."""
        now = time.perf_counter()
        pool = self.eng.pool
        with self._lock:
            n_pending = len(self._pending)
            if not n_pending or len(self._lanes) >= self.max_batches:
                return None
        summary = self._cached_summary() if n_pending > 1 else None
        with self._lock:
            if not self._pending or len(self._lanes) >= self.max_batches:
                return None
            if summary is not None and len(self._pending) > 1:
                order = sorted(
                    enumerate(self._pending),
                    key=lambda t: (self._urgency_group(t[1], now, summary),
                                   t[0]),
                )
            else:
                order = list(enumerate(self._pending))
            held = sum(ln.reserved for ln in self._lanes)
            eng = self.eng
            for _, g in order:
                pages_ok = (pool is None or not self._lanes
                            or self._page_need(g.reqs) + held
                            <= pool.pages_total)
                slots_ok = (eng.adapters is None or not self._lanes
                            or eng.adapters.can_claim({
                                r.adapter for r in g.reqs
                                if getattr(r, "adapter", None) is not None
                            }))
                t_block = None
                if pages_ok and slots_ok:
                    # Checked once the pool-wide terms pass: a tenant
                    # deferral means only the tenant's quota said no.
                    t_block = self._tenant_block(
                        g, self._row_pages(g.reqs) if pool is not None
                        else 0)
                    if t_block is None:
                        self._pending.remove(g)
                        self._forming_group = g
                        return g
                if not g.deferred_counted:
                    # Once per deferral episode, not per check.
                    g.deferred_counted = True
                    if t_block is not None:
                        kind, tenant = t_block
                        if eng.tenants is not None:
                            eng.tenants.note_deferral(tenant)
                        if kind == "pages":
                            eng.sched_tenant_pages_deferred += 1
                        else:
                            eng.sched_tenant_adapters_deferred += 1
                    elif pages_ok:
                        eng.sched_adapters_deferred += 1
                    else:
                        eng.sched_pages_deferred += 1
            return None

    def _cached_summary(self):
        """``LatencyStats.summary()`` (which sorts both reservoirs),
        recomputed every 32 picks."""
        if (self._summary_cache is None
                or self._pick_seq - self._summary_seq >= 32):
            self._summary_cache = self.eng.latency.summary()
            self._summary_seq = self._pick_seq
        return self._summary_cache

    def _urgent_lane_blocks_start(self) -> bool:
        """A live lane whose slack is inside about one formation (twice
        the TTFT p95, floor 125 ms) outranks starting a group."""
        with self._lock:
            if not self._pending or not self._lanes:
                return False
            lanes = list(self._lanes)
        now = time.perf_counter()
        slack = None
        for ln in lanes:
            s = _min_slack(ln.run.reqs, now)
            if s is not None and (slack is None or s < slack):
                slack = s
        if slack is None:
            return False
        ttft = (self._cached_summary()["ttft_p95_ms"] or 0.0) / 1e3
        return slack < 2.0 * max(ttft, 0.125)

    def _maybe_start(self) -> bool:
        """Start pending groups in urgency order while lane slots and
        the page budget allow; formation runs here as the lane's first
        unit."""
        started = False
        while True:
            if self._urgent_lane_blocks_start():
                return started
            g = self._claim_next_group()
            if g is None:
                return started
            try:
                self._start_lane(g)
            finally:
                with self._lock:
                    self._forming_group = None
            started = True

    def _start_lane(self, g: _Group) -> None:
        """Formation as a unit: the engine's ``_form_batch`` (its queued
        expiry sweep, then the BatchRun's prefill), then the lane. A
        failure goes to this group's waiters only."""
        eng, reqs = self.eng, g.reqs
        try:
            faults.fire("sched_unit")
            run = eng._form_batch(reqs, admit=True)
            if run is None:
                return  # every request expired before formation
        except Exception as e:  # noqa: BLE001 — delivered to waiters
            _log.error("scheduler formation of %d failed: %s", len(reqs), e)
            self._deliver_error(reqs, e)
            return
        eng.sched_units_prefill += 1  # formation is the prefill unit
        row_pages = self._row_pages(reqs) if eng.pool is not None else 0
        t_pages, t_adapters = self._tenant_split(reqs, row_pages)
        with self._lock:
            self._lane_seq += 1
            lane = _Lane(self._lane_seq, run, run.units(), self._pick_seq,
                         reserved=len(reqs) * row_pages,
                         tenant_pages=t_pages, tenant_adapters=t_adapters)
            self._lanes.append(lane)
            live = len(self._lanes)
        self.trace.append((lane.lane_id, "prefill"))
        self._note_dispatch(lane.lane_id, live)
        if live > eng.sched_batches_live_max:
            eng.sched_batches_live_max = live

    def _note_dispatch(self, lane_id: int, n_live: int) -> None:
        """The longest run of consecutive units one lane got while
        another lane was live: the bound on cross-lane head-of-line
        stall (``sched_lane_stall_max``)."""
        if n_live > 1 and lane_id == self._last_lane:
            self._streak += 1
        else:
            self._streak = 1
        self._last_lane = lane_id
        if n_live > 1 and self._streak > self.eng.sched_lane_stall_max:
            self.eng.sched_lane_stall_max = self._streak

    def _advance(self, lane: _Lane) -> None:
        """One unit of one lane."""
        eng, run = self.eng, lane.run
        err: BaseException | None = None
        done = False
        kind = None
        try:
            faults.fire("sched_unit")
            kind = next(lane.gen)
            if kind not in UNIT_KINDS:
                raise RuntimeError(f"unknown unit kind {kind!r}")
        except StopIteration:
            done = True
        except Exception as e:  # noqa: BLE001 — lane-scoped failure
            err, done = e, True
            kind = kind if kind in UNIT_KINDS else None
            try:
                lane.gen.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                # close() on a generator that never started runs no
                # finally: release the formation's pages (idempotent).
                run._paged_cleanup()
            except Exception:  # noqa: BLE001
                _log.exception("lane cleanup failed")
        if kind is not None:
            counter = f"sched_units_{kind}"
            setattr(eng, counter, getattr(eng, counter) + 1)
            self.trace.append((lane.lane_id, kind))
            with self._lock:
                n_live = len(self._lanes)
            self._note_dispatch(lane.lane_id, n_live)
        if err is not None:
            _log.error("scheduler lane of %d failed: %s", len(run.reqs), err)
            self._deliver_error(run.reqs, err)
        if done:
            with self._work:
                try:
                    self._lanes.remove(lane)
                except ValueError:
                    pass
                self._work.notify_all()
            # A retired lane frees a slot and may strand staged
            # joiners: wake the collector now, not at its next poll.
            eng._wake_collector()
