"""Deterministic fault injection for the serving engine.

A copy of ``mlapi_tpu/serving/faults.py`` restricted to the seams the
port has: the page pool's allocation, an admission's table install,
prefill-chunk dispatch, decode-chunk dispatch, each speculative verify
block, the unit scheduler's dispatch of each unit, the collector's
queue pop, the per-request stream push, a scoring batch's device call
and an adapter's install into the slot pool. Tests and chaos drills
force failures there and check that every stream still ends in
a well-formed terminal frame and that the engine serves fresh work.

- Zero overhead when disarmed: ``fire()`` is one module-global bool
  check.
- Deterministic: triggers are call counts (``after=N`` skips the first
  N calls; ``every=N`` fires each Nth), never randomness or the clock.

Arming, by env or explicitly::

    MLAPI_FAULTS="decode:after=3:raise,stream_push:every=5:delay=0.05"

Grammar: comma-separated clauses ``point[:trigger]*[:action]``;
actions ``raise`` (default) or ``delay=<seconds>``; triggers
``after=N`` or ``every=N`` (at most one) plus ``times=M`` (default 1
for ``raise``, unlimited for ``delay``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

POINTS = (
    "pool_alloc",      # PagePool.alloc, before the free list changes
    "table_install",   # a joiner's admission, after its page alloc
    "prefill_chunk",   # each chunked-prefill chunk dispatch
    "decode",          # each decode-chunk dispatch
    "spec_verify",     # each speculative verify block (solo + batched)
    "sched_unit",      # the unit scheduler, before each unit (formation
                       # included): a raise kills that lane only
    "collector_pop",   # the collector claiming a queued request
    "score_dispatch",  # a scoring batch's device call, on its runner
                       # thread: a raise fails that batch's requests
    "stream_push",     # a token chunk entering a request's queue
    "tier_spill",      # KV tier: registering an evicted prefix blob
    "tier_restore",    # KV tier: applying a blob back to device
    "adapter_install",  # an adapter's install into the slot pool (the
                        # dispatch thread), after its validation and
                        # before the slot allocation: a raise rejects
                        # the install on untouched state and the
                        # requests get it as their terminal frame
)

ENV_VAR = "MLAPI_FAULTS"


class InjectedFault(RuntimeError):
    """The armed-point failure (``action=raise``)."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


class _Rule:
    __slots__ = (
        "point", "action", "delay_s", "after", "every", "times",
        "calls", "fired",
    )

    def __init__(self, point, action, delay_s, after, every, times):
        self.point = point
        self.action = action       # "raise" | "delay"
        self.delay_s = delay_s
        self.after = after
        self.every = every
        self.times = times         # None = unlimited
        self.calls = 0
        self.fired = 0

    def due(self) -> bool:
        """Call-count trigger decision (caller holds the lock and has
        already bumped ``calls``)."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.every is not None:
            return self.calls % self.every == 0
        if self.after is not None:
            return self.calls > self.after
        return True


# Module-global armed state: ONE bool gates the hot path.
armed = False
_rules: dict[str, _Rule] = {}
_lock = threading.Lock()
_injected = 0


def parse(spec: str) -> dict[str, _Rule]:
    """Parse an ``MLAPI_FAULTS`` spec; loud on unknown points or
    malformed clauses (a typo'd drill must not silently test
    nothing)."""
    rules: dict[str, _Rule] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        fields = clause.split(":")
        point = fields[0].strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {', '.join(POINTS)}"
            )
        action = None
        delay_s = 0.0
        after = every = times = None
        for f in fields[1:]:
            f = f.strip()
            if f == "raise":
                action = "raise"
            elif f.startswith("delay="):
                action = "delay"
                delay_s = float(f[len("delay="):])
                if delay_s < 0:
                    raise ValueError(f"negative delay in {clause!r}")
            elif f.startswith("after="):
                after = int(f[len("after="):])
            elif f.startswith("every="):
                every = int(f[len("every="):])
                if every < 1:
                    raise ValueError(f"every must be >= 1 in {clause!r}")
            elif f.startswith("times="):
                times = int(f[len("times="):])
            else:
                raise ValueError(
                    f"bad fault field {f!r} in {clause!r} (want raise, "
                    f"delay=S, after=N, every=N, or times=N)"
                )
        if after is not None and every is not None:
            raise ValueError(f"both after= and every= in {clause!r}")
        if point in rules:
            raise ValueError(f"duplicate fault point {point!r}")
        if action is None:
            action = "raise"
        if times is None and action == "raise":
            times = 1
        rules[point] = _Rule(point, action, delay_s, after, every, times)
    return rules


def arm(spec: str | None = None) -> None:
    """Install a fault spec (replaces any armed one). ``None`` reads
    ``$MLAPI_FAULTS``; an empty spec disarms."""
    global armed, _injected
    if spec is None:
        spec = os.environ.get(ENV_VAR, "")
    rules = parse(spec)
    with _lock:
        _rules.clear()
        _rules.update(rules)
        _injected = 0
        armed = bool(rules)


def arm_from_env() -> bool:
    """Arm from ``$MLAPI_FAULTS`` if set (server startup hook)."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return False
    arm(spec)
    return True


def disarm() -> None:
    global armed, _injected
    with _lock:
        _rules.clear()
        _injected = 0
        armed = False


def injected_count() -> int:
    """Faults fired under the current arming (0 when disarmed)."""
    with _lock:
        return _injected


@contextlib.contextmanager
def active(spec: str):
    """Test-scoped arming that always disarms."""
    arm(spec)
    try:
        yield
    finally:
        disarm()


def fire(point: str, exc: BaseException | None = None) -> None:
    """The seam call. Disarmed: one bool check. Armed: bump the point's
    call count and, when due, sleep or raise."""
    if not armed:
        return
    with _lock:
        rule = _rules.get(point)
        if rule is None:
            return
        rule.calls += 1
        if not rule.due():
            return
        rule.fired += 1
        global _injected
        _injected += 1
        action, delay_s = rule.action, rule.delay_s
    if action == "delay":
        time.sleep(delay_s)
        return
    raise exc if exc is not None else InjectedFault(point)
