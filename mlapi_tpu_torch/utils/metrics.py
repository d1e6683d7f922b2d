"""In-process metrics: counters and latency histograms.

Backs the serving layer's ``/metrics`` endpoint. Thread-safe for the
serving model (the event loop plus the engine's one device thread).
Quantiles come from a reservoir sample, not fixed buckets.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field


def nearest_rank(values: list[float], q: float) -> float | None:
    """Nearest-rank quantile over unsorted values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


@dataclass
class Counter:
    name: str
    value: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Reservoir-sampled latency histogram (values in milliseconds)."""

    def __init__(self, name: str, reservoir_size: int = 4096):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._reservoir: list[float] = []
        self._size = reservoir_size
        self._rng = random.Random(0)
        self._lock = threading.Lock()

    def observe(self, value_ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value_ms
            if len(self._reservoir) < self._size:
                self._reservoir.append(value_ms)
            else:
                i = self._rng.randrange(self.count)
                if i < self._size:
                    self._reservoir[i] = value_ms

    def quantile(self, q: float) -> float | None:
        with self._lock:
            sample = list(self._reservoir)
        return nearest_rank(sample, q)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": (self.total / self.count) if self.count else None,
            "p50_ms": self.quantile(0.50),
            "p90_ms": self.quantile(0.90),
            "p99_ms": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named counters + histograms, rendered as one JSON object."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram(name))

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "histograms": {n: h.summary() for n, h in histograms.items()},
        }
