"""Multi-model registry (counterpart of
``mlapi_tpu/serving/registry.py::ModelRegistry``).

One process serves several models behind per-model routes:
``--model ID=CHECKPOINT`` (repeatable) builds a :class:`ModelRegistry`
of model ids to engines, with ``--checkpoint`` as the ``default``
entry. A generative entry runs its own lanes; a classifier gets a
``ScorePath`` whose batches ride the primary generative entry's
``UnitScheduler`` as ``score`` units: one card, one dispatch thread,
one policy. :class:`TenantLedger` holds the per-tenant page and
adapter-slot quotas, weights and pressure counters (``--tenant-pages``,
``--tenant-slots``, ``--tenant-weight``), a copy of the JAX package's.
"""

from __future__ import annotations

import threading


class ModelRegistry:
    """An immutable id → engine map, plus which entries have started.

    The app builds its routes from the ids once; only the started set
    changes afterwards (startup and shutdown hooks, ``/healthz``), hence
    the lock."""

    def __init__(self, engines: dict, default_id: str = "default"):
        if default_id not in engines:
            raise ValueError(
                f"default model {default_id!r} not in registry "
                f"({', '.join(sorted(engines))})"
            )
        self._engines = dict(engines)
        self.default_id = default_id
        self._lock = threading.Lock()
        self._started: set[str] = set()

    @property
    def default(self):
        return self._engines[self.default_id]

    def get(self, model_id: str):
        return self._engines[model_id]

    def ids(self) -> list[str]:
        return sorted(self._engines)

    def items(self):
        return sorted(self._engines.items())

    def kind_of(self, model_id: str) -> str:
        return getattr(self._engines[model_id], "kind", "tabular")

    def generative_ids(self) -> list[str]:
        return [mid for mid, eng in self.items()
                if getattr(eng, "kind", "") == "generative"]

    def scoring_ids(self) -> list[str]:
        return [mid for mid, eng in self.items()
                if getattr(eng, "kind", "") != "generative"]

    def primary_generative(self):
        """The generative entry whose scheduler carries the registry's
        score units (the default when it is generative, else the first
        by id), or ``None`` in an all-scoring process (scoring paths
        then run on their worker pools)."""
        if self.kind_of(self.default_id) == "generative":
            return self._engines[self.default_id]
        gen = self.generative_ids()
        return self._engines[gen[0]] if gen else None

    def note_started(self, model_id: str) -> None:
        with self._lock:
            self._started.add(model_id)

    def note_stopped(self, model_id: str) -> None:
        with self._lock:
            self._started.discard(model_id)

    def started(self) -> set[str]:
        with self._lock:
            return set(self._started)

    def describe(self) -> dict:
        """The ``/healthz`` ``models`` block: id → kind, default-flagged."""
        return {
            mid: {"kind": self.kind_of(mid),
                  "default": mid == self.default_id}
            for mid in self.ids()
        }


class TenantLedger:
    """Per-tenant quotas, weights, and pressure counters.

    Crossed by three threads, the event loop (``engine.submit``'s enter
    and brownout), the unit scheduler's dispatch thread (the quota gate,
    deferral counts, terminal exits through ``GenRequest.finish``) and
    /metrics reads, so every mutable map lives under the one lock; no
    method calls out while holding it.

    A tenant is a request's ``tenant`` field, defaulting to its
    adapter id, defaulting to ``""`` (the anonymous tenant). Quotas
    are OPT-IN per tenant: an unlisted tenant is unquotaed (weight
    1.0), so single-tenant deployments pay nothing.
    """

    def __init__(
        self,
        *,
        quota_pages: dict | None = None,
        quota_slots: dict | None = None,
        weights: dict | None = None,
    ):
        self._lock = threading.Lock()
        # Static config (read-only after init).
        self._quota_pages = dict(quota_pages or {})
        self._quota_slots = dict(quota_slots or {})
        self._weights = dict(weights or {})
        # Live accounting.
        self._depth: dict[str, int] = {}
        self._deferrals: dict[str, int] = {}
        self._brownouts: dict[str, int] = {}

    # -- static config reads (no lock: frozen after init) --------------

    def quota_pages_of(self, tenant: str):
        return self._quota_pages.get(tenant)

    def quota_slots_of(self, tenant: str):
        return self._quota_slots.get(tenant)

    def weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, 1.0))

    # -- live accounting ------------------------------------------------

    def enter(self, tenant: str) -> None:
        """One request of this tenant went live (submit accepted it);
        balanced by :meth:`exit` at its terminal frame."""
        with self._lock:
            self._depth[tenant] = self._depth.get(tenant, 0) + 1

    def exit(self, tenant: str) -> None:
        with self._lock:
            d = self._depth.get(tenant, 0) - 1
            if d > 0:
                self._depth[tenant] = d
            else:
                self._depth.pop(tenant, None)

    def depth(self, tenant: str) -> int:
        with self._lock:
            return self._depth.get(tenant, 0)

    def note_deferral(self, tenant: str) -> None:
        """The scheduler deferred a group START on this tenant's quota
        (once per deferral episode, as ``sched_pages_deferred``)."""
        with self._lock:
            self._deferrals[tenant] = self._deferrals.get(tenant, 0) + 1

    def note_brownout(self, tenant: str) -> None:
        with self._lock:
            self._brownouts[tenant] = self._brownouts.get(tenant, 0) + 1

    def deferrals(self, tenant: str) -> int:
        with self._lock:
            return self._deferrals.get(tenant, 0)

    def brownouts(self, tenant: str) -> int:
        with self._lock:
            return self._brownouts.get(tenant, 0)

    def snapshot(self) -> dict:
        """The /metrics per-tenant block: every tenant with any live
        depth, deferral, or brownout history."""
        with self._lock:
            tenants = (
                set(self._depth) | set(self._deferrals)
                | set(self._brownouts)
            )
            return {
                t: {
                    "depth": self._depth.get(t, 0),
                    "deferrals": self._deferrals.get(t, 0),
                    "brownouts": self._brownouts.get(t, 0),
                }
                for t in tenants
            }


def parse_tenant_kv(pairs, what: str, cast=int) -> dict:
    """Parse repeated ``TENANT=VALUE`` CLI fragments; loud on malformed
    or duplicate entries (a dropped quota would enforce less than the
    operator wrote)."""
    out: dict = {}
    for p in pairs or ():
        if "=" not in p:
            raise ValueError(f"bad {what} {p!r} (want TENANT=VALUE)")
        t, _, v = p.partition("=")
        t = t.strip()
        if t in out:
            raise ValueError(f"duplicate {what} for tenant {t!r}")
        out[t] = cast(v)
    return out
