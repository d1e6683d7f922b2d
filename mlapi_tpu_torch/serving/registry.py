"""Multi-model registry (counterpart of
``mlapi_tpu/serving/registry.py::ModelRegistry``).

One process serves several models behind per-model routes:
``--model ID=CHECKPOINT`` (repeatable) builds a :class:`ModelRegistry`
of model ids to engines, with ``--checkpoint`` as the ``default``
entry. A generative entry runs its own lanes; a classifier gets a
``ScorePath`` whose batches ride the primary generative entry's
``UnitScheduler`` as ``score`` units: one card, one dispatch thread,
one policy. The per-tenant ledger (``TenantLedger``) waits for ROADMAP
Queue A item 5.
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
