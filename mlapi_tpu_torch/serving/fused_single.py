"""Fused-chunk width policy for generative serving.

Counterpart of ``mlapi_tpu/serving/fused_single.py::FusedSinglePath``.
One :class:`FusedSinglePath` per :class:`TextGenerationEngine`. A batch
whose rows are all non-streaming decodes in TIER-WIDE chunks through
the same ``decode_chunk_fn`` the plain path uses (the same B1/B3 calls,
one per layer per step, ``w`` steps long); each such chunk is one
``"decode"`` unit at a ``BatchRun.units()`` boundary, so deadlines,
speculation, brownout, faults and drain apply between fused chunks,
and a concurrent lane stalls at most one fused-chunk dispatch
(``engine.sched_lane_stall_max``). Fewer, wider chunks mean fewer
chunk boundaries, each of which costs host work and a possible sync.

The policy:

- :meth:`tiers`: the fused width ladder, powers of two of ``chunk``
  from the default budget's tier up to ``fused_max_new``'s.
- :meth:`chunk_width`: the formation-time decision, the batch's top
  fused width (0 pins the plain ``eng.chunk``).
- :meth:`width_at`: the width at each decode boundary, shrunk to the
  smallest power of two of ``chunk`` covering the live rows' remaining
  budgets, and the plain chunk while a streaming row is live.

What has no counterpart: the JAX package's strict-mode gate, its
``warmed`` set and ``warm()`` exist to keep XLA compiles of unwarmed
fused widths off the request path (``engine._strict_admit``). Nothing
compiles per shape in the port (a kernel builds once, for every width),
so any width is taken at once; the JAX engine runs the same way until a
full warmup arms strict mode.
"""

from __future__ import annotations


class FusedSinglePath:
    def __init__(self, engine):
        self.eng = engine

    def tiers(self) -> list:
        """The fused width ladder, ascending: powers of two (of
        ``chunk``) from the default budget's tier up to the
        ``fused_max_new`` cap's. Smaller budgets shrink per boundary
        through :meth:`width_at`."""
        eng = self.eng
        t = eng.default_tier
        tiers = [t]
        while t < eng.fused_max_new:
            t *= 2
            tiers.append(t)
        return tiers

    def chunk_width(self, run) -> int:
        """Formation-time fused width of ``run``: the smallest ladder
        tier covering the batch's token budget (the top rung when the
        budget exceeds ``fused_max_new``: the cap bounds the width of
        one dispatch, not eligibility). 0 pins the plain ``eng.chunk``:
        the path is off, a row streams at formation (a streaming joiner
        that arrives later drops the width per boundary instead), or
        the ladder would not beat the plain chunk."""
        eng = self.eng
        if not eng.fused_single:
            return 0
        if any(r.stream for r in run.reqs):
            return 0
        w = eng.chunk
        for t in self.tiers():
            w = t
            if t >= run.n_new_max:
                break
        return w if w > eng.chunk else 0

    def width_at(self, run, live: list) -> int:
        """The dispatch width at a decode boundary of a fused batch:
        the smallest power of two of ``chunk`` covering the live rows'
        remaining budgets, capped at the formation width, so the tail
        of a generation never dispatches (or maps pages) wider than it
        can use. 0 (the plain chunk) while a streaming row is live."""
        eng = self.eng
        reqs = run.reqs
        if any(reqs[i].stream for i in live):
            return 0
        need = max(reqs[i].n_new - run.sched[i] for i in live)
        w = eng.chunk
        while w < need:
            w *= 2
        w = min(w, run.fused_w)
        return w if w > eng.chunk else 0
