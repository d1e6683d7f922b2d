"""The serving application: ``POST /generate``, ``/healthz``, ``/metrics``.

Counterpart of ``mlapi_tpu/serving/app.py`` for a generative engine:

- ``POST /generate`` takes ``text``, ``max_new_tokens``, ``temperature``,
  ``top_k``, ``top_p``, ``seed``, ``stream``, ``stop``, ``prefix`` and
  ``deadline_ms``. Concurrent requests coalesce into one batch.
  ``"stream": true`` answers NDJSON: one ``{"token_ids": [...]}`` line
  per decoded chunk, then a ``{"done": true, "text", "token_ids",
  "prompt_tokens"}`` line whose ``token_ids`` is the FULL list; an error
  ends a stream with ``{"error", "code"}``. ``prefix`` makes the prompt
  ``prefix + text`` with the prefix's KV computed once and cached
  (``serving/prefix.py``); an invalid one (empty after tokenizing, too
  long for the window) is a 422 at ``["prefix"]``. ``deadline_ms`` (> 0)
  is the request's wall-clock budget: a deadline that passes ends the
  request with ``deadline_exceeded`` (504 unary), one the admission
  estimate says cannot be met is shed with a 503. The JAX package's
  ``adapter`` and ``tenant`` fields are refused with a 422, since the
  port does not serve them yet.
- ``GET /healthz``: liveness (``"draining"`` once shutdown began), queue
  depth, model, checkpoint, device, and the KV page size and pool size
  (0 for a contiguous cache).
- ``GET /metrics``: the request counters and latency histograms, plus
  the JAX package's ``generate.*`` names for what the port has (the
  scheduler's ``sched_*``, the sheds, expiries and brownout clamps
  among them), and the CUDA kernels' launch counts under ``kernels``.

Every 503 carries ``retry-after``: an exhausted KV page pool (1 s), a
full queue, a drain or an infeasible deadline (the engine's hint); a
stream ends in an error frame instead, as in the JAX package. Shutdown
drains the engine (``drain_timeout_s``) before it stops.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.asgi import (
    App,
    Field,
    HTTPError,
    Request,
    Schema,
    StreamingResponse,
)
from mlapi_tpu_torch.serving.engine import OverloadedError
from mlapi_tpu_torch.serving.paged_pool import PagePoolExhausted
from mlapi_tpu_torch.serving.requests import DeadlineExceeded, DrainCancelled
from mlapi_tpu_torch.utils.logging import get_logger
from mlapi_tpu_torch.utils.metrics import MetricsRegistry

_log = get_logger("serving.app")

GENERATE_SCHEMA = Schema(
    "GenerateRequest",
    text=Field(str),
    max_new_tokens=Field(int, None, nullable=True),
    temperature=Field(float, 0.0),
    top_k=Field(int, 0),
    top_p=Field(float, 1.0),
    seed=Field(int, 0),
    stream=Field(bool, False),
    stop=Field("str|list[str]", None, nullable=True),
    # Shared-prefix KV caching: the prompt is prefix + text, and the
    # prefix's forward runs once for every request that names it.
    prefix=Field(str, None, nullable=True),
    # The request's end-to-end wall-clock budget.
    deadline_ms=Field(float, None, nullable=True),
)
# Fields of the JAX package's /generate that change the answer and that
# the port does not implement: refused rather than silently ignored.
_NOT_PORTED = ("adapter", "tenant")


def _value_error(loc: str, msg: str, value) -> HTTPError:
    return HTTPError(
        422, [{"type": "value_error", "loc": [loc], "msg": msg,
               "input": value}]
    )


def _terminal_http(e: Exception) -> HTTPError | None:
    """The HTTP shape of a terminal error frame on a unary request:
    deadline expiry 504, drain and pool exhaustion 503 with
    retry-after."""
    if isinstance(e, DeadlineExceeded):
        return HTTPError(504, str(e))
    if isinstance(e, DrainCancelled):
        return HTTPError(503, str(e), headers={"retry-after": "5"})
    if isinstance(e, PagePoolExhausted):
        return HTTPError(503, str(e), headers={"retry-after": "1"})
    return None


def build_app(engine, *, default_deadline_ms: float | None = None,
              drain_timeout_s: float = 10.0,
              admission_control: bool = True) -> App:
    """The app over one generative engine. Startup warms the engine and
    starts its collector; shutdown drains it (``drain_timeout_s``) and
    stops it. ``default_deadline_ms`` applies to requests that name no
    ``deadline_ms``; ``admission_control`` turns the infeasible-deadline
    shed and the brownout rungs on or off."""
    app = App(title="mlapi-tpu-torch")
    registry = MetricsRegistry()
    engine.default_deadline_ms = default_deadline_ms
    engine.drain_timeout_s = float(drain_timeout_s)
    engine.admission_control = bool(admission_control)
    _install_generate(app, engine)

    @app.on_startup
    async def _start():
        faults.arm_from_env()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, engine.warmup)
        await engine.start()
        _log.info("serving %s on %s", type(engine.model).__name__,
                  engine.device)

    @app.on_shutdown
    async def _stop():
        # Drain first: new requests shed 503 and /healthz reads
        # draining while in-flight streams finish; then the hard stop.
        await engine.drain(engine.drain_timeout_s)
        await engine.stop()

    _install_common(app, engine, registry)
    return app


def _install_generate(app: App, engine) -> None:
    hard_cap = engine.model.max_positions - 1

    def _norm_stops(stop) -> list[str]:
        stops = [stop] if isinstance(stop, str) else list(stop or [])
        if len(stops) > 4 or any(not 0 < len(s) <= 64 for s in stops):
            raise _value_error("stop", "up to 4 stop strings of 1-64 chars",
                               stop)
        return stops

    def _first_stop(text: str, stops: list[str]):
        """(cut_index, stop) of the earliest stop; same-index ties go to
        the longest stop."""
        hits = [(i, s) for s in stops if (i := text.find(s)) != -1]
        return min(hits, key=lambda h: (h[0], -len(h[1])), default=None)

    @app.post("/generate", body=GENERATE_SCHEMA)
    async def generate(req, request: Request):
        """Generate a continuation of ``text`` (unary or NDJSON)."""
        extra = request.json()
        for name in _NOT_PORTED:
            if extra.get(name) is not None:
                raise _value_error(
                    name, "not supported by this server", extra[name]
                )
        n_new = (
            req.max_new_tokens if req.max_new_tokens is not None
            else engine.default_max_new_tokens
        )
        if not 0 < n_new <= hard_cap:
            raise _value_error("max_new_tokens", f"must be in [1, {hard_cap}]",
                               n_new)
        if not 0.0 <= req.temperature <= 10.0:
            raise _value_error("temperature", "must be in [0, 10]",
                               req.temperature)
        if not 0 <= req.top_k <= engine.model.vocab_size:
            raise _value_error(
                "top_k",
                f"must be in [0, {engine.model.vocab_size}] (0 disables)",
                req.top_k,
            )
        if not 0.0 < req.top_p <= 1.0:
            raise _value_error("top_p", "must be in (0, 1] (1.0 disables)",
                               req.top_p)
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            # 0 would read as "no deadline"; a negative one would spend
            # a queue slot to expire at once.
            raise _value_error("deadline_ms", "must be > 0 (omit for no "
                               "deadline)", req.deadline_ms)
        stops = _norm_stops(req.stop)
        try:
            gen = await engine.submit(
                req.text, max_new_tokens=n_new,
                temperature=req.temperature, seed=req.seed,
                top_k=req.top_k, top_p=req.top_p, prefix=req.prefix,
                # Incremental consumers need tokens per chunk.
                stream=bool(req.stream) or bool(stops),
                deadline_ms=req.deadline_ms,
            )
        except OverloadedError as e:
            raise HTTPError(
                503, str(e),
                headers={"retry-after": str(int(max(1, e.retry_after_s)))},
            ) from None
        except ValueError as e:
            # An invalid prefix (too long for the window, empty after
            # tokenizing, no room left for the suffix) is the
            # requester's error.
            raise _value_error("prefix", str(e), req.prefix) from None

        if req.stream:
            async def ndjson():
                ids: list[int] = []
                finished = False
                try:
                    while True:
                        item = await gen.queue.get()
                        if isinstance(item, Exception):
                            # The terminal error frame.
                            finished = True
                            frame = {"error": str(item)}
                            code = getattr(item, "code", None)
                            if code:
                                frame["code"] = code
                            yield json.dumps(frame).encode() + b"\n"
                            return
                        if item is None:
                            finished = True
                            yield json.dumps({
                                "done": True,
                                "text": engine.tokenizer.decode(ids),
                                "token_ids": ids,
                                "prompt_tokens": gen.prompt_tokens,
                            }).encode() + b"\n"
                            return
                        ids.extend(item["token_ids"])
                        if stops:
                            text = engine.tokenizer.decode(ids)
                            hit = _first_stop(text, stops)
                            if hit is not None:
                                finished = True
                                gen.cancel()
                                cut, s = hit
                                yield json.dumps({
                                    "done": True,
                                    "text": text[:cut],
                                    "token_ids": ids,
                                    "prompt_tokens": gen.prompt_tokens,
                                    "stopped": s,
                                }).encode() + b"\n"
                                return
                        yield json.dumps(item).encode() + b"\n"
                finally:
                    # Closed early (client disconnect): stop decoding.
                    if not finished:
                        gen.cancel()

            return StreamingResponse(
                ndjson(), content_type="application/x-ndjson"
            )

        ids: list[int] = []
        stopped = None
        text = None
        try:
            while True:
                item = await gen.queue.get()
                if isinstance(item, Exception):
                    http = _terminal_http(item)
                    if http is not None:
                        raise http from None
                    raise item
                if item is None:
                    break
                ids.extend(item["token_ids"])
                if stops:
                    text = engine.tokenizer.decode(ids)
                    hit = _first_stop(text, stops)
                    if hit is not None:
                        gen.cancel()
                        stopped = hit
                        break
        except asyncio.CancelledError:
            gen.cancel()
            raise
        if text is None:
            text = engine.tokenizer.decode(ids)
        out = {
            "text": text if stopped is None else text[: stopped[0]],
            "token_ids": ids,
            "prompt_tokens": gen.prompt_tokens,
        }
        if stopped is not None:
            out["stopped"] = stopped[1]
        return out


def _install_common(app: App, engine, registry: MetricsRegistry) -> None:
    _counters: dict = {}
    _histograms: dict = {}

    def _record(key, status: int, ms: float) -> None:
        ckey = (key, status)
        counter = _counters.get(ckey)
        if counter is None:
            route = f"{key[0]} {key[1]}" if key else "unmatched"
            counter = _counters[ckey] = registry.counter(
                f"http.requests{{route={route},status={status}}}"
            )
            _histograms.setdefault(
                key, registry.histogram(f"http.latency_ms{{route={route}}}")
            )
        counter.inc()
        _histograms[key].observe(ms)

    def _key(request: Request):
        key = (request.method, request.path)
        return key if key in app._routes else None

    @app.middleware
    async def _metrics_mw(request: Request, nxt):
        t0 = time.perf_counter()
        status = 500
        recorded = False
        try:
            response = await nxt(request)
            status = response.status
            if isinstance(response, StreamingResponse):
                # Record when the stream ends, not when it starts.
                response.body_iter = _record_when_done(
                    response.body_iter, request, status, t0
                )
                recorded = True
            return response
        except HTTPError as e:
            status = e.status
            raise
        finally:
            if not recorded:
                _record(_key(request), status,
                        (time.perf_counter() - t0) * 1e3)

    async def _record_when_done(it, request: Request, status: int, t0):
        try:
            async for chunk in it:
                yield chunk
        finally:
            aclose = getattr(it, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass
            _record(_key(request), status, (time.perf_counter() - t0) * 1e3)

    @app.get("/healthz")
    async def healthz():
        dev = engine.device
        return {
            # "draining" from the moment shutdown begins, so a load
            # balancer stops routing here while streams finish.
            "status": "draining" if engine.draining else "ok",
            "queue_depth": engine.queue_depth,
            "model": type(engine.model).__name__,
            "classes": [],
            "checkpoint": engine.meta,
            "backend": dev.type,
            "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"
            ),
            "device_count": (
                torch.cuda.device_count() if dev.type == "cuda" else 1
            ),
            "kv_quant": engine.kv_quant,
            "decode_attn_impl": engine.decode_attn_impl,
            "kv_page_size": engine.kv_page_size,
            "kv_pages": engine.kv_pages_total,
            "pid": os.getpid(),
        }

    @app.get("/metrics")
    async def metrics():
        from mlapi_tpu_torch.ops import cuda as kern

        snap = registry.snapshot()
        c = snap["counters"]
        c["generate.requests"] = engine.requests
        c["generate.batch_calls"] = engine.batch_calls
        c["generate.chunk_calls"] = engine.chunk_calls
        c["generate.rejected"] = engine.rejected
        c["generate.cancelled_batches"] = engine.cancelled_batches
        c["generate.prefill_chunks"] = engine.prefill_chunks
        c["generate.admitted"] = engine.admitted
        c["generate.growths"] = engine.growths
        c["generate.compactions"] = engine.compactions
        c["generate.prefix_hits"] = engine.prefix_hits
        c["generate.prefix_misses"] = engine.prefix_misses
        c["generate.prefix_fallbacks"] = engine.prefix_fallbacks
        c["generate.prefix_builds"] = engine.prefix_builds
        c["generate.prefix_adopt_bytes"] = engine.prefix_adopt_bytes
        c["generate.kv_prefix_copy_fallback"] = (
            engine.kv_prefix_copy_fallback
        )
        c["generate.faults_injected"] = faults.injected_count()
        c["generate.interleaved_prefills"] = engine.interleaved_prefills
        # Why requests failed: shed at the door, expired at a boundary,
        # clamped by brownout rung 1.
        for name in ("shed_queue_full", "shed_deadline_infeasible",
                     "shed_draining", "deadline_expired_queued",
                     "deadline_expired_prefill", "deadline_expired_decode",
                     "brownout_tokens_clamped",
                     # The unit scheduler's dispatches by kind,
                     # deadline preemptions and page-budget deferrals.
                     "sched_units_prefill", "sched_units_decode",
                     "sched_units_admit", "sched_units_compact",
                     "sched_deadline_preempts", "sched_pages_deferred"):
            c[f"generate.{name}"] = getattr(engine, name)
        g = snap.setdefault("gauges", {})
        g["generate.queue_depth"] = engine.queue_depth
        g["generate.sched_queue_depth"] = engine.sched_queue_depth
        g["generate.sched_batches_live"] = engine.sched_batches_live
        g["generate.sched_batches_live_max"] = engine.sched_batches_live_max
        g["generate.sched_lane_stall_max"] = engine.sched_lane_stall_max
        g["generate.router_queue_depth"] = engine.router_queue_depth
        g["generate.draining"] = int(engine.draining)
        g["generate.prefill_chunk_queue_depth"] = (
            engine.prefill_chunk_queue_depth
        )
        g["generate.interleave_max_stall"] = engine.interleave_max_stall
        for k, v in engine.latency.summary().items():
            g[f"generate.{k}"] = v
        g["generate.kv_cache_bytes_per_slot"] = engine.kv_cache_slot_bytes()
        g["generate.decode_bytes_per_step"] = engine.decode_bytes_per_step()
        g["generate.extend_bytes_per_chunk"] = (
            engine.extend_bytes_per_chunk()
        )
        g["generate.kv_pages_total"] = engine.kv_pages_total
        g["generate.kv_pages_in_use"] = engine.kv_pages_in_use
        g["generate.kv_pages_shared"] = engine.kv_pages_shared
        g["generate.kv_page_utilization"] = engine.kv_page_utilization
        g["generate.kv_page_bytes"] = engine.kv_page_bytes()
        snap["kernels"] = {
            name: getattr(kern, name).launches
            for name in ("decode_attention", "extend_attention",
                         "paged_decode_attention", "paged_extend_attention")
        }
        return snap
