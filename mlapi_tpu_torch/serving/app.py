"""The serving application: ``/predict``, ``/files/``, ``/generate``,
``/healthz``, ``/metrics``, ``/openapi.json``.

Counterpart of ``mlapi_tpu/serving/app.py``. :func:`build_app` serves
one engine or a :class:`~mlapi_tpu_torch.serving.registry.ModelRegistry`
of them; the registry's default entry owns the single-model routes, and
a process with several models adds ``/models/<id>/predict`` and
``/models/<id>/generate``.

- ``POST /predict`` (classifiers): a JSON body of the checkpoint's
  feature names (Iris: four floats, numeric strings coerced), or
  ``{"features": [...]}`` when it names none, or ``{"text": ...}`` for a
  text classifier, each with an optional ``deadline_ms``; the answer is
  ``{"prediction": "<label>", "probability": <max prob>}``. A wrong
  width is a 422 with a FastAPI-shaped detail list; overload and drain
  a 503 with ``retry-after``; a deadline passed in the queue a 504.
  Requests coalesce into batches on a ``ScorePath``
  (``serving/scoring.py``), whose batches run as ``score`` units on the
  primary generative engine's scheduler when one is co-resident.
- ``POST /files/``: a multipart CSV (``file``) and a ``token`` field;
  the answer echoes ``columns``, ``rows``, the first 1000 ``records``
  and ``truncated``, as the JAX app's pandas reading gives them
  (``serving/csvread.py``). Non-UTF-8 or unparseable input is a 400, a
  missing ``token`` or ``file`` a 422.
- ``POST /generate`` (generative): ``text``, ``max_new_tokens``,
  ``temperature``, ``top_k``, ``top_p``, ``seed``, ``stream``, ``stop``,
  ``prefix`` and ``deadline_ms``. Concurrent requests coalesce into one
  batch. ``"stream": true`` answers NDJSON: one ``{"token_ids": [...]}``
  line per decoded chunk, then a ``{"done": true, "text", "token_ids",
  "prompt_tokens"}`` line whose ``token_ids`` is the FULL list; an error
  ends a stream with ``{"error", "code"}``. ``prefix`` makes the prompt
  ``prefix + text`` with the prefix's KV computed once and cached
  (``serving/prefix.py``); an invalid one is a 422 at ``["prefix"]``.
  ``deadline_ms`` (> 0) is the request's wall-clock budget: a deadline
  that passes ends the request with ``deadline_exceeded`` (504 unary),
  one the admission estimate says cannot be met is shed with a 503.
  ``adapter`` decodes under that tenant's LoRA adapter
  (``serving/adapter_store.py``): an id the engine cannot serve is a
  404, adapter slots all held by live batches a 503 with retry-after.
  ``tenant`` names the quota and fairness identity (by default the
  adapter id).
- ``GET /healthz``: liveness (``"draining"`` once shutdown began), queue
  depth, model, classes, checkpoint, device, the KV page size and pool
  size of a generative default, and a ``models`` block when several
  models are served.
- ``GET /metrics``: the request counters and latency histograms, the
  JAX package's ``batcher.*`` names for a scoring default and
  ``generate.*`` names for a generative one (``sched_units_score``
  among them), the ``model.<id>.*`` family when several models are
  served, the adapter block (``generate.adapter_*``) of an engine with
  adapter slots, the ``tenant.<t>.*`` block when tenant quotas are
  set, and the CUDA kernels' launch counts under ``kernels``.

Every 503 carries ``retry-after``. Startup warms every engine and starts
the generative engines before the scoring paths; shutdown drains and
stops the scoring paths before the generative engines whose scheduler
their batches may ride (``drain_timeout_s``).
"""

from __future__ import annotations

import asyncio
import json
import os
import time

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults
from mlapi_tpu_torch.serving.adapter_store import (
    AdapterSlotsExhausted,
    AdapterUnavailable,
)
from mlapi_tpu_torch.serving.asgi import (
    App,
    Field,
    HTTPError,
    Request,
    Response,
    Schema,
    StreamingResponse,
)
from mlapi_tpu_torch.serving.csvread import read_csv
from mlapi_tpu_torch.serving.engine import OverloadedError
from mlapi_tpu_torch.serving.paged_pool import PagePoolExhausted
from mlapi_tpu_torch.serving.registry import ModelRegistry
from mlapi_tpu_torch.serving.requests import DeadlineExceeded, DrainCancelled
from mlapi_tpu_torch.serving.scoring import ScorePath
from mlapi_tpu_torch.utils.logging import get_logger
from mlapi_tpu_torch.utils.metrics import MetricsRegistry

_log = get_logger("serving.app")

MAX_ECHO_RECORDS = 1000

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
    # A tenant's LoRA adapter id: decode under base + its delta,
    # batched with other tenants over the one resident base.
    adapter=Field(str, None, nullable=True),
    # The quota and fairness identity (by default the adapter id).
    tenant=Field(str, None, nullable=True),
)


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
    if isinstance(e, AdapterUnavailable):
        # The named adapter is absent here: the resource, not the
        # server.
        return HTTPError(404, str(e))
    if isinstance(e, AdapterSlotsExhausted):
        # Momentary: every slot is held by a live batch.
        return HTTPError(503, str(e), headers={"retry-after": "1"})
    return None


def _overloaded_http(e: OverloadedError) -> HTTPError:
    return HTTPError(
        503, str(e),
        headers={"retry-after": str(int(max(1, e.retry_after_s)))},
    )


def build_app(engine=None, *, models: ModelRegistry | None = None,
              max_batch: int | None = None, max_wait_ms: float = 0.2,
              default_deadline_ms: float | None = None,
              drain_timeout_s: float = 10.0,
              admission_control: bool = True, tenants=None) -> App:
    """The app over one engine or a registry (``models``). The default
    generative engine takes ``default_deadline_ms``,
    ``admission_control`` and ``drain_timeout_s`` (its batch size is a
    constructor argument); other generative entries keep their own.
    Each classifier gets a :class:`ScorePath` (``max_batch``,
    ``max_wait_ms``, ``default_deadline_ms``) whose batches ride the
    primary generative engine's scheduler when there is one.
    ``tenants`` (a ``TenantLedger``) gives every generative engine its
    per-tenant quotas, weights and brownout rung."""
    if models is None:
        if engine is None:
            raise ValueError("build_app needs an engine or a registry")
        models = ModelRegistry({"default": engine})
    engine = models.default
    app = App(title="mlapi-tpu-torch")
    registry = MetricsRegistry()
    multi = len(models.ids()) > 1
    primary_gen = models.primary_generative()
    score_paths: dict[str, ScorePath] = {}
    for mid, eng in models.items():
        is_default = mid == models.default_id
        if eng.kind == "generative":
            if tenants is not None:
                eng.tenants = tenants
            if is_default:
                eng.default_deadline_ms = default_deadline_ms
                eng.drain_timeout_s = float(drain_timeout_s)
                eng.admission_control = bool(admission_control)
                _install_generate(app, eng)
            if multi:
                _install_generate(app, eng, path=f"/models/{mid}/generate")
            continue
        sp = ScorePath(
            eng, model_id=mid, max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            default_deadline_ms=default_deadline_ms,
            sched_source=((lambda g=primary_gen: g.sched)
                          if primary_gen is not None else None),
        )
        score_paths[mid] = sp
        if is_default:
            _install_predict(app, eng, sp)
        if multi:
            _install_predict(app, eng, sp, path=f"/models/{mid}/predict")
    batcher = score_paths.get(models.default_id)
    app.state.update(models=models, score_paths=score_paths,
                     batcher=batcher, tenants=tenants)

    @app.on_startup
    async def _start():
        faults.arm_from_env()
        loop = asyncio.get_running_loop()
        # Generative engines start before the scoring paths, so a batch
        # formed at once finds the scheduler live.
        for mid, eng in models.items():
            await loop.run_in_executor(None, eng.warmup)
            if eng.kind == "generative":
                await eng.start()
            models.note_started(mid)
        for sp in score_paths.values():
            await sp.start()
        _log.info("serving %s on %s", ", ".join(
            f"{mid}:{type(e.model).__name__}" for mid, e in models.items()
        ), engine.device)

    @app.on_shutdown
    async def _stop():
        # Drain first: new requests shed 503 and /healthz reads
        # draining while in-flight work finishes; then the hard stop.
        # Scoring paths go before the engines their units may ride.
        for sp in score_paths.values():
            await sp.drain(drain_timeout_s)
            await sp.stop()
        for mid, eng in models.items():
            if eng.kind == "generative":
                await eng.drain(eng.drain_timeout_s)
                await eng.stop()
            models.note_stopped(mid)

    _install_files(app)
    _install_common(app, models, registry, score_paths)
    app.install_docs()
    return app


def _install_predict(app: App, engine, batcher: ScorePath,
                     path: str = "/predict") -> None:
    """``POST /predict`` over one classifier's scoring path (and, with
    several models, the same handler at ``/models/<id>/predict``)."""
    deadline = Field(float, None, nullable=True)
    if engine.kind == "text":
        schema = Schema("TextRequest", text=Field(str), deadline_ms=deadline)
    elif engine.feature_names:
        schema = Schema("Features")
        schema.fields = {name: Field(float) for name in engine.feature_names}
        schema.fields["deadline_ms"] = deadline
    else:
        schema = Schema("Features", features=Field("list[float]"),
                        deadline_ms=deadline)
    order = engine.feature_names
    expected_dim = engine.num_features
    # Each label's JSON bytes, escaped once.
    label_json = {
        label: json.dumps(label).encode() for label in engine.vocab.labels
    }

    @app.post(path, body=schema)
    async def predict(req):
        """Classify one row: ``{"prediction", "probability"}``."""
        if engine.kind == "text":
            row = engine.encode(req.text)
        elif order:
            row = np.asarray([getattr(req, f) for f in order], np.float32)
        else:
            row = np.asarray(req.features, np.float32)
        if row.shape != (expected_dim,):
            raise HTTPError(422, [{
                "type": "value_error", "loc": ["features"],
                "msg": f"expected {expected_dim} features, "
                       f"got {row.shape[0]}",
                "input": int(row.shape[0]),
            }])
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            raise _value_error("deadline_ms", "must be > 0 (omit for no "
                               "deadline)", req.deadline_ms)
        try:
            label, prob = await batcher.submit(
                row, deadline_ms=req.deadline_ms)
        except OverloadedError as e:
            raise _overloaded_http(e) from None
        except DeadlineExceeded as e:
            raise HTTPError(504, str(e)) from None
        body = b'{"prediction":%b,"probability":%.10g}' % (
            label_json.get(label) or json.dumps(label).encode(), prob,
        )
        return Response(body, content_type="application/json")


def _install_files(app: App) -> None:
    @app.post("/files/")
    async def create_file(request: Request):
        """Ingest a CSV upload (multipart) with a token form field;
        echoes columns, rows and records as JSON."""
        fields, files = request.form()
        if "token" not in fields:
            raise HTTPError(422, "missing form field 'token'")
        if "file" not in files:
            raise HTTPError(422, "missing file field 'file'")
        try:
            text = files["file"].data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise HTTPError(400, f"file is not utf-8 text: {e}") from None
        try:
            columns, n, records = await asyncio.get_running_loop(
            ).run_in_executor(None, read_csv, text, MAX_ECHO_RECORDS)
        except Exception as e:  # noqa: BLE001 — any parse failure is a 400
            raise HTTPError(400, f"could not parse CSV: {e}") from None
        return {
            "file": {"columns": columns, "rows": n, "records": records,
                     "truncated": n > MAX_ECHO_RECORDS},
            "token": fields["token"],
        }

    # A multipart body has no Schema: its form contract, spelled out.
    create_file.__openapi__ = {"requestBody": {
        "required": True,
        "content": {"multipart/form-data": {"schema": {
            "type": "object", "required": ["file", "token"],
            "properties": {
                "file": {"type": "string", "format": "binary"},
                "token": {"type": "string"},
            },
        }}},
    }}


def _install_generate(app: App, engine, path: str = "/generate") -> None:
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

    @app.post(path, body=GENERATE_SCHEMA)
    async def generate(req):
        """Generate a continuation of ``text`` (unary or NDJSON)."""
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
                deadline_ms=req.deadline_ms, adapter=req.adapter,
                tenant=req.tenant,
            )
        except OverloadedError as e:
            raise _overloaded_http(e) from None
        except AdapterUnavailable as e:
            # Resolved before the request queues: 404.
            raise HTTPError(404, str(e)) from None
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


def _install_common(app: App, models: ModelRegistry,
                    registry: MetricsRegistry, score_paths: dict) -> None:
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
        engine = models.default
        batcher = score_paths.get(models.default_id)
        dev = engine.device
        gen = engine.kind == "generative"
        draining = (batcher.draining if batcher is not None
                    else engine.draining)
        vocab = getattr(engine, "vocab", None)
        body = {
            # "draining" from the moment shutdown begins, so a load
            # balancer stops routing here while work finishes.
            "status": "draining" if draining else "ok",
            **({"models": models.describe()} if len(models.ids()) > 1
               else {}),
            "queue_depth": (batcher.queue_depth if batcher is not None
                            else engine.queue_depth),
            "model": type(engine.model).__name__,
            "classes": list(vocab.labels) if vocab is not None else [],
            "checkpoint": engine.meta,
            "backend": dev.type,
            "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"
            ),
            "device_count": (
                torch.cuda.device_count() if dev.type == "cuda" else 1
            ),
        }
        if gen:
            body.update(
                kv_quant=engine.kv_quant,
                decode_attn_impl=engine.decode_attn_impl,
                kv_page_size=engine.kv_page_size,
                kv_pages=engine.kv_pages_total,
            )
        body["pid"] = os.getpid()
        return body

    @app.get("/metrics")
    async def metrics():
        from mlapi_tpu_torch.ops import cuda as kern

        snap = registry.snapshot()
        c = snap["counters"]
        g = snap.setdefault("gauges", {})
        engine = models.default
        batcher = score_paths.get(models.default_id)
        if batcher is not None:
            for name in ("device_calls", "requests", "timeouts", "rejected",
                         "shed_draining", "deadline_expired",
                         "sched_dispatches"):
                c[f"batcher.{name}"] = getattr(batcher, name)
            # The overload early warnings: queue depth and in-flight
            # batches move first when offered load passes capacity.
            g["batcher.queue_depth"] = batcher.queue_depth
            g["batcher.inflight"] = batcher.inflight
            g["batcher.draining"] = int(batcher.draining)
            g["batcher.router_queue_depth"] = batcher.router_queue_depth
            for k, v in batcher.latency.summary().items():
                g[f"batcher.{k}"] = v
        else:
            _generate_metrics(engine, c, g)
        if len(models.ids()) > 1:
            for mid, eng in models.items():
                pfx = f"model.{mid}"
                if eng.kind == "generative":
                    c[f"{pfx}.requests"] = eng.requests
                    c[f"{pfx}.rejected"] = eng.rejected
                    c[f"{pfx}.sched_units_decode"] = eng.sched_units_decode
                    c[f"{pfx}.sched_units_score"] = eng.sched_units_score
                    g[f"{pfx}.queue_depth"] = eng.queue_depth
                    stats = eng.latency
                else:
                    sp = score_paths[mid]
                    c[f"{pfx}.requests"] = sp.requests
                    c[f"{pfx}.device_calls"] = sp.device_calls
                    # Batches that rode the generative scheduler as score
                    # units: equal to device_calls when all did.
                    c[f"{pfx}.sched_dispatches"] = sp.sched_dispatches
                    c[f"{pfx}.rejected"] = sp.rejected
                    c[f"{pfx}.deadline_expired"] = sp.deadline_expired
                    g[f"{pfx}.queue_depth"] = sp.queue_depth
                    stats = sp.latency
                for k, v in stats.summary().items():
                    g[f"{pfx}.{k}"] = v
        names = ["decode_attention", "extend_attention",
                 "paged_decode_attention", "paged_extend_attention"]
        if any(e.kind == "text" for _, e in models.items()):
            names.append("flash_forward")   # a BERT classifier's B5
        snap["kernels"] = {name: getattr(kern, name).launches
                           for name in names}
        # Per-tenant pressure: live depth, quota deferrals and brownout
        # clamps of every tenant with any history.
        tenants = app.state.get("tenants")
        if tenants is not None:
            for t, row in sorted(tenants.snapshot().items()):
                pfx = f"tenant.{t or 'anonymous'}"
                g[f"{pfx}.depth"] = row["depth"]
                c[f"{pfx}.deferrals"] = row["deferrals"]
                c[f"{pfx}.brownouts"] = row["brownouts"]
        return snap


def _generate_metrics(engine, c: dict, g: dict) -> None:
    """The ``generate.*`` counters and gauges of a generative engine."""
    for name in ("requests", "batch_calls", "chunk_calls", "rejected",
                 "cancelled_batches", "prefill_chunks", "admitted",
                 "growths", "compactions", "prefix_hits", "prefix_misses",
                 "prefix_fallbacks", "prefix_builds", "prefix_adopt_bytes",
                 "kv_prefix_copy_fallback", "interleaved_prefills",
                 # Why requests failed: shed at the door, expired at a
                 # boundary, clamped by brownout rung 1.
                 "shed_queue_full", "shed_deadline_infeasible",
                 "shed_draining", "deadline_expired_queued",
                 "deadline_expired_prefill", "deadline_expired_decode",
                 "brownout_tokens_clamped",
                 # The unit scheduler's dispatches by kind (score units:
                 # co-resident classifiers' batches), deadline
                 # preemptions and page-budget deferrals.
                 "sched_units_prefill", "sched_units_decode",
                 "sched_units_admit", "sched_units_compact",
                 "sched_units_score", "sched_deadline_preempts",
                 "sched_pages_deferred",
                 # Group starts deferred on a TENANT's page or slot
                 # quota, and the tenant brownout rung's clamps.
                 "sched_tenant_pages_deferred",
                 "sched_tenant_adapters_deferred",
                 "brownout_tenant_clamped",
                 # Speculation: rounds, proposals tested and accepted,
                 # paged handoffs by route, brownout suppressions, spec
                 # units.
                 "spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_realign_table_ops", "spec_realign_repacks",
                 "brownout_spec_suppressed", "sched_units_spec",
                 # Batch runs that dispatched a fused-width chunk.
                 "fused_calls"):
        c[f"generate.{name}"] = getattr(engine, name)
    c["generate.faults_injected"] = faults.injected_count()
    for name in ("queue_depth", "sched_queue_depth", "sched_batches_live",
                 "sched_batches_live_max", "sched_lane_stall_max",
                 "router_queue_depth", "prefill_chunk_queue_depth",
                 "interleave_max_stall", "kv_pages_total", "kv_pages_in_use",
                 "kv_pages_shared", "kv_page_utilization"):
        g[f"generate.{name}"] = getattr(engine, name)
    g["generate.draining"] = int(engine.draining)
    for k, v in engine.latency.summary().items():
        g[f"generate.{k}"] = v
    g["generate.kv_cache_bytes_per_slot"] = engine.kv_cache_slot_bytes()
    g["generate.decode_bytes_per_step"] = engine.decode_bytes_per_step()
    g["generate.extend_bytes_per_chunk"] = engine.extend_bytes_per_chunk()
    g["generate.kv_page_bytes"] = engine.kv_page_bytes()
    if engine.pool is not None:
        # Prefix page sets evicted under pool pressure or by brownout
        # (spilled first when a tier is attached).
        c["generate.kv_entry_evictions"] = engine.pool.entry_evictions
    if engine.kv_tier is not None:
        # The host KV tier: spill and restore traffic (bytes by dtype
        # and shape arithmetic) and its occupancy. restore_hits moving
        # while prefix_builds stays flat is the saved prefill.
        for name in ("kv_prefix_restore_hits", "kv_prefix_restore_misses",
                     "kv_prefix_restore_bytes", "kv_prefix_restore_failures",
                     "kv_prefix_spill_count", "kv_prefix_spill_bytes",
                     "kv_prefix_spill_failures", "kv_tier_evictions"):
            c[f"generate.{name}"] = getattr(engine, name)
        for name in ("kv_tier_bytes_in_use", "kv_tier_entries"):
            g[f"generate.{name}"] = getattr(engine, name)
    if engine.adapters is not None:
        # Many-adapter LoRA: the slot pool, the host store and the
        # application modes. Byte gauges are dtype/shape arithmetic:
        # adapter_resident_bytes grows by exactly adapter_slot_bytes per
        # resident tenant over the base. The fetch/serve counters are
        # the fleet tier's (not ported, ROADMAP Queue A item 7): 0.
        for name in ("adapter_fetch_hits", "adapter_fetch_misses",
                     "adapter_fetch_bytes", "adapter_fetch_failures",
                     "adapter_serve_count", "adapter_serve_bytes",
                     "adapter_installs", "adapter_evictions",
                     "adapter_grouped_batches", "adapter_gathered_batches",
                     "adapter_store_evictions", "sched_adapters_deferred"):
            c[f"generate.{name}"] = getattr(engine, name)
        for name in ("adapter_slots_total", "adapter_slots_in_use",
                     "adapter_slot_bytes", "adapter_resident_bytes",
                     "adapter_store_bytes_in_use", "adapter_store_entries"):
            g[f"generate.{name}"] = getattr(engine, name)
