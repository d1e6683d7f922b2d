"""A minimal ASGI web framework: routing, body validation, JSON.

Counterpart of ``mlapi_tpu/serving/asgi.py``. The JAX package validates
request bodies with pydantic models; pydantic is not installed where
the port serves, so a route declares its body as a :class:`Schema` of
:class:`Field` s instead, and a violation returns the same
FastAPI-shaped 422 ``{"detail": [{"type", "loc", "msg", "input"}]}``
(malformed JSON stays a 400). Field coercion follows pydantic's lax
mode for the types the routes use: integral floats and numeric strings
become ints, ints, bools and numeric strings become floats, ``0``/``1``
and ``"true"``/``"false"`` become bools, and a ``list[float]`` field
takes a JSON array whose items coerce as floats (an item's error is
located at ``[field, index]``).

- ``@app.post(path, body=schema)`` / ``@app.get(path)`` route
  decorators; the handler receives the validated body as an object
  with one attribute per field, plus ``request`` if it names one.
- Returned dicts become JSON responses; ``Response`` for anything else.
- Middleware hooks (used by the metrics subsystem).
- ``install_docs()`` serves ``GET /openapi.json``: the routes and their
  schemas, plus what a handler's ``__openapi__`` adds (the multipart
  form of ``/files/``).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import traceback
import types
from typing import Any, Awaitable, Callable

from mlapi_tpu_torch.serving.multipart import (
    MultipartError,
    Part,
    boundary_from_content_type,
    parse_multipart,
)
from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.asgi")

REQUIRED = object()


class HTTPError(Exception):
    """Raise from a handler to produce a clean JSON error response;
    ``headers`` ride along (e.g. ``Retry-After`` on a 503)."""

    def __init__(
        self, status: int, detail: Any, headers: dict[str, str] | None = None
    ):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = headers


def _err(kind: str, name: str, msg: str, value) -> dict:
    return {"type": kind, "loc": [name], "msg": msg, "input": value}


def _as_int(name, v):
    if isinstance(v, bool):
        raise _Invalid(_err("int_type", name, "Input should be a valid "
                            "integer", v))
    if isinstance(v, int):
        return v
    if isinstance(v, float) and v.is_integer():
        return int(v)
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            pass
        raise _Invalid(_err("int_parsing", name, "Input should be a valid "
                            "integer, unable to parse string as an "
                            "integer", v))
    raise _Invalid(_err("int_type", name, "Input should be a valid integer",
                        v))


def _as_float(name, v):
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            raise _Invalid(_err("float_parsing", name, "Input should be a "
                                "valid number, unable to parse string as "
                                "a number", v)) from None
    raise _Invalid(_err("float_type", name, "Input should be a valid "
                        "number", v))


_TRUE = {"true", "1", "yes", "on", "t", "y"}
_FALSE = {"false", "0", "no", "off", "f", "n"}


def _as_bool(name, v):
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
        return v.strip().lower() in _TRUE
    raise _Invalid(_err("bool_type", name, "Input should be a valid "
                        "boolean", v))


def _as_str(name, v):
    if isinstance(v, str):
        return v
    raise _Invalid(_err("string_type", name, "Input should be a valid "
                        "string", v))


def _as_str_or_list(name, v):
    if isinstance(v, str):
        return v
    if isinstance(v, list) and all(isinstance(x, str) for x in v):
        return v
    raise _Invalid(_err("string_type", name, "Input should be a valid "
                        "string or a list of strings", v))


def _as_float_list(name, v):
    if not isinstance(v, list):
        raise _Invalid(_err("list_type", name, "Input should be a valid "
                            "array", v))
    out, errors = [], []
    for i, x in enumerate(v):
        try:
            out.append(_as_float(name, x))
        except _Invalid as e:
            e.error["loc"] = [name, i]
            errors.append(e.error)
    if errors:
        raise _Invalid(*errors)
    return out


_COERCE = {
    int: _as_int, float: _as_float, bool: _as_bool, str: _as_str,
    "str|list[str]": _as_str_or_list, "list[float]": _as_float_list,
}
# JSON-schema types of the field kinds (``App.openapi``).
_JSON_TYPES = {
    int: {"type": "integer"}, float: {"type": "number"},
    bool: {"type": "boolean"}, str: {"type": "string"},
    "str|list[str]": {"anyOf": [{"type": "string"}, {
        "type": "array", "items": {"type": "string"}}]},
    "list[float]": {"type": "array", "items": {"type": "number"}},
}


class _Invalid(Exception):
    def __init__(self, error: dict, *more: dict):
        super().__init__(error["msg"])
        self.error = error
        self.errors = [error, *more]


class Field:
    """One body field: its type (``int``, ``float``, ``bool``, ``str``
    or ``"str|list[str]"``), its default (or :data:`REQUIRED`), and
    whether ``null`` is accepted."""

    __slots__ = ("kind", "default", "nullable")

    def __init__(self, kind, default=REQUIRED, *, nullable: bool = False):
        if kind not in _COERCE:
            raise ValueError(f"unsupported field type {kind!r}")
        self.kind = kind
        self.default = default
        self.nullable = nullable


class Schema:
    """A JSON-object body: named :class:`Field` s. Unknown keys are
    ignored, as pydantic does by default."""

    def __init__(self, name: str, **fields: Field):
        self.name = name
        self.fields = fields

    def validate(self, body: bytes):
        """Parse and validate → an object with one attribute per field.
        Raises :class:`HTTPError` 400 on malformed JSON, 422 (FastAPI
        shape, every violation listed) otherwise."""
        try:
            obj = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise HTTPError(400, "invalid JSON body") from None
        if not isinstance(obj, dict):
            raise HTTPError(422, [{
                "type": "model_type", "loc": [],
                "msg": "Input should be an object", "input": obj,
            }])
        out, errors = {}, []
        for name, f in self.fields.items():
            if name not in obj:
                if f.default is REQUIRED:
                    errors.append(_err("missing", name, "Field required",
                                       obj))
                else:
                    out[name] = f.default
                continue
            v = obj[name]
            if v is None and f.nullable:
                out[name] = None
                continue
            try:
                out[name] = _COERCE[f.kind](name, v)
            except _Invalid as e:
                errors.extend(e.errors)
        if errors:
            raise HTTPError(422, errors)
        return types.SimpleNamespace(**out)

    def json_schema(self) -> dict:
        props, required = {}, []
        for name, f in self.fields.items():
            t = dict(_JSON_TYPES[f.kind])
            if f.nullable:
                t = {"anyOf": [t, {"type": "null"}]}
            props[name] = {"title": name, **t}
            if f.default is REQUIRED:
                required.append(name)
            elif f.default is not None:
                props[name]["default"] = f.default
        return {"title": self.name, "type": "object", "properties": props,
                "required": required}


class _Route:
    __slots__ = ("handler", "body", "wants_request")

    def __init__(self, handler, body, wants_request):
        self.handler = handler
        self.body = body
        self.wants_request = wants_request


class Request:
    """One HTTP request: ASGI scope + fully-read body."""

    __slots__ = ("scope", "body", "method", "path", "_headers")

    def __init__(self, scope: dict, body: bytes):
        self.scope = scope
        self.body = body
        self.method: str = scope["method"]
        self.path: str = scope["path"]
        self._headers: dict[str, str] | None = None

    @property
    def headers(self) -> dict[str, str]:
        if self._headers is None:
            self._headers = {
                k.decode("latin-1").lower(): v.decode("latin-1")
                for k, v in self.scope.get("headers", [])
            }
        return self._headers

    def json(self) -> Any:
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from None

    def multipart(self) -> list[Part]:
        ctype = self.headers.get("content-type", "")
        try:
            return parse_multipart(self.body, boundary_from_content_type(ctype))
        except MultipartError as e:
            raise HTTPError(400, str(e)) from None

    def form(self) -> tuple[dict[str, str], dict[str, Part]]:
        """(plain fields, file parts) of a multipart body."""
        fields: dict[str, str] = {}
        files: dict[str, Part] = {}
        for part in self.multipart():
            if part.filename is None:
                fields[part.name] = part.text()
            else:
                files[part.name] = part
        return fields, files


class Response:
    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        content_type: str = "application/octet-stream",
        headers: dict[str, str] | None = None,
    ):
        self.body = body
        self.status = status
        self.headers = {"content-type": content_type, **(headers or {})}


class StreamingResponse(Response):
    """Response whose body is an async iterator of byte chunks, written
    as they are produced (chunked transfer encoding under the
    framework's server, ``more_body`` messages under any ASGI
    server)."""

    def __init__(
        self,
        body_iter,
        status: int = 200,
        content_type: str = "application/octet-stream",
        headers: dict[str, str] | None = None,
    ):
        super().__init__(b"", status, content_type, headers)
        self.body_iter = body_iter


def json_response(
    obj: Any, status: int = 200, headers: dict[str, str] | None = None
) -> Response:
    return Response(
        json.dumps(obj, separators=(",", ":"), default=_json_default).encode(),
        status=status,
        content_type="application/json",
        headers=headers,
    )


def _json_default(o: Any):
    # numpy / torch scalars arrive from model code; coerce, don't 500.
    for attr in ("item", "tolist"):
        fn = getattr(o, attr, None)
        if fn is not None:
            return fn()
    raise TypeError(f"not JSON serializable: {type(o)}")


Handler = Callable[..., Awaitable[Any]]


class App:
    """ASGI 3 application with method+path routing."""

    def __init__(self, title: str = "mlapi-tpu-torch"):
        self.title = title
        # What build_app shares with its callers (the registry, the paths).
        self.state: dict[str, Any] = {}
        self._routes: dict[tuple[str, str], _Route] = {}
        self._middleware: list = []
        self._startup_hooks: list[Callable[[], Awaitable[None]]] = []
        self._shutdown_hooks: list[Callable[[], Awaitable[None]]] = []

    # -- registration -----------------------------------------------------
    def route(self, method: str, path: str, body: Schema | None = None):
        def deco(fn: Handler) -> Handler:
            self._routes[(method.upper(), path)] = _Route(
                fn, body, "request" in inspect.signature(fn).parameters
            )
            return fn

        return deco

    def post(self, path: str, body: Schema | None = None):
        return self.route("POST", path, body)

    def get(self, path: str):
        return self.route("GET", path)

    def middleware(self, fn):
        self._middleware.append(fn)
        return fn

    def openapi(self) -> dict:
        """An OpenAPI 3.1 document of the registered routes, from the
        same route table the dispatcher reads."""
        from mlapi_tpu_torch import __version__

        paths: dict[str, dict] = {}
        schemas: dict[str, Any] = {}
        for (method, path), route in sorted(self._routes.items()):
            if path == "/openapi.json":
                continue
            fn = route.handler
            doc = inspect.getdoc(fn) or ""
            op: dict[str, Any] = {
                "summary": doc.splitlines()[0] if doc else path,
                "operationId": f"{method.lower()}_{fn.__name__}",
                "responses": {"200": {
                    "description": "Successful Response",
                    "content": {"application/json": {"schema": {}}},
                }},
            }
            if route.body is not None:
                schemas[route.body.name] = route.body.json_schema()
                ref = {"$ref": f"#/components/schemas/{route.body.name}"}
                op["requestBody"] = {
                    "required": True,
                    "content": {"application/json": {"schema": ref}},
                }
                op["responses"]["422"] = {
                    "description": "Validation Error",
                    "content": {"application/json": {"schema": {
                        "$ref": "#/components/schemas/ValidationError"}}},
                }
                schemas["ValidationError"] = {
                    "title": "ValidationError", "type": "object",
                    "properties": {"detail": {
                        "title": "Detail", "type": "array",
                        "items": {"type": "object"}}},
                }
            op.update(getattr(fn, "__openapi__", None) or {})
            paths.setdefault(path, {})[method.lower()] = op
        return {"openapi": "3.1.0",
                "info": {"title": self.title, "version": __version__},
                "paths": paths, "components": {"schemas": schemas}}

    def install_docs(self) -> None:
        """Serve :meth:`openapi` at ``GET /openapi.json``."""

        @self.get("/openapi.json")
        async def openapi_json():
            return self.openapi()

    def on_startup(self, fn):
        self._startup_hooks.append(fn)
        return fn

    def on_shutdown(self, fn):
        self._shutdown_hooks.append(fn)
        return fn

    # -- dispatch ---------------------------------------------------------
    async def _dispatch(self, request: Request) -> Response:
        key = (request.method, request.path)
        route = self._routes.get(key)
        if route is None:
            allowed = sorted(m for m, p in self._routes if p == request.path)
            if allowed:
                allow = ", ".join([*allowed, "OPTIONS"])
                if request.method == "OPTIONS":
                    resp = Response(b"", status=204, headers={"allow": allow})
                    resp.headers.pop("content-type", None)
                    return resp
                return json_response(
                    {"detail": "Method Not Allowed"}, 405,
                    headers={"allow": allow},
                )
            return json_response({"detail": "Not Found"}, 404)
        args: list = []
        if route.body is not None:
            args.append(route.body.validate(request.body))
        kwargs = {"request": request} if route.wants_request else {}
        result = await route.handler(*args, **kwargs)
        if isinstance(result, Response):
            return result
        return json_response(result)

    async def handle(self, request: Request) -> Response:
        call = self._dispatch
        for mw in reversed(self._middleware):
            call = _bind_middleware(mw, call)
        try:
            return await call(request)
        except HTTPError as e:
            return json_response({"detail": e.detail}, e.status, e.headers)
        except Exception:
            _log.error("unhandled error on %s %s\n%s", request.method,
                       request.path, traceback.format_exc())
            return json_response({"detail": "Internal Server Error"}, 500)

    # -- ASGI -------------------------------------------------------------
    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope type {scope['type']!r}")
        # Fast path: the framework's own server passes the read body.
        body = scope.get("extensions", {}).get("mlapi_tpu_torch.body")
        if body is None:
            buf = bytearray()
            while True:
                message = await receive()
                buf.extend(message.get("body", b""))
                if not message.get("more_body", False):
                    break
            body = bytes(buf)

        response = await self.handle(Request(scope, body))
        await send(
            {
                "type": "http.response.start",
                "status": response.status,
                "headers": [
                    (k.encode(), v.encode()) for k, v in response.headers.items()
                ],
            }
        )
        if isinstance(response, StreamingResponse):
            try:
                async for chunk in response.body_iter:
                    if chunk:
                        await send({
                            "type": "http.response.body", "body": chunk,
                            "more_body": True,
                        })
            except (Exception, asyncio.CancelledError) as e:
                # A disconnect surfaces as ConnectionResetError (own
                # server) or cancellation (test transports): close the
                # iterator NOW — its finally cancels the decode work.
                if isinstance(e, (ConnectionResetError, BrokenPipeError)):
                    _log.info("client disconnected mid-stream on %s %s",
                              scope.get("method"), scope.get("path"))
                elif not isinstance(e, asyncio.CancelledError):
                    _log.error("stream aborted on %s %s\n%s",
                               scope.get("method"), scope.get("path"),
                               traceback.format_exc())
                aclose = getattr(response.body_iter, "aclose", None)
                if aclose is not None:
                    try:
                        await aclose()
                    except Exception:
                        pass
                if isinstance(e, asyncio.CancelledError):
                    raise
            try:
                await send({"type": "http.response.body", "body": b""})
            except Exception:
                pass  # client is gone; nothing left to tell it
            return
        await send({"type": "http.response.body", "body": response.body})

    async def _lifespan(self, receive, send):
        while True:
            message = await receive()
            if message["type"] == "lifespan.startup":
                try:
                    await self.startup()
                    await send({"type": "lifespan.startup.complete"})
                except Exception as e:
                    await send({"type": "lifespan.startup.failed",
                                "message": str(e)})
            elif message["type"] == "lifespan.shutdown":
                await self.shutdown()
                await send({"type": "lifespan.shutdown.complete"})
                return

    async def startup(self):
        for hook in self._startup_hooks:
            await hook()

    async def shutdown(self):
        for hook in self._shutdown_hooks:
            await hook()


def _bind_middleware(mw, nxt):
    async def call(request: Request) -> Response:
        return await mw(request, nxt)

    return call
