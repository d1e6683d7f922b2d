"""Asyncio HTTP/1.1 server speaking ASGI.

A copy of ``mlapi_tpu/serving/server.py``: a single-process asyncio
server with persistent connections, Content-Length and chunked request
bodies, chunked streaming responses, and hard limits on header/body
sizes. One event loop; the device work runs on the engine's own
thread. :class:`BackgroundServer` runs it on a thread of its own, for
callers that serve and send requests from one process.
"""

from __future__ import annotations

import asyncio
from urllib.parse import unquote

import threading

from mlapi_tpu_torch.utils.logging import get_logger

_log = get_logger("serving.server")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 256 * 1024 * 1024
_STATUS_PHRASES = {
    200: "OK", 204: "No Content", 304: "Not Modified",
    400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 411: "Length Required", 413: "Payload Too Large",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway",  # the router's upstream-replica failure
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class HttpProtocolError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class Server:
    """Serves one ASGI app on (host, port); port 0 picks a free one
    (``self.port`` holds the bound port after :meth:`start`)."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8000):
        self.app = app
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None

    async def start(self) -> None:
        await self.app.startup()
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        _log.info("listening on http://%s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.app.shutdown()

    # -- connection handling ---------------------------------------------
    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    request = await _read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break  # client closed between requests
                except HttpProtocolError as e:
                    await _write_simple(writer, e.status, e.detail)
                    break
                if request is None:
                    break
                keep_alive = await self._dispatch(request, writer)
                if not keep_alive:
                    break
        except Exception:
            _log.exception("connection error from %s", peer)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _dispatch(self, request: "_ParsedRequest", writer) -> bool:
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": request.version,
            "method": request.method,
            "scheme": "http",
            "path": request.path,
            "raw_path": request.raw_path.encode("latin-1"),
            "query_string": request.query.encode("latin-1"),
            "headers": request.headers,  # bytes pairs, passed through
            # Body already fully read — the framework's own App picks
            # it up here and skips the receive-message round trip.
            "extensions": {"mlapi_tpu_torch.body": request.body},
        }

        body_sent = False

        async def receive():
            nonlocal body_sent
            if body_sent:
                return {"type": "http.disconnect"}
            body_sent = True
            return {"type": "http.request", "body": request.body, "more_body": False}

        keep_alive = _wants_keep_alive(request)
        # state: headers buffered until the first body message decides
        # the framing — a single-shot body gets content-length (the
        # /predict fast path, one write + one drain per response); a
        # streamed body (more_body=True) switches to chunked transfer
        # encoding with a write+drain per chunk so the client sees
        # data as the handler produces it. HTTP/1.0 clients don't
        # de-frame chunked encoding, so a stream to them is
        # close-delimited (raw bytes, connection: close) instead.
        chunked_ok = request.version != "1.0"
        state = {"status": 500, "headers": [], "streaming": False,
                 "started": False}

        def _head(extra: bytes) -> bytes:
            status = state["status"]
            phrase = _STATUS_PHRASES.get(status, "Unknown")
            # Bytes all the way down — response headers arrive as
            # bytes from ASGI and hit the socket as bytes.
            head = bytearray(
                f"HTTP/1.1 {status} {phrase}\r\n".encode("latin-1")
            )
            for k, v in state["headers"]:
                if k.lower() not in (b"content-length", b"transfer-encoding"):
                    head += k + b": " + v + b"\r\n"
            head += extra
            head += (
                b"connection: keep-alive\r\n\r\n"
                if keep_alive
                else b"connection: close\r\n\r\n"
            )
            return bytes(head)

        async def send(message):
            nonlocal keep_alive
            if message["type"] == "http.response.start":
                state["status"] = message["status"]
                state["headers"] = message.get("headers", [])
                return
            if message["type"] != "http.response.body":
                return
            body = message.get("body", b"")
            more = message.get("more_body", False)
            if not state["started"]:
                state["started"] = True
                if not more:
                    if state["status"] in (204, 304):
                        # RFC 9110 §8.6: no Content-Length (and no
                        # body) on 204/304.
                        writer.write(_head(b""))
                    else:
                        writer.write(
                            _head(
                                b"content-length: "
                                + str(len(body)).encode() + b"\r\n"
                            )
                            + body
                        )
                    await writer.drain()
                    return
                state["streaming"] = True
                if chunked_ok:
                    writer.write(_head(b"transfer-encoding: chunked\r\n"))
                else:
                    keep_alive = False  # close delimits the 1.0 body
                    writer.write(_head(b""))
            if not state["streaming"]:
                return  # spurious extra message after a completed body
            if writer.transport.is_closing():
                # Client went away mid-stream. write() on a closing
                # transport is silently dropped and drain() may not
                # raise for buffered writes — fail loudly so the app
                # can cancel the work feeding this stream.
                raise ConnectionResetError("client disconnected mid-stream")
            if not chunked_ok:
                if body:
                    writer.write(body)
                await writer.drain()
                return
            if body:
                writer.write(
                    b"%x\r\n" % len(body) + body + b"\r\n"
                )
            if not more:
                writer.write(b"0\r\n\r\n")
            await writer.drain()

        await self.app(scope, receive, send)
        if not state["started"]:
            # App produced no body message at all; close the exchange.
            writer.write(_head(b"content-length: 0\r\n"))
            await writer.drain()
        return keep_alive


class _ParsedRequest:
    __slots__ = ("method", "raw_path", "path", "query", "version", "headers", "body")

    def __init__(self, method, raw_path, path, query, version, headers, body):
        self.method = method
        self.raw_path = raw_path
        self.path = path
        self.query = query
        self.version = version
        self.headers = headers
        self.body = body


async def _read_request(reader: asyncio.StreamReader) -> _ParsedRequest | None:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.LimitOverrunError:
        raise HttpProtocolError(431, "headers too large") from None
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean EOF between keep-alive requests
        raise
    if len(head) > MAX_HEADER_BYTES:
        raise HttpProtocolError(431, "headers too large")

    # Headers stay bytes end to end: parsed as bytes here, passed as
    # bytes in the ASGI scope, decoded lazily only if a handler reads
    # them (the /predict hot path never does).
    lines = head.split(b"\r\n")
    try:
        method_b, target_b, proto = lines[0].split(b" ", 2)
        method = method_b.decode("latin-1")
        target = target_b.decode("latin-1")
    except (ValueError, UnicodeDecodeError):
        raise HttpProtocolError(400, f"malformed request line: {lines[0]!r}") from None
    if not proto.startswith(b"HTTP/1."):
        raise HttpProtocolError(501, f"unsupported protocol {proto!r}")
    version = proto[5:].decode("latin-1")

    headers: list[tuple[bytes, bytes]] = []
    for line in lines[1:]:
        if not line:
            continue
        key, sep, value = line.partition(b":")
        if not sep:
            raise HttpProtocolError(400, f"malformed header line: {line!r}")
        headers.append((key.strip().lower(), value.strip()))

    # Framing headers via one linear scan (no dict build per request).
    te = clen = None
    for k, v in headers:
        if k == b"content-length":
            clen = v
        elif k == b"transfer-encoding":
            te = v
    body = b""
    if te is not None:
        if te.lower() != b"chunked":
            raise HttpProtocolError(501, "unsupported transfer-encoding")
        body = await _read_chunked(reader)
    elif clen is not None:
        try:
            n = int(clen)
        except ValueError:
            raise HttpProtocolError(400, "bad content-length") from None
        if n > MAX_BODY_BYTES:
            raise HttpProtocolError(413, "body too large")
        body = await reader.readexactly(n) if n else b""
    elif method in ("POST", "PUT", "PATCH"):
        # No length and not chunked: only valid if there is no body.
        pass

    raw_path, _, query = target.partition("?")
    return _ParsedRequest(
        method=method,
        raw_path=target,
        path=unquote(raw_path),
        query=query,
        version=version,
        headers=headers,
        body=body,
    )


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        size_line = (await reader.readuntil(b"\r\n")).strip()
        try:
            size = int(size_line.split(b";")[0], 16)
        except ValueError:
            raise HttpProtocolError(400, f"bad chunk size {size_line!r}") from None
        if size < 0:
            raise HttpProtocolError(400, f"negative chunk size {size_line!r}")
        if size == 0:
            # Trailers until blank line.
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass
            return bytes(out)
        if len(out) + size > MAX_BODY_BYTES:
            raise HttpProtocolError(413, "body too large")
        out.extend(await reader.readexactly(size))
        if await reader.readexactly(2) != b"\r\n":
            raise HttpProtocolError(400, "chunk not CRLF-terminated")


def _wants_keep_alive(request: _ParsedRequest) -> bool:
    # Linear scan, no dict build: this runs per request and a request
    # carries a handful of headers. No early break — duplicates keep
    # the dict's last-wins semantics.
    conn = b""
    for k, v in request.headers:
        if k == b"connection":
            conn = v.lower()
    if request.version == "1.0":
        return conn == b"keep-alive"
    return conn != b"close"


async def _write_simple(writer, status: int, detail: str) -> None:
    body = detail.encode()
    phrase = _STATUS_PHRASES.get(status, "Error")
    writer.write(
        (
            f"HTTP/1.1 {status} {phrase}\r\ncontent-type: text/plain\r\n"
            f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
        ).encode("latin-1")
        + body
    )
    try:
        await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        pass


class BackgroundServer:
    """Run a :class:`Server` on its own thread and event loop::

        with BackgroundServer(app) as srv:
            urlopen(f"http://127.0.0.1:{srv.port}/healthz")

    Entering starts the app (its startup hooks: warmup, collector) and
    returns once the port is bound; leaving stops the server and the
    app and joins the thread. A startup failure is re-raised here."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 600.0):
        self.server = Server(app, host, port)
        self.timeout_s = timeout_s
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._ready = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._main, name="mlapi-http", daemon=True
        )

    @property
    def port(self) -> int:
        return self.server.port

    def _main(self) -> None:
        async def run():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            try:
                await self.server.start()
            except BaseException as e:  # reported to the entering thread
                self._error = e
                self._ready.set()
                raise
            self._ready.set()
            try:
                await self._stop.wait()
            finally:
                await self.server.stop()

        try:
            asyncio.run(run())
        except BaseException as e:  # noqa: BLE001 — kept for __exit__
            if self._error is None:
                self._error = e

    def __enter__(self) -> "BackgroundServer":
        self._thread.start()
        if not self._ready.wait(self.timeout_s):
            raise TimeoutError("server did not start in time")
        if self._error is not None:
            self._thread.join(self.timeout_s)
            raise self._error
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(self.timeout_s)
        if self._thread.is_alive():
            raise TimeoutError("server did not stop in time")
