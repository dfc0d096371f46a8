"""A small HTTP/1.1 server on asyncio streams, for the port's API server.

The JAX server runs on `aiohttp.web`; the port does without `aiohttp`.
This module gives `server/__init__.py` the part of `aiohttp.web` that
its handlers use, under the same names (`Request`, `Response`,
`json_response`, `StreamResponse`, `HTTPException` and the statuses the
handlers raise), and serves an `Application`'s routes on a socket:

- requests: the request line, headers, a `Content-Length` or chunked
  body, `Expect: 100-continue`, keep-alive (HTTP/1.1 by default, closed
  after `KEEPALIVE_S` idle seconds); a body over `MAX_BODY_BYTES`
  (aiohttp's `client_max_size` in the JAX server) is answered 413
  without being read, and the connection closed;
- a router over path patterns with `{name}` captures (one path segment
  each, percent-decoded), matched in the order they were added: 404 for
  a path no route matches, 405 for a path that matches only under other
  methods, and HEAD served by a GET route without its body, as aiohttp
  answers;
- responses with a length, and streamed (chunked) ones for SSE.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

MAX_BODY_BYTES = 256 * 1024 * 1024  # the JAX server's client_max_size
KEEPALIVE_S = 75.0                  # aiohttp's keep-alive timeout
_LINE_LIMIT = 1 << 16
_MAX_HEADERS = 128


class Headers(dict):
    """Header names are matched without regard to case."""

    def __init__(self, items=()):
        super().__init__()
        for k, v in (items.items() if isinstance(items, dict) else items):
            self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key):
        return super().__getitem__(key.lower())

    def __contains__(self, key):
        return super().__contains__(key.lower())

    def get(self, key, default=None):
        return super().get(key.lower(), default)


class Response:
    def __init__(self, *, body: bytes = b"", text: Optional[str] = None,
                 status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None):
        if text is not None:
            body = text.encode()
            if content_type == "application/octet-stream":
                content_type = "text/plain; charset=utf-8"
        self.body = body
        self.status = status
        self.headers = Headers(headers or {})
        self.headers.setdefault("content-type", content_type)


def json_response(data: Any, *, status: int = 200) -> Response:
    return Response(body=json.dumps(data).encode(), status=status,
                    content_type="application/json")


class HTTPException(Exception):
    """An answer raised from a handler: its status and body."""

    status_code = 500

    def __init__(self, *, text: Optional[str] = None,
                 content_type: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        if text is None:
            text = f"{self.status_code}: {_reason(self.status_code)}"
        super().__init__(text)
        self.text = text
        self.content_type = content_type or "text/plain; charset=utf-8"
        self.headers = headers or {}

    @property
    def status(self) -> int:
        return self.status_code

    def response(self) -> Response:
        return Response(text=self.text, status=self.status_code,
                        content_type=self.content_type, headers=self.headers)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPUnauthorized(HTTPException):
    status_code = 401


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413


class HTTPServiceUnavailable(HTTPException):
    status_code = 503


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, body: bytes, writer):
        self.method = method
        self.version = version
        self.headers = headers
        self.body = body
        self._writer = writer
        raw_path, _, qs = target.partition("?")
        self.raw_path = raw_path
        self.path = urllib.parse.unquote(raw_path)
        # first value of a repeated name wins, as aiohttp's MultiDict.get
        self.query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(qs, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.match_info: Dict[str, str] = {}
        self.route: Optional[str] = None  # the matched route's pattern

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    async def json(self) -> Any:
        return json.loads(self.body.decode())


class StreamResponse:
    """A response written as it goes (chunked): `prepare`, then `write`
    as often as needed; the server ends it after the handler returns."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = Headers(headers or {})
        self._writer = None

    async def prepare(self, request: Request) -> None:
        self._writer = request._writer
        head = [f"HTTP/1.1 {self.status} {_reason(self.status)}"]
        self.headers["transfer-encoding"] = "chunked"
        head += [f"{k}: {v}" for k, v in self.headers.items()]
        self._writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def write_eof(self) -> None:
        if self._writer is not None:
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()
            self._writer = None


Handler = Callable[[Request], Awaitable[Any]]


class Router:
    def __init__(self):
        self._routes: List[Tuple[str, str, Tuple[str, ...], Handler]] = []

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method, pattern, tuple(pattern.split("/")),
                             handler))

    def add_get(self, pattern, handler):
        self.add_route("GET", pattern, handler)

    def add_post(self, pattern, handler):
        self.add_route("POST", pattern, handler)

    def add_put(self, pattern, handler):
        self.add_route("PUT", pattern, handler)

    def resolve(self, method: str, raw_path: str):
        """(handler, pattern, captures) of the first route matching the
        path and method; raises HTTPNotFound / HTTPMethodNotAllowed."""
        segs = raw_path.split("/")
        allowed = []
        for m, pattern, psegs, handler in self._routes:
            if len(psegs) != len(segs):
                continue
            captures = {}
            for p, s in zip(psegs, segs):
                if p.startswith("{") and p.endswith("}"):
                    if not s:
                        break
                    captures[p[1:-1]] = urllib.parse.unquote(s)
                elif p != urllib.parse.unquote(s):
                    break
            else:
                if m == method or (method == "HEAD" and m == "GET"):
                    return handler, pattern, captures
                allowed.append(m)
        if allowed:
            raise HTTPMethodNotAllowed(
                headers={"Allow": ",".join(sorted(set(allowed)))})
        raise HTTPNotFound()


class Application:
    def __init__(self):
        self.router = Router()


class _BadRequest(Exception):
    pass


async def _read_head(reader: asyncio.StreamReader):
    """(method, target, version, headers) of the next request, or None at
    the end of the connection."""
    line = await reader.readline()
    if not line:
        return None
    if not line.endswith(b"\r\n") and not line.endswith(b"\n"):
        return None  # the peer went away mid-line
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(f"bad request line {line[:80]!r}")
    headers = Headers()
    for _ in range(_MAX_HEADERS):
        hl = await reader.readline()
        if hl in (b"\r\n", b"\n"):
            return parts[0], parts[1], parts[2], headers
        if not hl:
            return None
        name, sep, value = hl.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise _BadRequest(f"bad header line {hl[:80]!r}")
        headers[name.strip()] = value.strip()
    raise _BadRequest("too many headers")


async def _read_chunked(reader: asyncio.StreamReader, limit: int) -> bytes:
    out = bytearray()
    while True:
        size_line = await reader.readline()
        try:
            size = int(size_line.split(b";")[0].strip(), 16)
        except ValueError:
            raise _BadRequest("bad chunk size") from None
        if size == 0:
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass  # trailers
            return bytes(out)
        if len(out) + size > limit:
            raise HTTPRequestEntityTooLarge(
                text=f"Maximum request body size {limit} exceeded")
        out += await reader.readexactly(size)
        await reader.readline()


def _head(status: int, headers: Headers, keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {_reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append(f"connection: {'keep-alive' if keep_alive else 'close'}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Site:
    """An Application served on a socket (`serve`)."""

    def __init__(self, app: Application):
        self.app = app
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._tasks: set = set()   # the connections' handler tasks
        self.port = None

    async def start(self, host: str, port: int) -> "Site":
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, limit=_LINE_LIMIT,
            reuse_address=True)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        """Stop listening, close every connection and cancel and await its
        handler (a stream that waits for events, as the hook-log SSE
        does, would otherwise stay pending on the loop)."""
        if self._server is None:
            return
        self._server.close()
        for w in list(self._conns):
            w.close()
        tasks = [t for t in self._tasks if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _dispatch(self, req: Request):
        try:
            handler, req.route, req.match_info = self.app.router.resolve(
                req.method, req.raw_path)
            return await handler(req)
        except HTTPException as e:
            return e.response()
        except Exception:  # noqa: BLE001 — the handler's own fault
            import traceback

            traceback.print_exc()
            return Response(text="500: Internal Server Error", status=500)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        self._conns.add(writer)
        self._tasks.add(asyncio.current_task())
        try:
            while True:
                try:
                    head = await asyncio.wait_for(_read_head(reader),
                                                  KEEPALIVE_S)
                except (asyncio.TimeoutError, ValueError,
                        asyncio.LimitOverrunError):
                    break
                except _BadRequest as e:
                    writer.write(_head(400, Headers({
                        "content-type": "text/plain; charset=utf-8",
                        "content-length": str(len(str(e)))}), False)
                        + str(e).encode())
                    await writer.drain()
                    break
                if head is None:
                    break
                method, target, version, headers = head
                conn = headers.get("connection", "").lower()
                keep_alive = (conn != "close" if version == "HTTP/1.1"
                              else conn == "keep-alive")
                limit = MAX_BODY_BYTES
                try:
                    if headers.get("transfer-encoding", "").lower() == \
                            "chunked":
                        body = await _read_chunked(reader, limit)
                    else:
                        length = int(headers.get("content-length") or 0)
                        if length < 0:
                            raise ValueError(length)
                        if length > limit:
                            raise HTTPRequestEntityTooLarge(
                                text=f"Maximum request body size {limit} "
                                     f"exceeded, actual body size {length}")
                        if length and headers.get("expect", "").lower() == \
                                "100-continue":
                            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                        body = await reader.readexactly(length) \
                            if length else b""
                except HTTPException as e:
                    resp = e.response()
                    resp.headers["content-length"] = str(len(resp.body))
                    writer.write(_head(resp.status, resp.headers, False)
                                 + resp.body)
                    await writer.drain()
                    break
                except (_BadRequest, ValueError):
                    writer.write(_head(400, Headers({
                        "content-length": "0"}), False))
                    await writer.drain()
                    break
                req = Request(method, target, version, headers, body, writer)
                resp = await self._dispatch(req)
                if isinstance(resp, StreamResponse):
                    if resp._writer is None and not writer.is_closing():
                        await resp.prepare(req)
                    await resp.write_eof()
                else:
                    resp.headers["content-length"] = str(len(resp.body))
                    writer.write(_head(resp.status, resp.headers, keep_alive)
                                 + (b"" if method == "HEAD" else resp.body))
                    await writer.drain()
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(writer)
            self._tasks.discard(asyncio.current_task())
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass


async def serve(app: Application, host: str, port: int) -> Site:
    """Serve `app` on host:port (port 0: any free port; `Site.port`)."""
    return await Site(app).start(host, port)
