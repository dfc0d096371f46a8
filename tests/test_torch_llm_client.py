"""The port's LLM client (`oramacore_tpu_torch.ai.llms`: its HTTP/1.1
client on asyncio streams) against raw scripted servers, on the CPU.

Each server here reads one request and writes the bytes a case gives,
so the client meets every framing an OpenAI-compatible provider may use:
`Content-Length`, chunked and close-delimited bodies, SSE lines split
across chunks, `data:` without its space, tool calls, failures that are
retried with backoff and failures that exhaust the retries, a stalled
answer that hits the timeout, and TLS with a certificate trusted through
`SSL_CERT_FILE`. What the client wrote is kept, so its request line and
headers (`Accept-Encoding: identity`) are checked on the wire.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import ssl
import subprocess
import time

import pytest

from oramacore_tpu_torch.ai import llms


class RawServer:
    """A TCP server that answers the i-th request with `answers[i]` (the
    last one again past the end): bytes, or a list of byte pieces
    written with a flush and `gap_s` between them. `None` as a piece
    stalls the answer. Every request's raw bytes are kept."""

    def __init__(self, answers, gap_s=0.0, ssl_ctx=None):
        self.answers = answers
        self.gap_s = gap_s
        self.ssl_ctx = ssl_ctx
        self.requests = []
        self.server = None
        self.tasks = set()

    async def _handle(self, reader, writer):
        self.tasks.add(asyncio.current_task())
        head = await reader.readuntil(b"\r\n\r\n")
        length = 0
        for line in head.split(b"\r\n"):
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"content-length":
                length = int(v)
        body = await reader.readexactly(length)
        self.requests.append((head, body))
        answer = self.answers[min(len(self.requests), len(self.answers)) - 1]
        pieces = answer if isinstance(answer, list) else [answer]
        try:
            for piece in pieces:
                if piece is None:
                    await asyncio.sleep(3600)
                writer.write(piece)
                await writer.drain()
                if self.gap_s:
                    await asyncio.sleep(self.gap_s)
        finally:
            writer.close()

    async def start(self):
        self.server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0, ssl=self.ssl_ctx)
        return self.server.sockets[0].getsockname()[1]

    async def stop(self):
        self.server.close()
        for task in self.tasks:  # a stalled answer ends here
            task.cancel()
        await asyncio.wait_for(self.server.wait_closed(), 10)


def _json_answer(payload, status="200 OK", ctype="application/json"):
    body = json.dumps(payload).encode()
    return (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _message(content=None, tool_calls=None):
    msg = {"role": "assistant", "content": content}
    if tool_calls is not None:
        msg["tool_calls"] = tool_calls
    return {"choices": [{"index": 0, "message": msg}]}


def _chunked(pieces, ctype="text/event-stream"):
    out = [f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
           f"Transfer-Encoding: chunked\r\n\r\n".encode()]
    out += [b"%x\r\n%s\r\n" % (len(p), p) for p in pieces]
    out.append(b"0\r\n\r\n")
    return out


def _sse(words, space=True):
    sep = "data: " if space else "data:"
    return "".join(f"{sep}{json.dumps({'choices': [{'delta': {'content': w}}]})}\n\n"
                   for w in words) + f"{sep}[DONE]\n\n"


def _service(port, scheme="http", host="127.0.0.1", **kw):
    kw.setdefault("backoff_base_s", 0.01)
    return llms.LLMService(llms.LLMProviderConfig(
        "p", f"{scheme}://{host}:{port}/v1", "m", api_key="sk-test"), **kw)


def _run(answers, fn, **server_kw):
    async def go():
        srv = RawServer(answers, **server_kw)
        port = await srv.start()
        try:
            return await fn(_service(port)), srv
        finally:
            await srv.stop()

    return asyncio.run(go())


def _chat(svc):
    return svc.chat([{"role": "user", "content": "hi"}])


async def _stream(svc):
    return [t async for t in svc.chat_stream(
        [{"role": "user", "content": "hi"}])]


def test_content_length_body_and_the_request_on_the_wire():
    out, srv = _run([_json_answer(_message("hello"))], _chat)
    assert out["content"] == "hello"
    head, body = srv.requests[0]
    lines = head.decode("latin-1").split("\r\n")
    assert lines[0] == "POST /v1/chat/completions HTTP/1.1"
    headers = {k.lower(): v.strip() for k, _, v in
               (ln.partition(":") for ln in lines[1:] if ln)}
    assert headers["accept-encoding"] == "identity"
    assert headers["authorization"] == "Bearer sk-test"
    assert headers["content-type"] == "application/json"
    assert headers["host"].startswith("127.0.0.1:")
    assert headers["connection"] == "close"
    assert int(headers["content-length"]) == len(body)
    sent = json.loads(body)
    assert sent == {"model": "m", "messages": [{"role": "user",
                                                "content": "hi"}],
                    "temperature": 0.0}
    # the body is json.dumps of the request, as aiohttp's json= sends it
    assert body == json.dumps(sent).encode()


def test_chunked_body():
    payload = json.dumps(_message("chunked hello")).encode()
    answer = _chunked([payload[:7], payload[7:30], payload[30:]],
                      ctype="application/json")
    out, _ = _run([answer], _chat, gap_s=0.01)
    assert out["content"] == "chunked hello"


def test_close_delimited_body():
    payload = json.dumps(_message("until close")).encode()
    answer = [b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n\r\n",
              payload[:10], payload[10:]]
    out, _ = _run([answer], _chat, gap_s=0.01)
    assert out["content"] == "until close"


@pytest.mark.parametrize("space", [True, False], ids=["data: ", "data:"])
def test_sse_lines_split_across_chunks(space):
    raw = _sse(["alpha ", "beta ", "gamma"], space=space).encode()
    # cut inside a line, inside "data:", and at a newline
    cuts = [0, 5, 3 + raw.index(b"beta"), raw.index(b"\n") + 1, len(raw) - 4,
            len(raw)]
    cuts = sorted(set(cuts))
    pieces = [raw[a:b] for a, b in zip(cuts, cuts[1:])]
    out, _ = _run([_chunked(pieces)], _stream, gap_s=0.01)
    assert out == ["alpha ", "beta ", "gamma"]


def test_sse_close_delimited_and_content_length():
    raw = _sse(["one ", "two"]).encode()
    close = [b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n\r\n",
             raw[:9], raw[9:]]
    out, _ = _run([close], _stream, gap_s=0.01)
    assert out == ["one ", "two"]
    framed = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
              b"Content-Length: %d\r\n\r\n" % len(raw)) + raw
    out, _ = _run([framed], _stream)
    assert out == ["one ", "two"]


def test_tool_calls():
    calls = [{"id": "c1", "type": "function",
              "function": {"name": "get_weather",
                           "arguments": "{\"city\": \"Rome\"}"}}]

    async def fn(svc):
        return await svc.execute_tools(
            [{"role": "user", "content": "weather?"}],
            [{"type": "function", "function": {"name": "get_weather"}}])

    out, srv = _run([_json_answer(_message(None, calls))], fn)
    assert out == calls
    assert json.loads(srv.requests[0][1])["tools"][0]["function"]["name"] \
        == "get_weather"


def test_failures_are_retried_with_backoff():
    fail = _json_answer({"error": "overloaded"}, "500 Internal Server Error")
    answers = [fail, b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
               b"Content-Length: 5\r\n\r\n{\"ch", _json_answer(_message("ok"))]

    async def fn(svc):
        t0 = time.perf_counter()
        out = await _chat(svc)
        return out, time.perf_counter() - t0

    async def go():
        srv = RawServer(answers)
        port = await srv.start()
        try:
            return await fn(_service(port, backoff_base_s=0.1)), srv
        finally:
            await srv.stop()

    (out, took), srv = asyncio.run(go())
    # an HTTP 500, then a body cut short (IncompleteReadError), then ok
    assert out["content"] == "ok" and len(srv.requests) == 3
    assert took >= 0.1 + 0.2  # the backoff after each failure


@pytest.mark.parametrize("answer", [
    _json_answer({"error": "down"}, "503 Service Unavailable"),
    _json_answer({"no": "choices"}),                       # KeyError
    _json_answer(_message("x"), ctype="text/html"),         # content type
    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
    b"Content-Length: 4\r\n\r\n{bad",                       # JSON
    b"HTTP/1.1 200 OK\r\nContent-Encoding: gzip\r\n"
    b"Content-Length: 2\r\n\r\n{}",                         # encoding
    b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
    b"garbage\r\n\r\n",                                     # status line
    b"",                                                    # no answer
], ids=["503", "no choices", "content type", "bad json", "gzip",
        "bad chunk", "bad status line", "closed"])
def test_exhausted_retries_raise_llm_error(answer):
    async def go():
        srv = RawServer([answer])
        port = await srv.start()
        try:
            with pytest.raises(llms.LLMError, match="after 2 retries"):
                await _chat(_service(port, max_retries=2))
        finally:
            await srv.stop()
        return srv

    srv = asyncio.run(go())
    assert len(srv.requests) == 2


def test_refused_connection_is_retried_then_raises():
    async def go():
        srv = RawServer([b""])
        port = await srv.start()
        await srv.stop()
        with pytest.raises(llms.LLMError, match="after 3 retries"):
            await _chat(_service(port))

    asyncio.run(go())


def test_timeout(monkeypatch):
    monkeypatch.setattr(llms, "TIMEOUT_S", 0.3)
    stall_body = [b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                  b"Content-Length: 100\r\n\r\n{", None]
    stall_head = [None]

    async def go(answer):
        srv = RawServer([answer])
        port = await srv.start()
        try:
            svc = _service(port, max_retries=2)
            t0 = time.perf_counter()
            with pytest.raises(llms.LLMError, match="after 2 retries"):
                await _chat(svc)
            took = time.perf_counter() - t0
            with pytest.raises(asyncio.TimeoutError):
                async with llms.post(f"http://127.0.0.1:{port}/v1/x", {},
                                     {}) as resp:
                    await resp.read()
        finally:
            await srv.stop()
        return took, srv

    for answer in (stall_body, stall_head):
        took, srv = asyncio.run(go(answer))
        assert 0.6 <= took < 5 and len(srv.requests) == 3


def test_stream_timeout_covers_the_whole_body(monkeypatch):
    """The total timeout holds for a stream too: tokens that keep coming
    do not extend it."""
    monkeypatch.setattr(llms, "TIMEOUT_S", 0.5)
    raw = _sse([f"w{i} " for i in range(40)]).encode()
    pieces = [raw[i:i + 40] for i in range(0, len(raw), 40)]

    async def go():
        srv = RawServer([_chunked(pieces)], gap_s=0.05)
        port = await srv.start()
        got = []
        try:
            with pytest.raises(asyncio.TimeoutError):
                async for tok in _service(port).chat_stream(
                        [{"role": "user", "content": "hi"}]):
                    got.append(tok)
        finally:
            await srv.stop()
        return got

    got = asyncio.run(go())
    assert 0 < len(got) < 40


def test_stream_error_status_raises():
    async def fn(svc):
        with pytest.raises(llms.LLMError, match="HTTP 429"):
            await _stream(svc)
        return None

    _, srv = _run([_json_answer({"error": "slow down"},
                                "429 Too Many Requests")], fn)
    assert len(srv.requests) == 1  # a stream is not retried, as in JAX


def test_interim_answer_is_skipped():
    answer = b"HTTP/1.1 100 Continue\r\n\r\n" + _json_answer(_message("ok"))
    out, _ = _run([answer], _chat)
    assert out["content"] == "ok"


def test_https_with_a_self_signed_certificate(tmp_path, monkeypatch):
    """TLS through the default context: the server's self-signed
    certificate is trusted once SSL_CERT_FILE names it, and refused
    (an OSError, retried, then LLMError) while it does not."""
    if shutil.which("openssl") is None:
        pytest.skip("no openssl executable to make a certificate with")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "2",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True, timeout=120)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(cert), str(key))

    async def go():
        srv = RawServer([_json_answer(_message("over tls"))],
                        ssl_ctx=server_ctx)
        port = await srv.start()
        try:
            monkeypatch.delenv("SSL_CERT_FILE", raising=False)
            monkeypatch.setenv("SSL_CERT_DIR", str(tmp_path / "none"))
            with pytest.raises(llms.LLMError):
                await _chat(_service(port, "https", "localhost",
                                     max_retries=1))
            monkeypatch.setenv("SSL_CERT_FILE", str(cert))
            return await _chat(_service(port, "https", "localhost"))
        finally:
            await srv.stop()

    assert asyncio.run(go())["content"] == "over tls"


def test_only_http_urls():
    with pytest.raises(ValueError):
        llms.post("ftp://x/v1", {}, {})
    with pytest.raises(ValueError):
        llms.post("http:///v1", {}, {})


def test_retried_faults_are_the_jax_clients_with_the_port_transports():
    assert set(llms.RETRIED) == {
        OSError, asyncio.IncompleteReadError, asyncio.TimeoutError,
        llms.HTTPFramingError, llms.LLMError, KeyError,
        json.JSONDecodeError}
