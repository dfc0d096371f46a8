"""LLMService: unified chat-completions client over local or remote
OpenAI-compatible providers.

Reference: src/ai/llms.rs — provider registry (ai/mod.rs:32-40: local
vLLM + OramaCore/OpenAI/Fireworks/Together/GoogleVertex/Groq/Anthropic
remotes), `format_prompt` (:220), `run_known_prompt` (:526) + streaming
(:560), accelerator-overload-aware provider selection (:673-782 — NVML
in the reference; here a pluggable overload probe, since the card is the
search data plane and LLM serving stays an external process).

The port of `oramacore_tpu/ai/llms.py`: the same provider selection,
retries with backoff, request bodies, SSE parsing and JSON extraction.
Its transport is its own HTTP/1.1 client on asyncio streams (`post`) in
place of an `aiohttp.ClientSession`:

- `http` and `https` (the default TLS context, so `SSL_CERT_FILE` is
  honoured), one connection a call (`Connection: close`), so nothing is
  bound to an event loop between calls;
- `Accept-Encoding: identity` on every request (the client decodes no
  compression; a compressed answer is a framing error);
- answers framed by `Content-Length`, `Transfer-Encoding: chunked` or
  the connection's close; SSE lines may split across chunks;
- a total timeout of `TIMEOUT_S` a call, as `aiohttp.ClientTimeout(
  total=120)` gives the JAX client.

A call is retried on exactly what the JAX client retries on, with the
client's faults in place of `aiohttp.ClientError`: `OSError` (refused,
reset, TLS), `asyncio.IncompleteReadError`, `asyncio.TimeoutError` and
`HTTPFramingError`, and `LLMError`, `KeyError`, `json.JSONDecodeError`.
"""

from __future__ import annotations

import asyncio
import json
import random
import ssl
import urllib.parse
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

from .prompts import format_prompt

TIMEOUT_S = 120.0          # a call's total time, aiohttp.ClientTimeout(total=120)
_LINE_LIMIT = 1 << 16      # the longest status or header line read
_MAX_HEADERS = 128


@dataclass
class LLMProviderConfig:
    name: str              # local | openai | fireworks | together | groq | anthropic | ...
    url: str               # base url, e.g. http://host:port/v1
    model: str
    api_key: str = ""
    is_local: bool = True


@dataclass
class LLMConfig:
    """Per-request overrides (Interaction.llm_config)."""

    provider: Optional[str] = None
    model: Optional[str] = None
    temperature: Optional[float] = None


class LLMError(Exception):
    pass


class HTTPFramingError(Exception):
    """An answer the client cannot read: a bad status line, header or
    chunk, a content encoding or content type it does not take."""


# ---------------------------------------------------------------------------
# the HTTP/1.1 client
# ---------------------------------------------------------------------------

class _Deadline:
    """The time left of one call: every read and write waits at most that
    long, and raises asyncio.TimeoutError once it is spent."""

    def __init__(self, seconds: float):
        self.at = asyncio.get_running_loop().time() + seconds

    async def io(self, aw):
        left = self.at - asyncio.get_running_loop().time()
        if left <= 0:
            if asyncio.iscoroutine(aw):
                aw.close()
            raise asyncio.TimeoutError("the call's total timeout expired")
        return await asyncio.wait_for(aw, left)


class HTTPResponse:
    """An answer being read: `status`, `headers` (lower-case names), then
    the body as `read()`, `text()`, `json()` or `lines()`."""

    def __init__(self, reader: asyncio.StreamReader, deadline: _Deadline,
                 status: int, headers: Dict[str, str]):
        self._reader = reader
        self._deadline = deadline
        self.status = status
        self.headers = headers
        enc = headers.get("content-encoding", "identity").lower()
        if enc not in ("", "identity"):
            raise HTTPFramingError(f"content-encoding {enc!r} was not asked "
                                   f"for (Accept-Encoding: identity)")

    async def chunks(self) -> AsyncIterator[bytes]:
        """The body's bytes as they arrive, by its framing."""
        r, io = self._reader, self._deadline.io
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            while True:
                line = await _line(r, self._deadline)
                try:
                    size = int(line.split(b";")[0].strip(), 16)
                except ValueError:
                    raise HTTPFramingError(
                        f"bad chunk size line {line[:40]!r}") from None
                if size < 0:
                    raise HTTPFramingError(f"negative chunk size {size}")
                if size == 0:
                    while (await _line(r, self._deadline)).strip():
                        pass  # trailers
                    return
                yield await io(r.readexactly(size))
                if (await _line(r, self._deadline)).strip():
                    raise HTTPFramingError("chunk data not followed by CRLF")
        elif "content-length" in self.headers:
            try:
                left = int(self.headers["content-length"])
            except ValueError:
                raise HTTPFramingError("bad content-length") from None
            if left < 0:
                raise HTTPFramingError(f"negative content-length {left}")
            while left:
                data = await io(r.read(min(left, 1 << 16)))
                if not data:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(data)
                yield data
        else:  # delimited by the connection's close
            while True:
                data = await io(r.read(1 << 16))
                if not data:
                    return
                yield data

    async def read(self) -> bytes:
        return b"".join([c async for c in self.chunks()])

    async def text(self) -> str:
        return (await self.read()).decode(errors="replace")

    async def json(self) -> Any:
        """The body as JSON; like aiohttp's, only for a JSON content type."""
        ctype = self.headers.get("content-type", "").split(";")[0].strip()
        if ctype != "application/json" and not ctype.endswith("+json"):
            raise HTTPFramingError(f"expected a JSON answer, got content "
                                   f"type {ctype!r}")
        return json.loads(await self.read())

    async def lines(self) -> AsyncIterator[bytes]:
        """The body line by line (each with its b"\\n", the last one
        without where the body does not end in one), whatever the chunks."""
        buf = b""
        async for data in self.chunks():
            buf += data
            *done, buf = buf.split(b"\n")
            for line in done:
                yield line + b"\n"
        if buf:
            yield buf


async def _line(reader: asyncio.StreamReader, deadline: _Deadline) -> bytes:
    """The next line of a head or of a chunked body's framing."""
    try:
        return await deadline.io(reader.readuntil(b"\n"))
    except asyncio.LimitOverrunError:
        raise HTTPFramingError(f"a line over {_LINE_LIMIT} bytes") from None


async def _read_head(reader: asyncio.StreamReader, deadline: _Deadline):
    """(status, headers) of the answer, past any 1xx interim answer."""
    while True:
        line = await _line(reader, deadline)
        parts = line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
            raise HTTPFramingError(f"bad status line {line[:80]!r}")
        try:
            status = int(parts[1])
        except ValueError:
            raise HTTPFramingError(f"bad status {parts[1]!r}") from None
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS):
            hl = await _line(reader, deadline)
            if not hl.strip():
                break
            name, sep, value = hl.decode("latin-1").partition(":")
            if not sep or not name.strip():
                raise HTTPFramingError(f"bad header line {hl[:80]!r}")
            headers[name.strip().lower()] = value.strip()
        else:
            raise HTTPFramingError("too many headers")
        if not 100 <= status < 200:
            return status, headers


class post:
    """`async with post(url, body, headers) as resp`: one POST of `body`
    as JSON on a connection of its own, the answer's head read; the body
    is read through `resp`. The connection closes at the block's end.
    Everything, the body included, must arrive within `TIMEOUT_S`."""

    def __init__(self, url: str, body: Any, headers: Dict[str, str]):
        self.url = urllib.parse.urlsplit(url)
        if self.url.scheme not in ("http", "https") or not self.url.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        self.body = json.dumps(body).encode()
        self.headers = headers
        self._writer = None

    async def __aenter__(self) -> HTTPResponse:
        u = self.url
        deadline = _Deadline(TIMEOUT_S)
        tls = u.scheme == "https"
        port = u.port or (443 if tls else 80)
        reader, self._writer = await deadline.io(asyncio.open_connection(
            u.hostname, port, limit=_LINE_LIMIT,
            ssl=ssl.create_default_context() if tls else None,
            server_hostname=u.hostname if tls else None))
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        host = u.hostname if u.port is None else f"{u.hostname}:{u.port}"
        head = {"Host": host, "Accept": "*/*",
                "Accept-Encoding": "identity",
                "Content-Type": "application/json",
                **self.headers,
                "Content-Length": str(len(self.body)),
                "Connection": "close"}
        try:
            self._writer.write(
                (f"POST {target} HTTP/1.1\r\n"
                 + "".join(f"{k}: {v}\r\n" for k, v in head.items())
                 + "\r\n").encode("latin-1") + self.body)
            await deadline.io(self._writer.drain())
            status, headers = await _read_head(reader, deadline)
            return HTTPResponse(reader, deadline, status, headers)
        except BaseException:
            await self.__aexit__()
            raise

    async def __aexit__(self, *exc) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except OSError:
                pass  # the peer reset a connection we are done with
            self._writer = None


# the faults a call is retried on: the JAX client's, with this client's
# own in place of aiohttp.ClientError
RETRIED = (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError,
           HTTPFramingError, LLMError, KeyError, json.JSONDecodeError)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class LLMService:
    def __init__(
        self,
        local: Optional[LLMProviderConfig],
        remotes: Optional[List[LLMProviderConfig]] = None,
        overload_probe: Optional[Callable[[], bool]] = None,
        max_retries: int = 3,
        backoff_base_s: float = 0.1,
        backoff_max_s: float = 30.0,
    ):
        self.local = local
        self.remotes = remotes or []
        self.overload_probe = overload_probe
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s

    async def close(self):
        """Nothing to release: every call opens and closes its own
        connection (the JAX client closes its session here)."""

    # ------------------------------------------------------------------

    def select_provider(self, llm_config: Optional[LLMConfig] = None) -> LLMProviderConfig:
        """Local unless overloaded/absent → random remote fallback
        (reference read/mod.rs:934, answer.rs HandleGPUOverload)."""
        if llm_config and llm_config.provider:
            for p in [self.local, *self.remotes]:
                if p and p.name == llm_config.provider:
                    return p
            raise LLMError(f"unknown provider {llm_config.provider!r}")
        overloaded = bool(self.overload_probe and self.overload_probe())
        if self.local and not overloaded:
            return self.local
        if self.remotes:
            return random.choice(self.remotes)
        if self.local:
            return self.local
        raise LLMError("no LLM providers configured")

    # ------------------------------------------------------------------

    async def chat(
        self,
        messages: List[Dict[str, str]],
        llm_config: Optional[LLMConfig] = None,
        temperature: float = 0.0,
        tools: Optional[List[Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        """One chat-completions call with retries; returns the raw message
        dict ({"content": ..., "tool_calls": [...]})."""
        provider = self.select_provider(llm_config)
        body: Dict[str, Any] = {
            "model": (llm_config.model if llm_config and llm_config.model
                      else provider.model),
            "messages": messages,
            "temperature": (llm_config.temperature
                            if llm_config and llm_config.temperature is not None
                            else temperature),
        }
        if tools:
            body["tools"] = tools
        headers = {"Content-Type": "application/json"}
        if provider.api_key:
            headers["Authorization"] = f"Bearer {provider.api_key}"

        last: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                async with post(
                    f"{provider.url.rstrip('/')}/chat/completions",
                    body, headers,
                ) as resp:
                    if resp.status != 200:
                        raise LLMError(
                            f"provider {provider.name} HTTP {resp.status}: "
                            f"{(await resp.text())[:300]}"
                        )
                    data = await resp.json()
                    return data["choices"][0]["message"]
            except RETRIED as e:
                last = e
                await asyncio.sleep(
                    min(self.backoff_base_s * (2 ** attempt), self.backoff_max_s)
                )
        raise LLMError(f"chat failed after {self.max_retries} retries: {last}")

    async def chat_stream(
        self,
        messages: List[Dict[str, str]],
        llm_config: Optional[LLMConfig] = None,
        temperature: float = 0.0,
    ) -> AsyncIterator[str]:
        """Streaming chat: yields content deltas (SSE parse)."""
        provider = self.select_provider(llm_config)
        body = {
            "model": (llm_config.model if llm_config and llm_config.model
                      else provider.model),
            "messages": messages,
            "temperature": (llm_config.temperature
                            if llm_config and llm_config.temperature is not None
                            else temperature),
            "stream": True,
        }
        headers = {"Content-Type": "application/json"}
        if provider.api_key:
            headers["Authorization"] = f"Bearer {provider.api_key}"
        async with post(
            f"{provider.url.rstrip('/')}/chat/completions", body, headers,
        ) as resp:
            if resp.status != 200:
                raise LLMError(
                    f"provider {provider.name} HTTP {resp.status}: "
                    f"{(await resp.text())[:300]}"
                )
            async for raw_line in resp.lines():
                line = raw_line.decode(errors="replace").strip()
                if not line.startswith("data:"):
                    continue
                payload = line[len("data:"):].strip()
                if payload == "[DONE]":
                    return
                try:
                    chunk = json.loads(payload)
                    delta = chunk["choices"][0].get("delta", {})
                    content = delta.get("content")
                    if content:
                        yield content
                except (json.JSONDecodeError, KeyError, IndexError):
                    continue

    # ------------------------------------------------------------------

    async def run_known_prompt(
        self,
        prompt_name: str,
        conversation: Optional[List[Dict[str, str]]] = None,
        variables: Optional[List[Tuple[str, str]]] = None,
        llm_config: Optional[LLMConfig] = None,
    ) -> str:
        system, user = format_prompt(prompt_name, variables or [])
        messages = [{"role": "system", "content": system}]
        messages.extend(conversation or [])
        messages.append({"role": "user", "content": user})
        msg = await self.chat(messages, llm_config)
        return msg.get("content") or ""

    async def run_known_prompt_stream(
        self,
        prompt_name: str,
        conversation: Optional[List[Dict[str, str]]] = None,
        variables: Optional[List[Tuple[str, str]]] = None,
        llm_config: Optional[LLMConfig] = None,
    ) -> AsyncIterator[str]:
        system, user = format_prompt(prompt_name, variables or [])
        messages = [{"role": "system", "content": system}]
        messages.extend(conversation or [])
        messages.append({"role": "user", "content": user})
        async for delta in self.chat_stream(messages, llm_config):
            yield delta

    # ------------------------------------------------------------------

    async def execute_tools(
        self,
        messages: List[Dict[str, str]],
        tools: List[Dict[str, Any]],
        llm_config: Optional[LLMConfig] = None,
    ) -> List[Dict[str, Any]]:
        """Function-calling round (llms.rs:483): returns tool_calls."""
        msg = await self.chat(messages, llm_config, tools=tools)
        return msg.get("tool_calls") or []


def parse_json_response(text: str) -> Any:
    """Tolerant JSON extraction from an LLM reply (strips fences/prose)."""
    text = text.strip()
    if text.startswith("```"):
        text = text.split("```", 2)[1]
        if text.startswith("json"):
            text = text[4:]
        text = text.strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    # find the first balanced {...} or [...]
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        if start < 0:
            continue
        depth = 0
        for i in range(start, len(text)):
            if text[i] == opener:
                depth += 1
            elif text[i] == closer:
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(text[start : i + 1])
                    except json.JSONDecodeError:
                        break
    raise ValueError(f"no JSON found in LLM reply: {text[:200]}")
