"""A scripted OpenAI-compatible LLM on the port's HTTP layer.

The port's copy of `tests/ai_mock.py`'s `MockLLMServer` (reference
utils.rs:164-236 create_ai_server_mock), served by
`server/transport.py` in place of `aiohttp.web`, so that it runs where
aiohttp is absent (`chip_smoke.py` answers RAG requests from it on the
card's machine). The same behaviour:

- `/v1/chat/completions` answers with the response of the first script
  entry whose substring appears in the request's messages (as JSON),
  else `default`;
- a `"stream": true` request gets that response word by word as SSE
  chunks (`data: {...}` each word with a space after it, then
  `data: [DONE]`);
- a response `TOOL_CALL <json>` to a request that carries `tools` comes
  back as the message's `tool_calls`;
- the first `fail_first` requests get HTTP 500;
- every request body is kept in `requests`, in arrival order.

    mock = MockLLMServer([("classify a search query", '{"mode": "vector"}')])
    await mock.start()          # 127.0.0.1, a free port
    ... LLMProviderConfig("mock", mock.url, "m") ...
    await mock.stop()
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..server import transport as web


class MockLLMServer:
    def __init__(self, script: List[Tuple[str, str]], default: str = "ok"):
        """script: list of (substring, response). The first entry whose
        substring appears in the rendered prompt wins."""
        self.script = script
        self.default = default
        self.requests: List[Dict[str, Any]] = []
        # transient-failure injection: the first N requests get HTTP 500
        self.fail_first = 0
        self.app = web.Application()
        self.app.router.add_post("/v1/chat/completions", self._handle)
        self.site: Optional[web.Site] = None
        self.port: Optional[int] = None

    def _response_for(self, body: Dict[str, Any]) -> str:
        text = json.dumps(body.get("messages", []))
        for needle, response in self.script:
            if needle in text:
                return response
        return self.default

    async def _handle(self, request: web.Request):
        body = await request.json()
        self.requests.append(body)
        if len(self.requests) <= self.fail_first:
            return web.json_response({"error": "overloaded"}, status=500)
        content = self._response_for(body)
        if body.get("stream"):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream"}
            )
            await resp.prepare(request)
            # stream word by word like a real provider
            for word in content.split(" "):
                chunk = {
                    "choices": [{"delta": {"content": word + " "}, "index": 0}]
                }
                await resp.write(f"data: {json.dumps(chunk)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
            return resp
        # scripted function calling: a response of "TOOL_CALL <json>"
        # returns tool_calls instead of content (requires body["tools"])
        if body.get("tools") and content.startswith("TOOL_CALL "):
            calls = json.loads(content[len("TOOL_CALL "):])
            return web.json_response(
                {
                    "choices": [
                        {
                            "index": 0,
                            "message": {
                                "role": "assistant",
                                "content": None,
                                "tool_calls": calls,
                            },
                            "finish_reason": "tool_calls",
                        }
                    ]
                }
            )
        return web.json_response(
            {
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": content},
                        "finish_reason": "stop",
                    }
                ]
            }
        )

    async def start(self) -> int:
        self.site = await web.serve(self.app, "127.0.0.1", 0)
        self.port = self.site.port
        return self.port

    async def stop(self):
        if self.site is not None:
            await self.site.close()
            self.site = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/v1"
