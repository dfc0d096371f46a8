"""AIService: wires LLM, state machines, hooks, tools, prompts to HTTP.

Covers the reference's AI endpoint behavior: answer/planned_answer SSE
(api/collection/answer.rs:23-36), generate/nlp_query SSE (generate.rs:
29-41), suggestions/title (ai/answer.rs:321,367), the OpenAI-compatible
chat endpoint (openai_chat/mod.rs:30-162: request→Interaction, AnswerEvent
→ OpenAI chunks), MCP JSON-RPC (mcp.rs:25-35), tools/system prompts/
training sets CRUD.

The port's copy of `oramacore_tpu/ai/service.py`, on the port's HTTP
layer (`server/transport.py`, which gives these handlers aiohttp's
names) in place of `aiohttp.web`. A client that drops an SSE answer
mid-stream ends it: any `ConnectionError` of a write (a reset or a
broken pipe) stops the stream.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, Dict, List, Optional

from ..server import transport as web

from ..config import OramacoreConfig
from ..types import Interaction, InteractionMessage
from .answer import AnswerStateMachine
from .autoquery import AdvancedAutoqueryStateMachine
from .hooks import HooksRuntime
from .llms import LLMConfig, LLMProviderConfig, LLMService, parse_json_response
from .mcp import MCPServer
from .system_prompts import SystemPromptsInterface
from .tools import ToolsRuntime
from .training_sets import TrainingSetsInterface


def build_llm_service(config: OramacoreConfig) -> Optional[LLMService]:
    local = None
    if config.ai.llm_host:
        port = f":{config.ai.llm_port}" if config.ai.llm_port else ""
        local = LLMProviderConfig(
            name="local",
            url=f"http://{config.ai.llm_host}{port}/v1",
            model=config.ai.llm_model,
            api_key=config.ai.llm_api_key,
            is_local=True,
        )
    remotes = [
        LLMProviderConfig(
            name=r.get("name", r.get("provider", "remote")),
            url=r["url"],
            model=r.get("model", ""),
            api_key=r.get("api_key", ""),
            is_local=False,
        )
        for r in config.ai.remote_llms
    ]
    if local is None and not remotes:
        return None
    return LLMService(local, remotes)


class AIService:
    def __init__(
        self,
        config: OramacoreConfig,
        write_side,
        read_side,
        llm: Optional[LLMService] = None,
    ):
        self.config = config
        self.write_side = write_side
        self.read_side = read_side
        self.llm = llm or build_llm_service(config)
        self.hooks_runtime = HooksRuntime(
            execution_timeout_s=config.hooks.execution_timeout_ms / 1000.0,
            allowed_domains=config.hooks.allowed_domains,
            deny_domains=config.hooks.deny_domains,
            allow_js=config.hooks.allow_js,
        )
        # LLM-driven automatic embedding-property selection on field
        # discovery (reference AutomaticEmbeddingsSelector,
        # write/index/mod.rs:589): attached as a sync callback — inserts
        # run on executor threads, so it performs a plain blocking HTTP
        # call to the configured provider
        if write_side is not None and self.llm is not None:
            write_side.embeddings_selector = self._embeddings_selector
        kv = read_side.kv if read_side else write_side.kv
        self.system_prompts = SystemPromptsInterface(kv, self.llm)
        self.tools = ToolsRuntime(kv, self.llm, self.hooks_runtime)
        self.training_sets = TrainingSetsInterface(kv, self.llm, read_side)
        self.mcp = MCPServer(read_side, self._autoquery_factory)
        # auto-mode resolver for the read side (token_score.rs:91-135)
        if read_side is not None and self.llm is not None:
            read_side.llm_resolve_mode = self._resolve_mode_sync
        # attach the sandboxed hook runtime to both sides
        if read_side is not None:
            read_side.hooks_runtime = self.hooks_runtime
        if write_side is not None:
            write_side.hooks_runtime = self.hooks_runtime

    # ------------------------------------------------------------------

    def _resolve_mode_sync(self, term: str) -> str:
        """Sync bridge for ReadSide auto-mode resolution, on the caller's
        executor thread: a fresh LLMService on a fresh event loop (the
        client holds nothing bound to a loop, but the shape is JAX's)."""
        try:
            svc = LLMService(self.llm.local, self.llm.remotes)
            loop = asyncio.new_event_loop()
            try:
                raw = loop.run_until_complete(
                    svc.run_known_prompt(
                        "autoquery", variables=[("query", term)]
                    )
                )
                loop.run_until_complete(svc.close())
            finally:
                loop.close()
            return parse_json_response(raw).get("mode", "fulltext")
        except Exception:  # noqa: BLE001
            return "fulltext"

    def _autoquery_factory(self, collection_id: str, read_key: Optional[str]):
        return AdvancedAutoqueryStateMachine(
            self.llm, self.read_side, collection_id, read_key,
            hooks_runtime=self.hooks_runtime,
        )

    def _answer_machine(self, collection_id: str, read_key: Optional[str]):
        if self.llm is None:
            raise web.HTTPServiceUnavailable(
                text=json.dumps({"error": "no LLM configured"})
            )
        return AnswerStateMachine(
            self.llm, self.read_side, collection_id, read_key,
            hooks_runtime=self.hooks_runtime,
            system_prompts=self.system_prompts,
        )

    def _check_read(self, collection_id: str, key: Optional[str]):
        return self.read_side.check_read_key(collection_id, key)

    # ------------------------------------------------------------------
    # SSE endpoints
    # ------------------------------------------------------------------

    async def answer_sse(
        self, request, collection_id: str, key: Optional[str],
        interaction: Interaction, planned: bool,
    ):
        self._check_read(collection_id, key)
        sm = self._answer_machine(collection_id, key)
        t0 = time.time()
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        # interaction analytics accumulator (reference AnalyticsHolder
        # analytics.rs:269): RAG steps, ttft, model info, answer text
        holder = self.read_side.analytics.interaction(
            collection_id, interaction.interaction_id,
            conversation_id=interaction.conversation_id,
            visitor_id=interaction.visitor_id,
            user_message=interaction.query,
            metadata=self.read_side.analytics.metadata_from_request(
                request.headers
            ),
        )
        provider = self.llm.select_provider(None) if self.llm else None
        if provider is not None:
            holder.set_llm_info(provider.name, provider.model)
        answer_parts: List[str] = []
        try:
            async for ev in sm.run_stream(interaction, planned=planned):
                et = ev.get("type")
                if et == "answer_token":
                    if not answer_parts:
                        holder.set_time_to_first_token()
                    answer_parts.append(ev.get("token", ""))
                elif et == "state_changed":
                    holder.add_rag_step(ev.get("state"))
                elif et == "related_queries":
                    holder.set_generated_related_queries(
                        json.dumps(ev.get("queries"))
                    )
                elif et == "error":
                    holder.set_error(str(ev.get("error")))
                await resp.write(f"data: {json.dumps(ev)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
        except ConnectionError:
            pass
        finally:
            try:
                holder.set_assistant_response("".join(answer_parts))
                if interaction.system_prompt_id:
                    holder.set_system_prompt_id(interaction.system_prompt_id)
                holder.finish()
            except Exception:  # noqa: BLE001
                pass
        return resp

    async def nlp_query_sse(
        self, request, collection_id: str, key: Optional[str],
        body: Dict[str, Any],
    ):
        self._check_read(collection_id, key)
        if self.llm is None:
            raise web.HTTPServiceUnavailable(
                text=json.dumps({"error": "no LLM configured"})
            )
        query = body.get("query", body.get("messages", [{}])[-1].get("content", "")
                         if body.get("messages") else "")
        sm = self._autoquery_factory(collection_id, key)
        llm_config = None
        if body.get("llm_config"):
            lc = body["llm_config"]
            llm_config = LLMConfig(
                provider=lc.get("provider"), model=lc.get("model"),
                temperature=lc.get("temperature"),
            )
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        try:
            async for ev in sm.run_stream(query, None, llm_config):
                await resp.write(f"data: {json.dumps(ev)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
        except ConnectionError:
            pass
        return resp

    # ------------------------------------------------------------------
    # Simple JSON endpoints
    # ------------------------------------------------------------------

    async def suggestions(
        self, collection_id: str, key: Optional[str], body: Dict[str, Any]
    ) -> Dict[str, Any]:
        self._check_read(collection_id, key)
        conversation = json.dumps(body.get("messages", []))
        raw = await self.llm.run_known_prompt(
            "suggestions",
            variables=[
                ("conversation", conversation),
                ("count", str(body.get("count", 3))),
            ],
        )
        try:
            return {"suggestions": parse_json_response(raw)}
        except ValueError:
            return {"suggestions": [s.strip("-• ") for s in raw.splitlines() if s.strip()]}

    async def title(
        self, collection_id: str, key: Optional[str], body: Dict[str, Any]
    ) -> Dict[str, Any]:
        self._check_read(collection_id, key)
        conversation = json.dumps(body.get("messages", []))
        raw = await self.llm.run_known_prompt(
            "title_generator", variables=[("conversation", conversation)]
        )
        return {"title": raw.strip().strip('"')}

    async def default_system_prompt(
        self, collection_id: str, key: Optional[str]
    ) -> Dict[str, Any]:
        self._check_read(collection_id, key)
        p = self.system_prompts.select_for_interaction(collection_id, None)
        return {"system_prompt": p}

    # ------------------------------------------------------------------
    # OpenAI-compatible chat (openai_chat/mod.rs:30-162)
    # ------------------------------------------------------------------

    def _embeddings_selector(self, sample_doc: Dict[str, Any]):
        """Blocking LLM call choosing which properties to embed (runs on
        the write side's executor thread, never on the event loop)."""
        import urllib.request

        from .llms import parse_json_response
        from .prompts import format_prompt

        provider = self.llm.select_provider(None)
        system, user = format_prompt(
            "automatic_embeddings_selector",
            [("document", json.dumps(sample_doc)[:4000])],
        )
        body = {
            "model": provider.model,
            "messages": [
                {"role": "system", "content": system},
                {"role": "user", "content": user},
            ],
            "temperature": 0,
        }
        headers = {"Content-Type": "application/json"}
        if provider.api_key:
            headers["Authorization"] = f"Bearer {provider.api_key}"
        req = urllib.request.Request(
            provider.url.rstrip("/") + "/chat/completions",
            data=json.dumps(body).encode(),
            headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=15) as resp:
            data = json.loads(resp.read())
        content = data["choices"][0]["message"]["content"]
        out = parse_json_response(content)
        return out.get("properties") or []

    @staticmethod
    def _estimate_tokens(text: str) -> int:
        """Usage accounting without the provider's tokenizer: ~4 chars per
        token is the standard BPE estimate for English-like text."""
        return max(1, (len(text) + 3) // 4) if text else 0

    def _usage_for(self, messages, completion: str) -> Dict[str, int]:
        prompt = sum(
            self._estimate_tokens(str(m.get("content") or "")) + 4
            for m in messages
        )
        comp = self._estimate_tokens(completion)
        return {
            "prompt_tokens": prompt,
            "completion_tokens": comp,
            "total_tokens": prompt + comp,
        }

    def _parse_provider_model(self, model_str) -> Optional[Dict[str, str]]:
        """OpenAI 'provider/model' routing (conversions.rs:260-273): a
        bare model string (no provider prefix) or an unknown provider
        means NO override — the default provider answers."""
        if not model_str or "/" not in model_str:
            return None
        prov, _, name = model_str.partition("/")
        known = {
            p.name for p in [self.llm.local, *self.llm.remotes] if p
        }
        if prov not in known:
            return None
        return {"provider": prov, "model": name}

    async def openai_chat(
        self, request, collection_id: str, key: Optional[str],
        body: Dict[str, Any],
    ):
        self._check_read(collection_id, key)
        messages = body.get("messages", [])
        user_msgs = [m for m in messages if m.get("role") == "user"]
        if not user_msgs:
            # conversions.rs:144 — the conversion is an error, not an
            # empty query
            return web.json_response(
                {"error": {
                    "message": "No user message found in messages array",
                    "type": "invalid_request_error",
                }},
                status=400,
            )
        query = user_msgs[-1]["content"]
        interaction = Interaction(
            interaction_id=str(uuid.uuid4()),
            query=query,
            messages=[
                # tool-role messages fold into the conversation as user
                # context (reference conversions.rs:250)
                InteractionMessage(
                    "user" if m.get("role") == "tool" else m.get("role", "user"),
                    str(m.get("content") or ""),
                )
                for m in messages[:-1]
            ],
            llm_config=self._parse_provider_model(body.get("model")),
        )
        sm = self._answer_machine(collection_id, key)
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = body.get("model", "oramacore_tpu")

        # OpenAI function calling: when the caller supplies tools, give
        # the LLM the tool-selection round; tool_calls short-circuit the
        # RAG flow (the caller executes tools and calls back)
        if body.get("tools"):
            llm_config = None
            pm = self._parse_provider_model(body.get("model"))
            if pm:
                from .llms import LLMConfig

                llm_config = LLMConfig(
                    provider=pm["provider"], model=pm["model"]
                )
            try:
                msg = await self.llm.chat(
                    messages, llm_config, tools=body["tools"]
                )
            except Exception as e:  # noqa: BLE001
                return web.json_response(
                    {"error": {"message": str(e), "type": "server_error"}},
                    status=502,
                )
            tool_calls = msg.get("tool_calls")
            if tool_calls:
                usage = self._usage_for(
                    messages, json.dumps(tool_calls)
                )
                payload = {
                    "id": completion_id,
                    "object": "chat.completion",
                    "created": created,
                    "model": model,
                    "choices": [{
                        "index": 0,
                        "message": {
                            "role": "assistant",
                            "content": msg.get("content"),
                            "tool_calls": tool_calls,
                        },
                        "finish_reason": "tool_calls",
                    }],
                    "usage": usage,
                }
                if body.get("stream"):
                    resp = web.StreamResponse(headers={
                        "Content-Type": "text/event-stream",
                        "Cache-Control": "no-cache",
                    })
                    await resp.prepare(request)
                    chunk = {
                        "id": completion_id,
                        "object": "chat.completion.chunk",
                        "created": created,
                        "model": model,
                        "choices": [{
                            "index": 0,
                            "delta": {
                                "role": "assistant",
                                "tool_calls": [
                                    dict(tc, index=i)
                                    for i, tc in enumerate(tool_calls)
                                ],
                            },
                            "finish_reason": None,
                        }],
                    }
                    fin = dict(chunk)
                    fin["choices"] = [{
                        "index": 0, "delta": {},
                        "finish_reason": "tool_calls",
                    }]
                    await resp.write(
                        f"data: {json.dumps(chunk)}\n\n".encode()
                    )
                    await resp.write(f"data: {json.dumps(fin)}\n\n".encode())
                    await resp.write(b"data: [DONE]\n\n")
                    return resp
                return web.json_response(payload)
            # no tool chosen: fall through to the RAG answer flow

        if body.get("stream"):
            resp = web.StreamResponse(
                headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache",
                }
            )
            await resp.prepare(request)

            def chunk(delta: Dict[str, Any], finish: Optional[str] = None):
                return {
                    "id": completion_id,
                    "object": "chat.completion.chunk",
                    "created": created,
                    "model": model,
                    "choices": [
                        {"index": 0, "delta": delta, "finish_reason": finish}
                    ],
                }

            try:
                await resp.write(
                    f"data: {json.dumps(chunk({'role': 'assistant'}))}\n\n".encode()
                )
                answer_parts: List[str] = []
                async for ev in sm.run_stream(interaction):
                    if ev["type"] == "answer_token":
                        answer_parts.append(ev["token"])
                        await resp.write(
                            f"data: {json.dumps(chunk({'content': ev['token']}))}\n\n".encode()
                        )
                await resp.write(
                    f"data: {json.dumps(chunk({}, finish='stop'))}\n\n".encode()
                )
                # usage chunk per the OpenAI stream_options spec
                if (body.get("stream_options") or {}).get("include_usage"):
                    usage_chunk = {
                        "id": completion_id,
                        "object": "chat.completion.chunk",
                        "created": created,
                        "model": model,
                        "choices": [],
                        "usage": self._usage_for(
                            messages, "".join(answer_parts)
                        ),
                    }
                    await resp.write(
                        f"data: {json.dumps(usage_chunk)}\n\n".encode()
                    )
                await resp.write(b"data: [DONE]\n\n")
            except ConnectionError:
                pass
            return resp

        answer, results, _ = await sm.run(interaction)
        return web.json_response(
            {
                "id": completion_id,
                "object": "chat.completion",
                "created": created,
                "model": model,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": answer},
                        "finish_reason": "stop",
                    }
                ],
                "usage": self._usage_for(messages, answer or ""),
            }
        )

    # ------------------------------------------------------------------
    # MCP / tools / system prompts / training sets
    # ------------------------------------------------------------------

    async def mcp_request(
        self, collection_id: str, key: Optional[str], body: Dict[str, Any]
    ) -> Dict[str, Any]:
        self._check_read(collection_id, key)
        return await self.mcp.handle(collection_id, key, body)

    async def tools_action(
        self, collection_id: str, key: Optional[str], action: str,
        body: Dict[str, Any],
    ) -> Any:
        if action in ("insert", "delete", "update"):
            self.write_side.check_write_key(collection_id, key)
        else:
            self._check_read(collection_id, key)
        if action == "insert":
            self.tools.insert(collection_id, body)
            return {"status": "ok"}
        if action == "update":
            self.tools.update(collection_id, body)
            return {"status": "ok"}
        if action == "delete":
            self.tools.delete(collection_id, body.get("id"))
            return {"status": "ok"}
        if action == "get":
            return {"tool": self.tools.get(collection_id, body.get("id"))}
        if action == "all":
            return {"tools": self.tools.list(collection_id)}
        if action == "run":
            calls = await self.tools.execute_tools(
                collection_id,
                body.get("messages", []),
                body.get("tool_ids"),
            )
            return {"results": calls}
        raise web.HTTPNotFound()

    async def system_prompts_action(
        self, collection_id: str, key: Optional[str], action: str,
        body: Dict[str, Any],
    ) -> Any:
        if action in ("insert", "delete", "update"):
            self.write_side.check_write_key(collection_id, key)
        else:
            self._check_read(collection_id, key)
        if action == "insert":
            self.system_prompts.insert(collection_id, body)
            return {"status": "ok"}
        if action == "update":
            self.system_prompts.update(collection_id, body)
            return {"status": "ok"}
        if action == "delete":
            self.system_prompts.delete(collection_id, body.get("id"))
            return {"status": "ok"}
        if action == "get":
            return {
                "system_prompt": self.system_prompts.get(
                    collection_id, body.get("id")
                )
            }
        if action == "all":
            return {"system_prompts": self.system_prompts.list(collection_id)}
        if action == "validate":
            return await self.system_prompts.validate(body)
        raise web.HTTPNotFound()

    async def training_sets_action(
        self, collection_id: str, key: Optional[str], set_name: str,
        action: str, body: Dict[str, Any],
    ) -> Any:
        if action in ("insert", "delete", "generate"):
            self.write_side.check_write_key(collection_id, key)
        else:
            self._check_read(collection_id, key)
        if action == "generate":
            data = await self.training_sets.generate(
                collection_id, set_name, body.get("count", 20), key
            )
            return {"data": data}
        if action == "get":
            return {"data": self.training_sets.get(collection_id, set_name)}
        if action == "insert":
            self.training_sets.insert(collection_id, set_name, body.get("data", []))
            return {"status": "ok"}
        if action == "delete":
            self.training_sets.delete(collection_id, set_name)
            return {"status": "ok"}
        raise web.HTTPNotFound()
