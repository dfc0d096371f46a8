"""HTTP API server — the axum WebServer equivalent.

Reference: src/web_server/ — router assembly (api/mod.rs:28-41), per-domain
routers (api/collection/*.rs), auth extractors (api/util.rs:51-246:
Bearer header or ?api-key= query param, JWT bearer detection).

Endpoint surface mirrors SURVEY §2.8. The engine (WriteSide/ReadSide) is
synchronous; handlers run it in the default executor so the event loop
stays free for SSE streams.

The port's copy of `oramacore_tpu/server/__init__.py`: the same routes,
handlers, statuses and bodies, served by the port's own HTTP/1.1 layer
on asyncio streams (`transport.py`, which gives the handlers aiohttp's
names) in place of `aiohttp.web`. `python -m oramacore_tpu_torch.server
--config <yaml>` runs it on the card (`--device cpu` for tests; without
a card the default exits non-zero). `main()` builds the AI service
(`ai/service.AIService`: answers, chat, MCP, tools, system prompts,
training sets) as the JAX server's does; an `ApiServer` made without one
answers the AI routes 503, as the JAX server does.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import Any, Dict, Optional

from . import transport as web

from ..config import OramacoreConfig
from ..metrics import HTTP_REQUESTS, REGISTRY, SEARCH_CALCULATION_TIME
from ..read import ReadError, ReadSide
from ..types import Interaction, SearchParams
from ..write import WriteError, WriteSide


def _error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def extract_api_key(request: web.Request) -> Optional[str]:
    """`?api-key=` (takes precedence) or Bearer header (reference
    api/util.rs:180-220). Plain (non-JWT) keys are capped at 64 chars
    (types.rs:549 ApiKey = StackString<64>); JWTs are exempt — they are
    validated by the JWT manager downstream."""
    key = request.query.get("api-key")
    if key is None:
        auth = request.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            key = auth[len("Bearer "):].strip()
    if key is not None and len(key) > 64:
        from ..auth import JwtManager

        if not JwtManager.looks_like_jwt(key):
            raise web.HTTPUnauthorized(
                text=json.dumps(
                    {"message": "Invalid API key: too long. Max 64 char"}
                ),
                content_type="application/json",
            )
    return key


class ApiServer:
    def __init__(
        self,
        config: OramacoreConfig,
        write_side: Optional[WriteSide],
        read_side: Optional[ReadSide],
        ai_service=None,  # ai.service.AIService, wired when AI configured
    ):
        self.config = config
        self.write_side = write_side
        self.read_side = read_side
        self.ai = ai_service
        self.app = web.Application()
        self._started_at = time.time()
        self._register_routes()

    # ------------------------------------------------------------------

    def _register_routes(self):
        r = self.app.router
        r.add_get("/", self.handle_root)
        r.add_get("/health", self.handle_health)
        r.add_get("/metrics", self.handle_metrics)

        # admin (writer) — admin.rs:23-58
        r.add_get("/v1/collections", self.h_list_collections)
        r.add_post("/v1/collections/create", self.h_create_collection)
        # reference semantics: POST /v1/collections/list lists the
        # DOCUMENTS of a collection (write-key auth, body {id,
        # index_ids}) — admin.rs:27 list_document_in_collection
        r.add_post("/v1/collections/list", self.h_list_documents)
        # reference shape: the collection id rides the body
        r.add_post("/v1/collections/delete", self.h_delete_collection_body)
        r.add_get("/v1/collections/{c}", self.h_get_collection)
        r.add_post("/v1/collections/{c}/delete", self.h_delete_collection)
        r.add_post("/v1/collections/{c}/indexes/create", self.h_create_index)
        r.add_post("/v1/collections/{c}/indexes/delete", self.h_delete_index)
        r.add_post("/v1/collections/{c}/indexes/{i}/insert", self.h_insert)
        r.add_post(
            "/v1/collections/{c}/indexes/{i}/documents/upsert", self.h_upsert
        )
        r.add_post("/v1/collections/{c}/indexes/{i}/delete", self.h_delete_docs)
        r.add_post("/v1/collections/{c}/reindex", self.h_reindex)
        r.add_post(
            "/v1/collections/{c}/indexes/{i}/create-temporary-index",
            self.h_create_temp_index,
        )
        r.add_post("/v1/collections/{c}/replace-index", self.h_replace_index)
        r.add_post(
            "/v1/collections/{c}/regenerate-read-api-key", self.h_regen_read_key
        )

        # search (reader) — search.rs:25-32
        r.add_post("/v1/collections/{c}/search", self.h_search)
        r.add_post("/v1/collections/{c}/search/batch", self.h_search_batch)
        r.add_post("/v1/collections/{c}/stats", self.h_stats)
        r.add_get("/v1/collections/{c}/stats", self.h_stats)
        r.add_post("/v1/collections/{c}/filterable_fields", self.h_filterable)
        r.add_get("/v1/collections/{c}/filterable_fields", self.h_filterable)
        r.add_post("/v1/collections/{c}/documents/batch-get", self.h_batch_get)

        # hooks — hooks.rs:21-29
        r.add_post("/v1/collections/{c}/hooks/set", self.h_hook_set)
        r.add_post("/v1/collections/{c}/hooks/delete", self.h_hook_delete)
        r.add_get("/v1/collections/{c}/hooks/list", self.h_hook_list)
        r.add_post("/v1/collections/{c}/hooks/list", self.h_hook_list)

        # merchandising — pin_rules.rs:24-41, shelves.rs:29-46
        r.add_post(
            "/v1/collections/{c}/merchandising/pin_rules/insert",
            self.h_pin_rule_insert,
        )
        r.add_post(
            "/v1/collections/{c}/merchandising/pin_rules/delete",
            self.h_pin_rule_delete,
        )
        r.add_get(
            "/v1/collections/{c}/merchandising/pin_rules/list",
            self.h_pin_rule_list,
        )
        r.add_get(
            "/v1/collections/{c}/merchandising/pin_rules/ids",
            self.h_pin_rule_ids,
        )
        r.add_post(
            "/v1/collections/{c}/merchandising/shelves/insert",
            self.h_shelf_insert,
        )
        r.add_get(
            "/v1/collections/{c}/merchandising/shelves/list", self.h_shelf_list
        )
        r.add_get(
            "/v1/collections/{c}/merchandising/shelves/{id}/get",
            self.h_shelf_get,
        )
        r.add_post(
            "/v1/collections/{c}/merchandising/shelves/{id}/delete",
            self.h_shelf_delete,
        )

        # values — values.rs:20-32
        r.add_post("/v1/collections/{c}/values/set", self.h_value_set)
        r.add_post("/v1/collections/{c}/values/delete", self.h_value_delete)
        r.add_get("/v1/collections/{c}/values/get/{key}", self.h_value_get)
        r.add_get("/v1/collections/{c}/values/list", self.h_value_list)

        # actions — actions.rs:20
        r.add_post("/v1/collections/{c}/actions/execute", self.h_action_execute)
        # reference path shape (actions.rs:20 — no /collections prefix)
        r.add_post("/v1/{c}/actions/execute", self.h_action_execute)

        # analytics — analytics.rs:9
        r.add_get("/v1/analytics", self.h_analytics)

        # AI routes (answer.rs:23-36, generate.rs:29-41, tools.rs:31-56,
        # system_prompts.rs:37-62, training_sets.rs:29-46,
        # openai_chat/mod.rs:162, mcp.rs:25-35)
        r.add_post("/v1/collections/{c}/answer", self.h_answer)
        r.add_post("/v1/collections/{c}/planned_answer", self.h_planned_answer)
        r.add_post("/v1/collections/{c}/suggestions", self.h_suggestions)
        r.add_post("/v1/collections/{c}/title", self.h_title)
        r.add_get("/v1/collections/{c}/logs", self.h_hook_logs)
        r.add_post("/v1/collections/{c}/generate/nlp_query", self.h_nlp_query)
        r.add_post(
            "/v1/collections/{c}/generate/nlp_query/v1.1", self.h_nlp_query
        )
        r.add_post("/v1/collections/{c}/generate/answer", self.h_answer)
        r.add_post(
            "/v1/collections/{c}/generate/get_default_system_prompt",
            self.h_default_system_prompt,
        )
        r.add_post("/v1/{c}/openai/chat/completions", self.h_openai_chat)
        r.add_post("/v1/collections/{c}/mcp", self.h_mcp)
        r.add_put("/v1/collections/{c}/mcp/update", self.h_mcp_update)
        for action in ("get", "all", "run", "insert", "delete", "update"):
            r.add_post(f"/v1/collections/{{c}}/tools/{action}",
                       self._tool_handler(action))
        for action in ("get", "all", "insert", "delete", "update", "validate"):
            r.add_post(f"/v1/collections/{{c}}/system_prompts/{action}",
                       self._system_prompt_handler(action))
        for action in ("generate", "get", "insert", "delete"):
            r.add_post(f"/v1/collections/{{c}}/training_sets/{{set}}/{action}",
                       self._training_set_handler(action))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    async def _json(self, request: web.Request) -> Dict[str, Any]:
        try:
            return await request.json()
        except Exception as e:  # noqa: BLE001
            raise web.HTTPBadRequest(text=json.dumps({"error": f"invalid JSON: {e}"}))

    async def _run(self, fn, *args, **kwargs):
        """Run sync engine code off the event loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(*args, **kwargs))

    def _writer(self) -> WriteSide:
        if self.write_side is None:
            raise web.HTTPServiceUnavailable(
                text=json.dumps({"error": "write side not enabled on this node"}),
                content_type="application/json",
            )
        return self.write_side

    def _reader(self) -> ReadSide:
        if self.read_side is None:
            raise web.HTTPServiceUnavailable(
                text=json.dumps({"error": "read side not enabled on this node"}),
                content_type="application/json",
            )
        return self.read_side

    @staticmethod
    def _wrap(fn):
        async def inner(self, request: web.Request):
            HTTP_REQUESTS.inc({"path": request.route or "?"})
            try:
                return await fn(self, request)
            except (WriteError, ReadError) as e:
                return _error(getattr(e, "status", 400), str(e))
            except web.HTTPException:
                raise
            except Exception as e:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                return _error(500, f"internal error: {e}")

        return inner

    # ------------------------------------------------------------------
    # base handlers
    # ------------------------------------------------------------------

    async def handle_root(self, request):
        info = {
            "service": "oramacore_tpu",
            "uptime_s": time.time() - self._started_at,
            "role": self.config.role,
        }
        if self.read_side is not None:
            # replication lag visibility for reader fleets
            info["reader"] = {
                "live_offset": self.read_side.live_offset,
                "committed_offset": self.read_side.committed_offset,
                "collections": len(self.read_side.collections),
            }
        if self.write_side is not None:
            info["writer"] = {
                "sent_offset": self.write_side.op_sender.offset,
                "collections": len(self.write_side.collections),
            }
        return web.json_response(info)

    async def handle_health(self, request):
        return web.Response(text="OK")

    async def handle_metrics(self, request):
        return web.Response(text=REGISTRY.expose(), content_type="text/plain")

    # -- admin -----------------------------------------------------------

    @_wrap
    async def h_create_collection(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        coll = await self._run(
            self._writer().create_collection,
            key,
            body.get("id"),
            read_api_key=body.get("read_api_key"),
            write_api_key=body.get("write_api_key"),
            description=body.get("description"),
            language=body.get("language"),
            embedding_model=(body.get("embeddings_model") or body.get("embeddings")
                             or {}).get("model")
            if isinstance(body.get("embeddings_model") or body.get("embeddings"), dict)
            else body.get("embeddings_model"),
            mcp_description=body.get("mcp_description"),
        )
        return web.json_response(
            {
                "id": coll.collection_id,
                "read_api_key": coll.read_api_key,
                "write_api_key": coll.write_api_key,
            },
            status=201,
        )

    @_wrap
    async def h_list_collections(self, request):
        key = extract_api_key(request)
        out = await self._run(self._writer().list_collections, key)
        return web.json_response(out)

    @_wrap
    async def h_get_collection(self, request):
        key = extract_api_key(request)
        writer = self._writer()
        writer.check_master_key(key)
        coll = writer.collections.get(request.match_info["c"])
        if coll is None:
            return _error(404, "collection not found")
        return web.json_response(writer.collection_stats(coll))

    @_wrap
    async def h_delete_collection(self, request):
        key = extract_api_key(request)
        ok = await self._run(
            self._writer().delete_collection, key, request.match_info["c"]
        )
        return web.json_response({"deleted": bool(ok)})

    @_wrap
    async def h_delete_collection_body(self, request):
        """Reference shape (admin.rs:93): the collection id rides the
        body as {\"id\": ...}."""
        body = await self._json(request)
        key = extract_api_key(request)
        cid = body.get("id")
        if not cid:
            return _error(400, "missing collection id")
        ok = await self._run(self._writer().delete_collection, key, cid)
        return web.json_response({"deleted": bool(ok)})

    @_wrap
    async def h_list_documents(self, request):
        """Reference admin.rs:105 list_document_in_collection: write-key
        auth, body {id, index_ids?} -> every document."""
        body = await self._json(request)
        key = extract_api_key(request)
        cid = body.get("id")
        if not cid:
            return _error(400, "missing collection id")
        docs = await self._run(
            self._writer().list_documents, cid, key,
            body.get("index_ids"),
        )
        return web.json_response(docs)

    @_wrap
    async def h_create_index(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        emb = body.get("embeddings") or {}
        idx = await self._run(
            self._writer().create_index,
            request.match_info["c"], key, body.get("id"),
            embedding_model=emb.get("model") if isinstance(emb, dict) else None,
            embedding_fields=emb.get("document_fields") if isinstance(emb, dict) else None,
            field_params=body.get("field_params"),
            phrase=body.get("phrase", True),
        )
        return web.json_response({"id": idx.index_id}, status=201)

    @_wrap
    async def h_delete_index(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        ok = await self._run(
            self._writer().delete_index,
            request.match_info["c"], key, body.get("id"),
        )
        return web.json_response({"deleted": bool(ok)})

    @_wrap
    async def h_insert(self, request):
        body = await self._json(request)
        docs = body if isinstance(body, list) else body.get("documents", [body])
        key = extract_api_key(request)
        t0 = time.perf_counter()
        stats = await self._run(
            self._writer().insert_documents,
            request.match_info["c"], request.match_info["i"], key, docs,
        )
        from ..metrics import DOCUMENTS_INSERTION_TIME

        DOCUMENTS_INSERTION_TIME.observe(time.perf_counter() - t0)
        return web.json_response(stats.to_json())

    @_wrap
    async def h_upsert(self, request):
        body = await self._json(request)
        docs = body if isinstance(body, list) else body.get("documents", [body])
        key = extract_api_key(request)
        stats = await self._run(
            self._writer().update_documents,
            request.match_info["c"], request.match_info["i"], key, docs,
        )
        return web.json_response(stats.to_json())

    @_wrap
    async def h_delete_docs(self, request):
        body = await self._json(request)
        ids = body if isinstance(body, list) else body.get(
            "documents", body.get("document_ids", [])
        )
        key = extract_api_key(request)
        n = await self._run(
            self._writer().delete_documents,
            request.match_info["c"], request.match_info["i"], key, ids,
        )
        return web.json_response({"deleted": n})

    @_wrap
    async def h_reindex(self, request):
        body = await self._json(request) if request.can_read_body else {}
        key = extract_api_key(request)
        await self._run(
            self._writer().reindex,
            request.match_info["c"], key,
            language=body.get("language"),
            embedding_model=body.get("embedding_model"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_create_temp_index(self, request):
        body = await self._json(request) if request.can_read_body else {}
        key = extract_api_key(request)
        idx = await self._run(
            self._writer().create_temporary_index,
            request.match_info["c"], key, request.match_info["i"],
            body.get("id"),
        )
        return web.json_response({"id": idx.index_id}, status=201)

    @_wrap
    async def h_replace_index(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().replace_index,
            request.match_info["c"], key,
            body.get("target_index_id") or body.get("runtime_index_id"),
            body.get("temporary_index_id") or body.get("temp_index_id"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_regen_read_key(self, request):
        key = extract_api_key(request)
        new_key = await self._run(
            self._writer().regenerate_read_api_key, request.match_info["c"], key
        )
        return web.json_response({"read_api_key": new_key})

    # -- search -----------------------------------------------------------

    @_wrap
    async def h_search(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        params = SearchParams.from_json(body)
        t0 = time.perf_counter()
        result = await self._run(
            self._reader().search, request.match_info["c"], key, params
        )
        SEARCH_CALCULATION_TIME.observe(
            time.perf_counter() - t0,
            {
                "collection": request.match_info["c"],
                "mode": params.mode_str,
                "has_filter": str(not params.where.is_empty()).lower(),
                "has_facet": str(bool(params.facets)).lower(),
            },
        )
        return web.json_response(result.to_json())

    @_wrap
    async def h_search_batch(self, request):
        """Batched search: {"searches": [<params>...]} → {"results": [...]}.
        TPU-native extension: homogeneous fulltext batches run in one
        device pass with term-deduplicated shared scoring."""
        body = await self._json(request)
        raw = body.get("searches", body if isinstance(body, list) else [])
        key = extract_api_key(request)
        params = [SearchParams.from_json(x) for x in raw]
        results = await self._run(
            self._reader().search_batch, request.match_info["c"], key, params
        )
        return web.json_response({"results": [r.to_json() for r in results]})

    @_wrap
    async def h_stats(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._reader().collection_stats, request.match_info["c"], key
        )
        return web.json_response(out)

    @_wrap
    async def h_filterable(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._reader().filterable_fields, request.match_info["c"], key
        )
        return web.json_response(out)

    @_wrap
    async def h_batch_get(self, request):
        body = await self._json(request)
        ids = body if isinstance(body, list) else body.get("ids", [])
        # reference types.rs:707 BatchGetDocumentsRequest::validate
        if len(ids) > 1000:
            return web.json_response(
                {"error": f"Too many document IDs. Maximum is 1000, got {len(ids)}"},
                status=400,
            )
        key = extract_api_key(request)
        out = await self._run(
            self._reader().batch_get_documents, request.match_info["c"], key, ids
        )
        # flattened map keyed by user doc id (reference types.rs:721
        # BatchGetDocumentsResponse serde(flatten))
        return web.json_response(out)

    # -- hooks --------------------------------------------------------------

    @_wrap
    async def h_hook_set(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().set_hook,
            request.match_info["c"], key,
            body.get("name", body.get("id")), body.get("code"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_hook_delete(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().delete_hook,
            request.match_info["c"], key, body.get("name", body.get("id")),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_hook_list(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._writer().list_hooks, request.match_info["c"], key
        )
        return web.json_response(out)

    @_wrap
    async def h_hook_logs(self, request):
        """SSE stream of hook stdout/stderr (reference sides/logs.rs)."""
        key = extract_api_key(request)
        reader = self._reader()
        coll = reader.check_read_key(request.match_info["c"], key)
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)
        if self.ai is not None and hasattr(self.ai, "hooks_runtime"):
            queue = self.ai.hooks_runtime.subscribe_logs(coll.collection_id)
            try:
                while True:
                    try:
                        line = await asyncio.wait_for(queue.get(), timeout=30)
                        await resp.write(
                            f"data: {json.dumps(line)}\n\n".encode()
                        )
                    except asyncio.TimeoutError:
                        await resp.write(b": keepalive\n\n")
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                self.ai.hooks_runtime.unsubscribe_logs(
                    coll.collection_id, queue
                )
        else:
            await resp.write(b": no hooks runtime\n\n")
        return resp

    # -- merchandising -------------------------------------------------------

    @_wrap
    async def h_pin_rule_insert(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().insert_pin_rule, request.match_info["c"], key, body
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_pin_rule_delete(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().delete_pin_rule,
            request.match_info["c"], key, body.get("id"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_pin_rule_list(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._writer().list_pin_rules, request.match_info["c"], key
        )
        return web.json_response(out)

    @_wrap
    async def h_pin_rule_ids(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._writer().list_pin_rules, request.match_info["c"], key
        )
        return web.json_response([r["id"] for r in out])

    @_wrap
    async def h_shelf_insert(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().insert_shelf, request.match_info["c"], key, body
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_shelf_list(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._writer().list_shelves, request.match_info["c"], key
        )
        return web.json_response(out)

    @_wrap
    async def h_shelf_get(self, request):
        key = extract_api_key(request)
        shelves = await self._run(
            self._writer().list_shelves, request.match_info["c"], key
        )
        for s in shelves:
            if s["id"] == request.match_info["id"]:
                return web.json_response(s)
        return _error(404, "shelf not found")

    @_wrap
    async def h_shelf_delete(self, request):
        key = extract_api_key(request)
        await self._run(
            self._writer().delete_shelf,
            request.match_info["c"], key, request.match_info["id"],
        )
        return web.json_response({"status": "ok"})

    # -- values ---------------------------------------------------------------

    @_wrap
    async def h_value_set(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().set_value,
            request.match_info["c"], key, body.get("key"), body.get("value"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_value_delete(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        await self._run(
            self._writer().delete_value,
            request.match_info["c"], key, body.get("key"),
        )
        return web.json_response({"status": "ok"})

    @_wrap
    async def h_value_get(self, request):
        key = extract_api_key(request)
        values = await self._run(
            self._writer().list_values, request.match_info["c"], key
        )
        k = request.match_info["key"]
        if k not in values:
            return _error(404, "value not found")
        return web.json_response({"key": k, "value": values[k]})

    @_wrap
    async def h_value_list(self, request):
        key = extract_api_key(request)
        out = await self._run(
            self._writer().list_values, request.match_info["c"], key
        )
        return web.json_response(out)

    # -- actions / analytics ----------------------------------------------------

    @_wrap
    async def h_action_execute(self, request):
        """POST /v1/{c}/actions/execute with name=Search (actions.rs:20)."""
        body = await self._json(request)
        key = extract_api_key(request)
        name = body.get("name")
        if name != "Search":
            return _error(400, f"unknown action {name!r}")
        ctx = body.get("context")
        params = SearchParams.from_json(
            json.loads(ctx) if isinstance(ctx, str) else (ctx or {})
        )
        result = await self._run(
            self._reader().search, request.match_info["c"], key, params
        )
        return web.json_response(result.to_json())

    @_wrap
    async def h_analytics(self, request):
        """Claim-gated export-and-erase (reference analytics.rs:51)."""
        key = extract_api_key(request)
        reader = self._reader()
        if key != self.config.auth.master_api_key:
            return _error(401, "invalid api key")
        events = await self._run(reader.analytics.get_and_erase)
        return web.json_response({"events": events})

    # -- AI routes ---------------------------------------------------------------

    def _require_ai(self):
        if self.ai is None:
            raise web.HTTPServiceUnavailable(
                text=json.dumps({"error": "AI service not configured"})
            )
        return self.ai

    @_wrap
    async def h_answer(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        interaction = Interaction.from_json(body.get("interaction", body))
        return await ai.answer_sse(
            request, request.match_info["c"], key, interaction, planned=False
        )

    @_wrap
    async def h_planned_answer(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        interaction = Interaction.from_json(body.get("interaction", body))
        return await ai.answer_sse(
            request, request.match_info["c"], key, interaction, planned=True
        )

    @_wrap
    async def h_suggestions(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        out = await ai.suggestions(request.match_info["c"], key, body)
        return web.json_response(out)

    @_wrap
    async def h_title(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        out = await ai.title(request.match_info["c"], key, body)
        return web.json_response(out)

    @_wrap
    async def h_nlp_query(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        return await ai.nlp_query_sse(
            request, request.match_info["c"], key, body
        )

    @_wrap
    async def h_default_system_prompt(self, request):
        ai = self._require_ai()
        key = extract_api_key(request)
        out = await ai.default_system_prompt(request.match_info["c"], key)
        return web.json_response(out)

    @_wrap
    async def h_openai_chat(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        return await ai.openai_chat(request, request.match_info["c"], key, body)

    @_wrap
    async def h_mcp(self, request):
        ai = self._require_ai()
        body = await self._json(request)
        key = extract_api_key(request)
        out = await ai.mcp_request(request.match_info["c"], key, body)
        return web.json_response(out)

    @_wrap
    async def h_mcp_update(self, request):
        body = await self._json(request)
        key = extract_api_key(request)
        writer = self._writer()
        coll = writer.check_write_key(request.match_info["c"], key)
        coll.mcp_description = body.get("description")
        return web.json_response({"status": "ok"})

    def _tool_handler(self, action: str):
        @self._wrap
        async def handler(self, request):
            ai = self._require_ai()
            body = await self._json(request) if request.can_read_body else {}
            key = extract_api_key(request)
            out = await ai.tools_action(
                request.match_info["c"], key, action, body
            )
            return web.json_response(out)

        async def route(request):
            return await handler(self, request)

        return route

    def _system_prompt_handler(self, action: str):
        @self._wrap
        async def handler(self, request):
            ai = self._require_ai()
            body = await self._json(request) if request.can_read_body else {}
            key = extract_api_key(request)
            out = await ai.system_prompts_action(
                request.match_info["c"], key, action, body
            )
            return web.json_response(out)

        async def route(request):
            return await handler(self, request)

        return route

    def _training_set_handler(self, action: str):
        @self._wrap
        async def handler(self, request):
            ai = self._require_ai()
            body = await self._json(request) if request.can_read_body else {}
            key = extract_api_key(request)
            out = await ai.training_sets_action(
                request.match_info["c"], key,
                request.match_info["set"], action, body,
            )
            return web.json_response(out)

        async def route(request):
            return await handler(self, request)

        return route

    # ------------------------------------------------------------------

    async def start(self) -> web.Site:
        """Serve on http.host:http.port (port 0: a free one; the bound
        port is `self.port`)."""
        self.site = await web.serve(
            self.app, self.config.http.host, self.config.http.port
        )
        self.port = self.site.port
        return self.site

    async def stop(self) -> None:
        site = getattr(self, "site", None)
        if site is not None:
            await site.close()
            self.site = None


def main(argv=None) -> int:
    """python -m oramacore_tpu_torch.server [--config path] [--device d]"""
    import argparse
    import signal

    from ..config import load_config
    from ..runtime import build_orama
    from ..utils.logs import setup_logging

    p = argparse.ArgumentParser(prog="python -m oramacore_tpu_torch.server")
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the read side and the encoders run; there "
                        "is no fallback from cuda to cpu")
    args = p.parse_args(argv)
    config = load_config(args.config)

    # subscriber stack: console + optional JSON file layer + error
    # reporting + per-module filters (reference bin/oramacore.rs:101-155)
    log_cfg = config.log
    if config.log_levels and not log_cfg.levels:
        log_cfg.levels = dict(config.log_levels)  # legacy key
    setup_logging(log_cfg)

    try:
        orama = build_orama(config, device=args.device)
    except RuntimeError as e:
        print(f"oramacore_tpu_torch.server: {e}", file=sys.stderr)
        return 1
    orama.start_maintenance()
    # the JAX server drops a failure here silently; the port prints it,
    # so that a broken AI module shows, and serves without AI as JAX does
    ai_service = None
    try:
        from ..ai.service import AIService

        ai_service = AIService(config, orama.write_side, orama.read_side)
    except Exception as e:  # noqa: BLE001 — AI optional
        print(f"oramacore_tpu_torch.server: no AI service: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
    server = ApiServer(config, orama.write_side, orama.read_side, ai_service)

    async def run():
        await server.start()
        print(
            f"oramacore_tpu_torch listening on "
            f"http://{config.http.host}:{server.port}",
            flush=True,
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    try:
        asyncio.run(run())
    finally:
        orama.stop()  # graceful: final commits (reference lib.rs:178-185)
    return 0
