"""MCP server: JSON-RPC 2.0 over HTTP exposing `search` and `nlp_search`.

Reference: src/python/scripts/src/mcp/mcp.py (MCPServer :21,
handle_jsonrpc_request :70) bridged per request via python/mcp.rs
McpService with a SearchService callback re-entering ReadSide search.

The port's copy of `oramacore_tpu/ai/mcp.py`.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from ..types import SearchParams

PROTOCOL_VERSION = "2024-11-05"


class MCPServer:
    def __init__(self, read_side, autoquery_factory=None):
        self.read_side = read_side
        # autoquery_factory(collection_id, read_key) -> AdvancedAutoqueryStateMachine
        self.autoquery_factory = autoquery_factory

    def _tools(self, collection_id: str) -> list:
        coll = self.read_side.collections.get(collection_id)
        desc = (coll.mcp_description if coll else None) or (
            f"Search the {collection_id} collection"
        )
        tools = [
            {
                "name": "search",
                "description": desc,
                "inputSchema": {
                    "type": "object",
                    "properties": {
                        "term": {"type": "string"},
                        "mode": {
                            "type": "string",
                            "enum": ["fulltext", "vector", "hybrid"],
                        },
                        "limit": {"type": "integer"},
                        "where": {"type": "object"},
                    },
                    "required": ["term"],
                },
            }
        ]
        if self.autoquery_factory is not None:
            tools.append(
                {
                    "name": "nlp_search",
                    "description": "Natural-language search: the engine "
                    "plans structured queries from the request",
                    "inputSchema": {
                        "type": "object",
                        "properties": {"query": {"type": "string"}},
                        "required": ["query"],
                    },
                }
            )
        return tools

    async def handle(
        self, collection_id: str, read_api_key: Optional[str],
        request: Dict[str, Any],
    ) -> Dict[str, Any]:
        rid = request.get("id")
        method = request.get("method")

        def ok(result):
            return {"jsonrpc": "2.0", "id": rid, "result": result}

        def err(code, message):
            return {
                "jsonrpc": "2.0", "id": rid,
                "error": {"code": code, "message": message},
            }

        if request.get("jsonrpc") != "2.0":
            return err(-32600, "invalid request: jsonrpc must be '2.0'")

        if method == "initialize":
            return ok(
                {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {
                        "name": "oramacore_tpu-mcp",
                        "version": "0.1.0",
                    },
                }
            )
        if method in ("notifications/initialized", "initialized"):
            return ok({})
        if method == "tools/list":
            return ok({"tools": self._tools(collection_id)})
        if method == "tools/call":
            params = request.get("params") or {}
            name = params.get("name")
            args = params.get("arguments") or {}
            loop = asyncio.get_running_loop()
            try:
                if name == "search":
                    sp = SearchParams.from_json(args)
                    result = await loop.run_in_executor(
                        None,
                        lambda: self.read_side.search(
                            collection_id, read_api_key, sp
                        ),
                    )
                    payload = result.to_json()
                elif name == "nlp_search" and self.autoquery_factory:
                    sm = self.autoquery_factory(collection_id, read_api_key)
                    hits = await sm.run(args.get("query", ""))
                    payload = {"hits": hits, "count": len(hits)}
                else:
                    return err(-32601, f"unknown tool {name!r}")
            except Exception as e:  # noqa: BLE001
                return err(-32000, str(e))
            import json as _json

            return ok(
                {
                    "content": [
                        {"type": "text", "text": _json.dumps(payload)}
                    ],
                    "isError": False,
                }
            )
        return err(-32601, f"method {method!r} not found")
