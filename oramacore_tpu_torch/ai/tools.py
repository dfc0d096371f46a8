"""User-defined LLM tools: JSON-schema params + optional sandboxed code.

Reference: src/ai/tools.rs — `Tool` (:60: id, description, parameters
JSON-schema, optional code), `ToolsRuntime` (:93: KV-backed CRUD),
`execute_tools` (:192: OpenAI function-calling round; tools with code
run their code on the call arguments).

The port's copy of `oramacore_tpu/ai/tools.py`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .llms import LLMConfig, LLMService


class ToolsError(Exception):
    pass


class ToolsRuntime:
    def __init__(self, kv, llm: Optional[LLMService], hooks_runtime=None):
        self.kv = kv
        self.llm = llm
        self.hooks_runtime = hooks_runtime

    @staticmethod
    def _key(collection_id: str, tool_id: str) -> str:
        return f"tool:{collection_id}:{tool_id}"

    def insert(self, collection_id: str, tool: Dict[str, Any]) -> None:
        if "id" not in tool:
            raise ToolsError("tool requires an id")
        self.kv.insert(self._key(collection_id, tool["id"]), tool)

    def get(self, collection_id: str, tool_id: str) -> Optional[Dict[str, Any]]:
        return self.kv.get(self._key(collection_id, tool_id))

    def list(self, collection_id: str) -> List[Dict[str, Any]]:
        return [v for _, v in self.kv.scan_prefix(f"tool:{collection_id}:")]

    def delete(self, collection_id: str, tool_id: str) -> None:
        self.kv.remove(self._key(collection_id, tool_id))

    def update(self, collection_id: str, tool: Dict[str, Any]) -> None:
        self.insert(collection_id, tool)

    # ------------------------------------------------------------------

    @staticmethod
    def _to_openai_tool(tool: Dict[str, Any]) -> Dict[str, Any]:
        params = tool.get("parameters")
        if isinstance(params, str):
            params = json.loads(params)
        return {
            "type": "function",
            "function": {
                "name": tool["id"],
                "description": tool.get("description", ""),
                "parameters": params or {"type": "object", "properties": {}},
            },
        }

    async def execute_tools(
        self,
        collection_id: str,
        messages: List[Dict[str, str]],
        tool_ids: Optional[List[str]] = None,
        llm_config: Optional[LLMConfig] = None,
    ) -> List[Dict[str, Any]]:
        """Function-calling round: LLM picks tools; tools carrying code run
        it on the arguments. Returns [{tool: id, arguments, result?}]."""
        if self.llm is None:
            raise ToolsError("no LLM configured")
        tools = self.list(collection_id)
        if tool_ids:
            tools = [t for t in tools if t["id"] in tool_ids]
        if not tools:
            return []
        calls = await self.llm.execute_tools(
            messages, [self._to_openai_tool(t) for t in tools], llm_config
        )
        by_id = {t["id"]: t for t in tools}
        out: List[Dict[str, Any]] = []
        for call in calls:
            fn = call.get("function", {})
            name = fn.get("name")
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except json.JSONDecodeError:
                args = {"_raw": fn.get("arguments")}
            entry: Dict[str, Any] = {"tool": name, "arguments": args}
            tool = by_id.get(name)
            if tool and tool.get("code") and self.hooks_runtime is not None:
                entry["result"] = self.hooks_runtime.exec_hook(
                    collection_id, name, tool["code"], args
                )
            out.append(entry)
        return out
