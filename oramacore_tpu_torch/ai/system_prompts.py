"""System prompts CRUD + LLM validation + per-interaction selection.

Reference: src/collection_manager/sides/system_prompts.rs —
`SystemPromptInterface` (:50), validation structs (:23-48:
security/technical/overall), SystemPromptUsageMode automatic|manual
(types.rs:1670): manual selects by id, automatic picks randomly.
Prompts persist in KV and replicate write→read through the op log.

The port's copy of `oramacore_tpu/ai/system_prompts.py`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from .llms import LLMService, parse_json_response


class SystemPromptsInterface:
    def __init__(self, kv, llm: Optional[LLMService] = None):
        self.kv = kv
        self.llm = llm

    @staticmethod
    def _key(collection_id: str, prompt_id: str) -> str:
        return f"system_prompt:{collection_id}:{prompt_id}"

    def insert(self, collection_id: str, prompt: Dict[str, Any]) -> None:
        prompt.setdefault("usage_mode", "automatic")
        self.kv.insert(self._key(collection_id, prompt["id"]), prompt)

    def get(self, collection_id: str, prompt_id: str) -> Optional[Dict[str, Any]]:
        return self.kv.get(self._key(collection_id, prompt_id))

    def list(self, collection_id: str) -> List[Dict[str, Any]]:
        return [v for _, v in self.kv.scan_prefix(f"system_prompt:{collection_id}:")]

    def delete(self, collection_id: str, prompt_id: str) -> None:
        self.kv.remove(self._key(collection_id, prompt_id))

    def update(self, collection_id: str, prompt: Dict[str, Any]) -> None:
        self.insert(collection_id, prompt)

    def select_for_interaction(
        self, collection_id: str, system_prompt_id: Optional[str]
    ) -> Optional[Dict[str, Any]]:
        """Manual id wins; otherwise random among automatic prompts
        (system_prompts.rs usage-mode semantics)."""
        if system_prompt_id:
            return self.get(collection_id, system_prompt_id)
        autos = [
            p for p in self.list(collection_id)
            if p.get("usage_mode", "automatic") == "automatic"
        ]
        return random.choice(autos) if autos else None

    async def validate(self, prompt: Dict[str, Any]) -> Dict[str, Any]:
        """LLM-based validation (security/technical/overall)."""
        if self.llm is None:
            return {
                "security": {"valid": True, "reason": "no llm configured"},
                "technical": {"valid": True, "reason": "no llm configured"},
                "overall_assessment": {"valid": True, "summary": "skipped"},
            }
        raw = await self.llm.run_known_prompt(
            "validate_system_prompt",
            variables=[("system_prompt", prompt.get("prompt", ""))],
        )
        return parse_json_response(raw)
