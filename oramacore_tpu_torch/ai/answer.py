"""Answer state machine: the RAG flow as an explicit state sequence.

Reference: src/ai/state_machines/answer.rs — AnswerFlow states (:128-209):
Initialize → HandleGPUOverload → GetLLMConfig → DetermineQueryStrategy →
[AdvancedAutoquery inline, events forwarded] → BeforeRetrievalHook →
OptimizeQuery → ExecuteSearch (RAG-AT multi-source or defaults: mode
Vector, limit max_documents|5, similarity min_similarity|0.5) →
HandleSystemPrompt → BeforeAnswerHook → GenerateAnswer (token stream) →
related queries → Completed. Every state retries with exponential
backoff (AnswerConfig answer.rs:214-236: 3 retries, 100ms→30s). SSE
event wire shapes mirror AnswerEvent (:34-71).

The port's copy of `oramacore_tpu/ai/answer.py`.
"""

from __future__ import annotations

import asyncio
import json
import random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, List, Optional

from ..types import Interaction, SearchParams
from . import ragat
from .autoquery import AdvancedAutoqueryStateMachine
from .llms import LLMConfig, LLMService, parse_json_response


@dataclass
class AnswerConfig:
    max_retries: int = 3
    backoff_base_s: float = 0.1
    backoff_max_s: float = 30.0
    default_limit: int = 5
    default_similarity: float = 0.5


def _event(type_: str, **kw) -> Dict[str, Any]:
    return {"type": type_, **kw}


def _state(state: str, message: str = "", data: Any = None) -> Dict[str, Any]:
    return _event("state_changed", state=state, message=message, data=data)


class AnswerStateMachine:
    def __init__(
        self,
        llm: LLMService,
        read_side,
        collection_id: str,
        read_api_key: Optional[str],
        hooks_runtime=None,
        system_prompts=None,
        config: Optional[AnswerConfig] = None,
    ):
        self.llm = llm
        self.read_side = read_side
        self.collection_id = collection_id
        self.read_api_key = read_api_key
        self.hooks_runtime = hooks_runtime
        self.system_prompts = system_prompts
        self.config = config or AnswerConfig()

    # ------------------------------------------------------------------

    async def _retry(self, state_name: str, coro_factory):
        last = None
        for attempt in range(self.config.max_retries):
            try:
                return await coro_factory()
            except Exception as e:  # noqa: BLE001
                last = e
                await asyncio.sleep(
                    min(
                        self.config.backoff_base_s * (2 ** attempt),
                        self.config.backoff_max_s,
                    )
                )
        raise RuntimeError(f"{state_name} failed after retries: {last}")

    def _run_hook(self, hook_name: str, payload: Any) -> Optional[Any]:
        if self.hooks_runtime is None:
            return None
        coll = self.read_side.collections.get(self.collection_id)
        if coll is None:
            return None
        code = coll.hooks.get(hook_name)
        if not code:
            return None
        return self.hooks_runtime.exec_hook(
            self.collection_id, hook_name, code, payload
        )

    def _search(self, params_json: Dict[str, Any]):
        params = SearchParams.from_json(params_json)
        return self.read_side.search(
            self.collection_id, self.read_api_key, params
        )

    def _conversation(self, interaction: Interaction) -> List[Dict[str, str]]:
        return [
            {"role": m.role, "content": m.content}
            for m in interaction.messages
        ]

    # ------------------------------------------------------------------

    async def run_stream(
        self, interaction: Interaction, planned: bool = False
    ) -> AsyncIterator[Dict[str, Any]]:
        """Yields SSE event dicts (AnswerEvent-compatible)."""
        cfg = self.config
        yield _event("acknowledged")

        # Initialize
        yield _state("initialize", "Initializing answer flow")
        llm_config = None
        if interaction.llm_config:
            llm_config = LLMConfig(
                provider=interaction.llm_config.get("provider"),
                model=interaction.llm_config.get("model"),
                temperature=interaction.llm_config.get("temperature"),
            )

        # HandleGPUOverload → provider choice (reference answer.rs:134)
        provider = self.llm.select_provider(llm_config)
        yield _event("selected_llm", provider=provider.name, model=provider.model)

        # DetermineQueryStrategy [LLM]
        strategy = "simple"
        if planned:
            strategy = "advanced_autoquery"
        else:
            try:
                raw = await self._retry(
                    "determine_query_strategy",
                    lambda: self.llm.run_known_prompt(
                        "determine_query_strategy",
                        variables=[("query", interaction.query)],
                        llm_config=llm_config,
                    ),
                )
                parsed = parse_json_response(raw)
                strategy = parsed.get("strategy", "simple")
            except Exception:  # noqa: BLE001
                strategy = "simple"
        yield _state(
            "determine_query_strategy", f"strategy: {strategy}",
            data={"strategy": strategy},
        )

        search_results: List[Dict[str, Any]] = []

        if strategy == "advanced_autoquery":
            # full autoquery SM inline, events forwarded (answer.rs:881-1010)
            sub = AdvancedAutoqueryStateMachine(
                self.llm, self.read_side, self.collection_id,
                self.read_api_key, hooks_runtime=self.hooks_runtime,
            )
            async for ev in sub.run_stream(
                interaction.query, self._conversation(interaction), llm_config
            ):
                if ev["type"] == "search_results":
                    search_results = ev["results"]
                yield _event(
                    "advanced_autoquery_" + ev.pop("type"), **ev
                )
        else:
            # BeforeRetrievalHook [sandboxed]
            yield _state("before_retrieval_hook", "Running beforeRetrieval hook")
            hook_out = self._run_hook(
                "BeforeRetrieval", {"query": interaction.query}
            )
            query = interaction.query
            if isinstance(hook_out, dict) and hook_out.get("query"):
                query = hook_out["query"]

            # OptimizeQuery [LLM]
            optimized = query
            try:
                optimized = (
                    await self._retry(
                        "optimize_query",
                        lambda: self.llm.run_known_prompt(
                            "optimize_query",
                            variables=[
                                ("query", query),
                                ("conversation", json.dumps(
                                    self._conversation(interaction))),
                            ],
                            llm_config=llm_config,
                        ),
                    )
                ).strip() or query
            except Exception:  # noqa: BLE001
                pass
            yield _event(
                "optimizing_query",
                original_query=query, optimized_query=optimized,
            )

            # ExecuteSearch (answer.rs:1381-1460)
            yield _state("execute_search", "Searching")
            limit = interaction.max_documents or cfg.default_limit
            similarity = (
                interaction.min_similarity
                if interaction.min_similarity is not None
                else cfg.default_similarity
            )
            if interaction.ragat_notation:
                components = ragat.parse(interaction.ragat_notation)
                coll = self.read_side.collections.get(self.collection_id)
                available = set(coll.indexes.keys()) if coll else set()
                ragat.validate_sources(components, available)
                hits: List[Dict[str, Any]] = []
                seen = set()
                excluded = set()
                for comp in components:
                    if comp.is_exclusion:
                        excluded.update(comp.source_ids)
                        continue
                    sources = [s for s in comp.source_ids if s not in excluded]
                    if not sources:
                        continue
                    result = await asyncio.get_running_loop().run_in_executor(
                        None,
                        lambda comp=comp, sources=sources: self._search(
                            {
                                "term": optimized,
                                "mode": "vector",
                                "similarity": comp.threshold,
                                "limit": comp.max_documents,
                                "indexes": sources,
                            }
                        ),
                    )
                    for h in result.hits[: comp.max_documents]:
                        if h.id not in seen:
                            seen.add(h.id)
                            hits.append(h.to_json())
                search_results = hits[:limit] if not any(
                    c.fill_remaining for c in components
                ) else hits
            else:
                mode = interaction.search_mode or "vector"
                result = await asyncio.get_running_loop().run_in_executor(
                    None,
                    lambda: self._search(
                        {
                            "term": optimized,
                            "mode": mode,
                            "similarity": similarity,
                            "limit": limit,
                        }
                    ),
                )
                search_results = [h.to_json() for h in result.hits]
            yield _event("search_results", results=search_results)

        # HandleSystemPrompt (KV)
        system_prompt = None
        if self.system_prompts is not None:
            system_prompt = self.system_prompts.select_for_interaction(
                self.collection_id, interaction.system_prompt_id
            )
        yield _state(
            "handle_system_prompt",
            "selected" if system_prompt else "none",
        )

        # BeforeAnswerHook
        hook_out = self._run_hook(
            "BeforeAnswer",
            {"query": interaction.query, "results": search_results},
        )
        if isinstance(hook_out, dict) and "results" in hook_out:
            search_results = hook_out["results"]

        # GenerateAnswer [LLM stream]
        yield _state("generate_answer", "Generating answer")
        context = json.dumps(
            [h.get("document") for h in search_results], ensure_ascii=False
        )
        conversation = self._conversation(interaction)
        if system_prompt:
            conversation = [
                {"role": "system", "content": system_prompt.get("prompt", "")}
            ] + conversation
        answer_parts: List[str] = []
        try:
            async for token in self.llm.run_known_prompt_stream(
                "answer",
                conversation=conversation,
                variables=[
                    ("context", context),
                    ("question", interaction.query),
                ],
                llm_config=llm_config,
            ):
                answer_parts.append(token)
                yield _event("answer_token", token=token)
        except Exception as e:  # noqa: BLE001
            yield _event(
                "error", error=f"answer generation failed: {e}",
                state="generate_answer", is_terminal=True,
            )
            return

        # Related queries [LLM]
        if interaction.related:
            try:
                related = await self.llm.run_known_prompt(
                    "generate_related_queries",
                    variables=[
                        ("query", interaction.query),
                        ("context", context),
                        ("number", str(interaction.related.get("howMany", 3))),
                    ],
                    llm_config=llm_config,
                )
                yield _event("related_queries", queries=related)
            except Exception:  # noqa: BLE001
                pass

        yield _state(
            "completed", "Answer flow completed",
            data={"answer": "".join(answer_parts)},
        )

    async def run(self, interaction: Interaction, planned: bool = False):
        """Non-streaming: returns (answer, search_results, related)."""
        answer = []
        results: List[Dict[str, Any]] = []
        related = None
        async for ev in self.run_stream(interaction, planned):
            if ev["type"] == "answer_token":
                answer.append(ev["token"])
            elif ev["type"] == "search_results":
                results = ev["results"]
            elif ev["type"] == "advanced_autoquery_search_results":
                results = ev["results"]
            elif ev["type"] == "related_queries":
                related = ev["queries"]
        return "".join(answer), results, related
