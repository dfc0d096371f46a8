"""Advanced autoquery state machine: NL → structured multi-query search.

Reference: src/ai/state_machines/advanced_autoquery.rs —
AdvancedAutoqueryFlow (:155-235): AnalyzeInput → QueryOptimized →
[PlanBudget when a shared budget is detected] → SelectProperties →
CombineQueriesAndProperties → GenerateTrackedQueries (LLM composes
SearchParams, constraint-validated by the deterministic extractor) →
BeforeRetrievalHook → ExecuteSearches → results. v1/v1.1 prompt
versions (v1.1 adds the budget planner).

The port's copy of `oramacore_tpu/ai/autoquery.py`.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator, Dict, List, Optional

from ..types import SearchParams
from .constraint_extractor import (
    NumericConstraint,
    extract_constraints,
    inject_constraints,
    shared_budget_amount,
    validate_search_params,
)
from .llms import LLMConfig, LLMService, parse_json_response


def _event(type_: str, **kw) -> Dict[str, Any]:
    return {"type": type_, **kw}


def _state(state: str, message: str = "", data: Any = None) -> Dict[str, Any]:
    return _event("state_changed", state=state, message=message, data=data)


class AdvancedAutoqueryStateMachine:
    def __init__(
        self,
        llm: LLMService,
        read_side,
        collection_id: str,
        read_api_key: Optional[str],
        hooks_runtime=None,
        prompt_version: str = "v1.1",
    ):
        self.llm = llm
        self.read_side = read_side
        self.collection_id = collection_id
        self.read_api_key = read_api_key
        self.hooks_runtime = hooks_runtime
        self.prompt_version = prompt_version

    def _prompt(self, name: str) -> str:
        if self.prompt_version == "v1.1":
            return f"v1_1_{name}"
        return name

    def _filterable_properties(self) -> Dict[str, str]:
        try:
            return self.read_side.filterable_fields(
                self.collection_id, self.read_api_key
            )
        except Exception:  # noqa: BLE001
            return {}

    def _string_enum_values(self) -> Dict[str, List[str]]:
        """Known enum values per string-filter field, so deterministic
        constraint extraction can match query text against the schema
        (reference extract_string_enum_constraints)."""
        out: Dict[str, List[str]] = {}
        try:
            coll = self.read_side.collections.get(self.collection_id)
            if coll is None:
                return out
            seen: Dict[str, set] = {}
            for idx in coll.indexes.values():
                for path, col in idx.filters.strings.items():
                    vals = out.setdefault(path, [])
                    # JAX's `if v not in vals` scan, with a set beside the
                    # list: the same values in the same order, without a
                    # quadratic cost on a field of many distinct values
                    # (short titles of a large collection)
                    known = seen.setdefault(path, set())
                    for v in col.all_values():
                        if v not in known:
                            known.add(v)
                            vals.append(v)
        except Exception:  # noqa: BLE001
            pass
        return out

    async def run_stream(
        self,
        query: str,
        conversation: Optional[List[Dict[str, str]]] = None,
        llm_config: Optional[LLMConfig] = None,
    ) -> AsyncIterator[Dict[str, Any]]:
        # AnalyzeInput [LLM]
        yield _state("analyze_input", "Analyzing input")
        try:
            raw = await self.llm.run_known_prompt(
                self._prompt("advanced_autoquery_query_analyzer"),
                conversation=conversation,
                variables=[("query", query)],
                llm_config=llm_config,
            )
            queries = parse_json_response(raw).get("queries") or [query]
        except Exception:  # noqa: BLE001
            queries = [query]
        yield _state("queries_analyzed", data={"queries": queries})

        # PlanBudget (v1.1) when shared budget detected
        budget = shared_budget_amount(query)
        allocations: Dict[str, float] = {}
        if budget is not None and self.prompt_version == "v1.1":
            yield _state("plan_budget", f"shared budget {budget}")
            try:
                raw = await self.llm.run_known_prompt(
                    self._prompt("advanced_autoquery_budget_planner"),
                    variables=[
                        ("query", query),
                        ("budget", str(budget)),
                        ("queries", json.dumps(queries)),
                    ],
                    llm_config=llm_config,
                )
                for a in parse_json_response(raw).get("allocations", []):
                    allocations[a["query"]] = float(a["max_price"])
            except Exception:  # noqa: BLE001
                pass

        # SelectProperties [LLM]
        properties = self._filterable_properties()
        yield _state("select_properties", data={"properties": properties})
        selections: List[Dict[str, Any]] = []
        try:
            raw = await self.llm.run_known_prompt(
                self._prompt("advanced_autoquery_properties_selector"),
                variables=[
                    ("queries", json.dumps(queries)),
                    ("properties", json.dumps(properties)),
                ],
                llm_config=llm_config,
            )
            selections = parse_json_response(raw).get("selections", [])
        except Exception:  # noqa: BLE001
            selections = [{"query": q, "properties": list(properties)} for q in queries]

        # CombineQueriesAndProperties → GenerateTrackedQueries [LLM]
        yield _state("generate_tracked_queries", "Composing search params")
        numeric_props = [p for p, t in properties.items() if t in ("number", "date")]
        searches: List[Dict[str, Any]] = []
        try:
            raw = await self.llm.run_known_prompt(
                self._prompt("advanced_autoquery_query_composer"),
                variables=[
                    ("queries_and_properties", json.dumps(selections)),
                    ("properties", json.dumps(properties)),
                ],
                llm_config=llm_config,
            )
            searches = parse_json_response(raw).get("searches", [])
        except Exception:  # noqa: BLE001
            searches = [{"term": q} for q in queries]
        if not searches:
            searches = [{"term": q} for q in queries]

        # constraint validation/injection (constraint_extractor.rs:658,732):
        # extraction sees the schema — enum values of string filters and
        # boolean field names — so enum/bool constraints inject too
        enum_values = self._string_enum_values()
        bool_fields = [p for p, t in properties.items() if t == "bool"]
        final_searches: List[Dict[str, Any]] = []
        for i, sp in enumerate(searches):
            q = queries[i] if i < len(queries) else query
            constraints = extract_constraints(q, enum_values, bool_fields)
            if allocations.get(q) is not None:
                constraints = [
                    NumericConstraint(
                        "lte", allocations[q], None, "budget plan"
                    )
                ] + constraints
            missing = validate_search_params(sp, constraints, numeric_props)
            if missing:
                sp = inject_constraints(sp, missing, numeric_props)
            final_searches.append(sp)
        yield _state(
            "tracked_queries_generated", data={"searches": final_searches}
        )

        # BeforeRetrievalHook
        if self.hooks_runtime is not None:
            coll = self.read_side.collections.get(self.collection_id)
            code = coll.hooks.get("BeforeRetrieval") if coll else None
            if code:
                out = self.hooks_runtime.exec_hook(
                    self.collection_id, "BeforeRetrieval",
                    code, {"searches": final_searches},
                )
                if isinstance(out, dict) and "searches" in out:
                    final_searches = out["searches"]

        # ExecuteSearches (N x search)
        yield _state("execute_searches", f"{len(final_searches)} searches")
        all_hits: List[Dict[str, Any]] = []
        loop = asyncio.get_running_loop()
        for sp in final_searches:
            try:
                params = SearchParams.from_json(sp)
                result = await loop.run_in_executor(
                    None,
                    lambda p=params: self.read_side.search(
                        self.collection_id, self.read_api_key, p
                    ),
                )
                all_hits.extend(h.to_json() for h in result.hits)
            except Exception as e:  # noqa: BLE001
                yield _event(
                    "error", error=f"search failed: {e}",
                    state="execute_searches", is_terminal=False,
                )
        yield _event("search_results", results=all_hits)
        yield _state("completed", data={"result_count": len(all_hits)})

    async def run(
        self,
        query: str,
        conversation: Optional[List[Dict[str, str]]] = None,
        llm_config: Optional[LLMConfig] = None,
    ) -> List[Dict[str, Any]]:
        results: List[Dict[str, Any]] = []
        async for ev in self.run_stream(query, conversation, llm_config):
            if ev["type"] == "search_results":
                results = ev["results"]
        return results
