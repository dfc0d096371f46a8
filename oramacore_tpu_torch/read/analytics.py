"""Product analytics: append-only event log with rotation, buffered
writes, rich event taxonomy, and claim-gated export-and-erase.

Reference: src/collection_manager/sides/read/analytics.rs —
`OramaCoreAnalytics` (:31), `SearchAnalyticEventOrigin` (:64 —
direct/rag/mcp/nlp), `SearchAnalyticEventSearchType` (:76 — f/h/v/a),
`SearchAnalyticEventV1` (:88 — compact wire keys, bools as ints, full
query/result payloads, request-header metadata),
`InteractionAnalyticEventV1` (:198 — conversation/system-prompt ids,
model info, RAG steps, token counts, ttft), the tagged `AnalyticEvent`
envelope (:243 — t: sv1|iv1), the `AnalyticsHolder` per-interaction
accumulator (:269), and `get_and_erase` export (api analytics.rs:51).

The port's copy of `oramacore_tpu/read/analytics.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# search origins (reference :64)
ORIGIN_DIRECT = "direct"
ORIGIN_RAG = "rag"
ORIGIN_MCP = "mcp"
ORIGIN_NLP = "nlp"

_SEARCH_TYPE = {
    "fulltext": "f", "default": "f", "hybrid": "h", "vector": "v",
    "auto": "a",
}


def _b(v: bool) -> int:
    return 1 if v else 0


def search_event_v1(
    collection: str,
    *,
    mode: str,
    term: str,
    duration_ms: float,
    results_count: int,
    raw_query: Optional[Dict[str, Any]] = None,
    results: Optional[Any] = None,
    origin: str = ORIGIN_DIRECT,
    has_filter: bool = False,
    has_facets: bool = False,
    has_groups: bool = False,
    has_sorting: bool = False,
    has_pin_rules: bool = False,
    has_pinned_results: bool = False,
    visitor_id: Optional[str] = None,
    interaction_id: Optional[str] = None,
    metadata: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """SearchAnalyticEventV1 with the reference's compact wire keys."""
    ev: Dict[str, Any] = {
        "t": "sv1",
        "ts": time.time(),
        "coll": collection,
        "o": origin,
        "st": _SEARCH_TYPE.get(mode, "f"),
        "rst": term,
        "hflt": _b(has_filter),
        "hg": _b(has_groups),
        "hs": _b(has_sorting),
        "hfct": _b(has_facets),
        "hpr": _b(has_pin_rules),
        "hpres": _b(has_pinned_results),
        "rc": results_count,
        "sd": duration_ms,
    }
    if raw_query is not None:
        ev["rq"] = json.dumps(raw_query)
    if results is not None:
        ev["r"] = json.dumps(results)
    if visitor_id:
        ev["v_id"] = visitor_id
    if interaction_id:
        ev["i_id"] = interaction_id
    if metadata:
        ev["md"] = metadata
    return ev


class InteractionHolder:
    """Per-interaction accumulator (reference AnalyticsHolder :269):
    the answer flow fills it in as states progress; finish() emits the
    InteractionAnalyticEventV1."""

    def __init__(
        self,
        log: "AnalyticsLog",
        collection: str,
        interaction_id: str,
        conversation_id: Optional[str] = None,
        visitor_id: Optional[str] = None,
        user_message: str = "",
        metadata: Optional[Dict[str, str]] = None,
    ):
        self._log = log
        self._t0 = time.perf_counter()
        self.ev: Dict[str, Any] = {
            "t": "iv1",
            "ts": time.time(),
            "coll": collection,
            "inter_id": interaction_id,
            "conv": conversation_id or interaction_id,
            "usr_msg": user_message,
            "asst_res": "",
            "mp": "",
            "mn": "",
            "rs": [],
            "uit": 0,
            "uot": 0,
            "tps": 0.0,
            "d": 0.0,
            "ttft": 0.0,
        }
        if visitor_id:
            self.ev["v_id"] = visitor_id
        if metadata:
            self.ev["md"] = metadata
        self._done = False

    def set_llm_info(self, provider: str, model: str) -> None:
        self.ev["mp"] = provider
        self.ev["mn"] = model

    def set_system_prompt_id(self, system_prompt_id: str) -> None:
        self.ev["sysprt_id"] = system_prompt_id

    def set_time_to_first_token(self) -> None:
        if not self.ev["ttft"]:
            self.ev["ttft"] = (time.perf_counter() - self._t0) * 1000

    def set_full_context(self, context: str) -> None:
        self.ev["cxt"] = context[:20000]

    def add_rag_step(self, step: Any) -> None:
        self.ev["rs"].append(step)

    def set_generated_related_queries(self, queries: str) -> None:
        self.ev["gq"] = queries

    def set_error(self, error: str) -> None:
        self.ev["err"] = error

    def set_assistant_response(self, response: str) -> None:
        self.ev["asst_res"] = response
        # ~4 chars/token estimate, mirroring the usage accounting
        self.ev["uit"] = max(1, len(self.ev["usr_msg"]) // 4)
        self.ev["uot"] = max(1, len(response) // 4)

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        dur_ms = (time.perf_counter() - self._t0) * 1000
        self.ev["d"] = dur_ms
        gen_ms = dur_ms - self.ev["ttft"]
        if self.ev["uot"] and gen_ms > 0:
            self.ev["tps"] = self.ev["uot"] / (gen_ms / 1000.0)
        self.ev["rs"] = json.dumps(self.ev["rs"])
        self._log.append(self.ev)


class AnalyticsLog:
    """Buffered, size-rotated JSONL event log.

    Rotation keeps `keep_rotated` older generations; get_and_erase
    exports across ALL generations then truncates (reference holder
    rotates its log file and the export drains everything)."""

    def __init__(
        self,
        path: Optional[str] = None,
        enabled: bool = True,
        max_bytes: int = 64 * 1024 * 1024,
        keep_rotated: int = 3,
        flush_every: int = 32,
        metadata_from_headers: Optional[Dict[str, str]] = None,
    ):
        self.path = path
        self.enabled = enabled and path is not None
        self.max_bytes = max_bytes
        self.keep_rotated = keep_rotated
        self.flush_every = flush_every
        # header name -> metadata key (reference MetadataFfromHeadersPair)
        self.metadata_from_headers = dict(metadata_from_headers or {})
        self._lock = threading.Lock()
        self._fh = None
        self._since_flush = 0
        self._bytes = 0
        if self.enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
            self._bytes = os.path.getsize(path)

    # -- request metadata ------------------------------------------------

    def metadata_from_request(self, headers) -> Dict[str, str]:
        out = {}
        for header, key in self.metadata_from_headers.items():
            v = headers.get(header)
            if v:
                out[key] = str(v)
        return out

    # -- write path --------------------------------------------------------

    def _rotated_path(self, n: int) -> str:
        return f"{self.path}.{n}"

    def _rotate_locked(self) -> None:
        self._fh.close()
        for n in range(self.keep_rotated, 0, -1):
            src = self._rotated_path(n)
            if n == self.keep_rotated and os.path.exists(src):
                os.unlink(src)
                continue
            if os.path.exists(src):
                os.replace(src, self._rotated_path(n + 1))
        os.replace(self.path, self._rotated_path(1))
        self._fh = open(self.path, "a")
        self._bytes = 0

    def append(self, event: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        event.setdefault("ts", time.time())
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._bytes += len(line)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._fh.flush()
                self._since_flush = 0
            if self._bytes >= self.max_bytes:
                self._rotate_locked()

    # -- event helpers (back-compat + taxonomy) ---------------------------

    def add_search_event(self, collection: str, **kwargs) -> None:
        # accept both the rich taxonomy kwargs and the legacy short form
        term = kwargs.pop("term", "")
        results = kwargs.pop("results", None)
        if isinstance(results, int):  # legacy: results was the count
            kwargs.setdefault("results_count", results)
            results = None
        self.append(search_event_v1(
            collection, term=term, results=results,
            mode=kwargs.pop("mode", "fulltext"),
            duration_ms=kwargs.pop("duration_ms", 0.0),
            results_count=kwargs.pop("results_count", 0),
            **kwargs,
        ))

    def add_interaction_event(
        self, collection: str, interaction_id: str, query: str,
        duration_ms: float, **kwargs,
    ) -> None:
        """Legacy one-shot interaction event; prefer InteractionHolder."""
        h = InteractionHolder(
            self, collection, interaction_id, user_message=query, **kwargs
        )
        h.ev["d"] = duration_ms
        h.ev["rs"] = json.dumps(h.ev["rs"])
        h._done = True
        self.append(h.ev)

    def interaction(self, collection: str, interaction_id: str,
                    **kwargs) -> InteractionHolder:
        return InteractionHolder(self, collection, interaction_id, **kwargs)

    # -- export ------------------------------------------------------------

    def get_and_erase(self) -> List[Dict[str, Any]]:
        """Export all events (rotated generations first, oldest first)
        and truncate (analytics.rs:51 claim-gated export)."""
        with self._lock:
            events: List[Dict[str, Any]] = []
            if not self.path:
                return events
            if self._fh:
                self._fh.flush()
            paths = [
                self._rotated_path(n)
                for n in range(self.keep_rotated + 1, 0, -1)
            ] + [self.path]
            for p in paths:
                if not os.path.exists(p):
                    continue
                with open(p) as fh:
                    for line in fh:
                        line = line.strip()
                        if line:
                            try:
                                events.append(json.loads(line))
                            except json.JSONDecodeError:
                                continue
                if p != self.path:
                    os.unlink(p)
            if self._fh:
                self._fh.close()
            self._fh = open(self.path, "w")
            self._bytes = 0
            return events

    def close(self):
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None
