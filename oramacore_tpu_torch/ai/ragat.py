"""RAG-AT notation parser: declarative context composition for answers.

Reference: src/ai/ragat.rs:50-200. Grammar:

    notation  := component (";" component)*
    component := ["!"] source ("," source)* "@" threshold ":" maxdocs ["+"]

"!" marks an exclusion component; "+" lets the component fill remaining
document budget.

The port's copy of `oramacore_tpu/ai/ragat.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set


class RagAtParseError(ValueError):
    pass


@dataclass
class ContextComponent:
    source_ids: List[str]
    threshold: float
    max_documents: int
    fill_remaining: bool = False
    is_exclusion: bool = False


def parse(notation: str) -> List[ContextComponent]:
    notation = (notation or "").strip()
    if not notation:
        return []
    components = []
    for raw in notation.split(";"):
        raw = raw.strip()
        if not raw:
            raise RagAtParseError("Empty component")
        is_exclusion = raw.startswith("!")
        if is_exclusion:
            raw = raw[1:]
        if "@" not in raw:
            raise RagAtParseError("Missing @ symbol for threshold")
        source_part, params = raw.split("@", 1)
        sources = [s.strip() for s in source_part.split(",") if s.strip()]
        if not sources:
            raise RagAtParseError("Source list cannot be empty")
        if ":" not in params:
            raise RagAtParseError("Missing : symbol for max documents")
        thr_str, max_str = params.split(":", 1)
        try:
            threshold = float(thr_str.strip())
        except ValueError as e:
            raise RagAtParseError(f"Invalid threshold value: {thr_str}") from e
        fill = max_str.rstrip().endswith("+")
        if fill:
            max_str = max_str.rstrip()[:-1]
        try:
            max_documents = int(max_str.strip())
        except ValueError as e:
            raise RagAtParseError(f"Invalid max documents: {max_str}") from e
        components.append(
            ContextComponent(sources, threshold, max_documents, fill, is_exclusion)
        )
    return components


def validate_sources(
    components: List[ContextComponent], available: Set[str]
) -> None:
    for i, c in enumerate(components):
        for sid in c.source_ids:
            if sid not in available:
                raise RagAtParseError(
                    f"Component {i}: Source ID '{sid}' not found in available indexes"
                )


def extract_all_source_ids(components: List[ContextComponent]) -> Set[str]:
    return {sid for c in components for sid in c.source_ids}
