"""Pin rules (merchandising): term-triggered promote-doc-to-position.

Reference: `oramacore_lib::pin_rules::{PinRulesReader, PinRule,
Consequence}` applied post-scoring (read/search.rs:257-281, sort.rs:
285-377). Rule JSON shape (tests/pin_rules.rs):

    {"id": "...", "conditions": [{"pattern": "c", "anchoring": "is",
      "normalization": "stem"?}],
     "consequence": {"promote": [{"doc_id": "5", "position": 1}]}}

The port's copy of `oramacore_tpu/read/pin_rules.py`, with the same names and
behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class PromoteItem:
    doc_id: str   # USER doc id (resolved to internal at apply time)
    position: int


@dataclass
class Consequence:
    promote: List[PromoteItem]


def _normalize(term: str, parser, normalization: Optional[str]) -> str:
    term = term.strip().lower()
    if normalization == "stem" and parser is not None:
        parts = parser.tokenize_and_stem(term)
        return " ".join(v[0] if v[1] == [] else v[1][0] for v in parts)
    return term


def condition_matches(cond: Dict[str, Any], term: str, parser) -> bool:
    pattern = str(cond.get("pattern", ""))
    anchoring = cond.get("anchoring", "is")
    normalization = cond.get("normalization")
    t = _normalize(term, parser, normalization)
    p = _normalize(pattern, parser, normalization)
    if anchoring == "is":
        return t == p
    if anchoring == "starts_with":
        return t.startswith(p)
    if anchoring == "ends_with":
        return t.endswith(p)
    if anchoring == "contains":
        return p in t
    return False


def apply_rules(
    rules: List[Dict[str, Any]], term: str, parser
) -> List[Consequence]:
    """Consequences of all rules whose ANY condition matches the query."""
    out: List[Consequence] = []
    for rule in rules:
        conds = rule.get("conditions", [])
        if any(condition_matches(c, term, parser) for c in conds):
            promote = [
                PromoteItem(str(p["doc_id"]), int(p["position"]))
                for p in rule.get("consequence", {}).get("promote", [])
            ]
            if promote:
                out.append(Consequence(promote))
    # stable order + dedup (search.rs:271-279)
    seen = set()
    deduped = []
    for c in sorted(out, key=lambda c: [(p.position, p.doc_id) for p in c.promote]):
        key = tuple((p.position, p.doc_id) for p in c.promote)
        if key not in seen:
            seen.add(key)
            deduped.append(c)
    return deduped


def apply_promotions(
    consequences: List[Consequence],
    resolve: Dict[str, int],            # user doc id -> internal id
    scores: Dict[int, float],
    top: List[Tuple[int, float]],       # [(internal_doc, score)] ranked
) -> List[Tuple[int, float]]:
    """Insert promoted docs at their positions (sort.rs:330-368):
    promoted docs are first removed from the ranked list, then inserted
    at min(position, len)); unknown docs get score 0.0."""
    if not consequences:
        return top
    promote: List[Tuple[int, int]] = []  # (position, internal)
    for c in consequences:
        for item in c.promote:
            internal = resolve.get(item.doc_id)
            if internal is not None:
                promote.append((item.position, internal))
    if not promote:
        return top
    promoted_ids = {d for _, d in promote}
    out = [(d, s) for d, s in top if d not in promoted_ids]
    for position, internal in sorted(promote, key=lambda x: x[0]):
        pos = min(position, len(out))
        out.insert(pos, (internal, scores.get(internal, 0.0)))
    return out
