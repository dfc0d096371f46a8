"""Deterministic (non-LLM) constraint extraction, validation & injection.

Reference: src/ai/constraint_extractor.rs — `extract_constraints` (:82),
numeric grammar (:103-257), field hints from context (:262), string-enum
matching with synonyms (:304-392), boolean patterns (:397-492),
`match_numeric_constraints` (:500), `format_constraints_for_prompt`
(:578), `validate_search_params` (:658), `inject_constraints` (:732),
`has_shared_budget` (:814).

The LLM composes SearchParams from natural language; this module is the
deterministic safety net around it: it extracts the constraints the text
actually states (price/range/rating numbers, schema enum values,
boolean availability phrases), verifies the LLM's `where` filter carries
them, and force-injects anything missing before the search executes.

The port's copy of `oramacore_tpu/ai/constraint_extractor.py`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NUM = r"(\d+(?:[.,]\d+)?)"
# optional currency marker before the number ($, USD, EUR, GBP, symbols)
_CUR = r"(?:\$|usd|eur|gbp|£|€)?\s*"
_CUR_REQ = r"(?:\$|usd|eur|gbp|£|€)\s*"


def _f(s: str) -> float:
    return float(s.replace(",", "."))


@dataclass
class NumericConstraint:
    op: str                      # eq | lte | gte | between
    value: float
    upper: Optional[float] = None
    span: str = ""               # matched text (debug / prompt display)
    field_hint: Optional[str] = None


@dataclass
class StringEnumConstraint:
    field_name: str
    matched_value: str           # the exact schema enum value
    span: str = ""               # the query text that matched


@dataclass
class BoolConstraint:
    value: bool
    span: str = ""
    field_hint: Optional[str] = None


Constraint = Any  # union of the three dataclasses


# ---------------------------------------------------------------------------
# Numeric grammar (reference :103-257)
# ---------------------------------------------------------------------------

_BETWEEN_RE = re.compile(
    rf"(?:between|from)\s+{_CUR}{_NUM}\s+(?:and|to)\s+{_CUR}{_NUM}", re.I
)
# "$50-$150": currency required on the first number so arbitrary numeric
# ranges (e.g. "2-3 bedrooms") don't false-positive
_RANGE_RE = re.compile(rf"{_CUR_REQ}{_NUM}\s*[-–]\s*{_CUR}{_NUM}", re.I)
_LTE_RE = re.compile(
    rf"(?:under|below|(?<!no\s)less\s+than|max(?:imum)?(?:\s+of)?|up\s+to|"
    rf"no\s+more\s+than|within|budget\s+(?:of\s+)?|cheaper\s+than|"
    rf"at\s+most)\s*{_CUR}{_NUM}", re.I,
)
_GTE_RE = re.compile(
    rf"(?:over|above|more\s+than|min(?:imum)?(?:\s+of)?|at\s+least|"
    rf"starting\s+(?:at|from)|no\s+less\s+than)\s*{_CUR}{_NUM}", re.I,
)
_EQ_RE = re.compile(rf"(?:exactly|precisely)\s+{_CUR}{_NUM}", re.I)

_HINT_KEYWORDS: List[Tuple[str, Tuple[str, ...]]] = [
    ("price", ("price", "cost", "budget", "$", "dollar", "usd", "eur",
               "gbp", "€", "£", "cheap", "expensive", "afford")),
    ("rating", ("rating", "star", "score", "review")),
    ("weight", ("weight", "kg", "lb", "gram", "oz")),
    ("size", ("size", "length", "width", "height")),
    ("year", ("year", "released", "from 19", "from 20")),
]


def _field_hint(query_lower: str, position: int) -> Optional[str]:
    """Guess which field a number refers to from nearby context
    (reference :262-302: +-window keyword scan, then $-anywhere)."""
    start = max(0, position - 30)
    end = min(len(query_lower), position + 50)
    context = query_lower[start:end]
    for hint, keywords in _HINT_KEYWORDS:
        if any(kw in context for kw in keywords):
            return hint
    if "$" in query_lower:
        return "price"
    return None


def extract_numeric_constraints(query: str) -> List[NumericConstraint]:
    lower = query.lower()
    out: List[NumericConstraint] = []

    for m in _BETWEEN_RE.finditer(lower):
        out.append(NumericConstraint(
            "between", _f(m.group(1)), _f(m.group(2)), m.group(0),
            _field_hint(lower, m.start()),
        ))
    for m in _RANGE_RE.finditer(lower):
        lo, hi = _f(m.group(1)), _f(m.group(2))
        if any(c.op == "between" and abs(c.value - lo) < 0.01
               and c.upper is not None and abs(c.upper - hi) < 0.01
               for c in out):
            continue  # already captured by the between pattern
        out.append(NumericConstraint(
            "between", lo, hi, m.group(0), _field_hint(lower, m.start())
        ))
    has_between = any(c.op == "between" for c in out)
    if not has_between:
        # reference skips lte/gte when a between was found (the bound
        # words are part of the range phrasing)
        for m in _LTE_RE.finditer(lower):
            out.append(NumericConstraint(
                "lte", _f(m.group(1)), None, m.group(0),
                _field_hint(lower, m.start()),
            ))
        for m in _GTE_RE.finditer(lower):
            out.append(NumericConstraint(
                "gte", _f(m.group(1)), None, m.group(0),
                _field_hint(lower, m.start()),
            ))
    for m in _EQ_RE.finditer(lower):
        out.append(NumericConstraint(
            "eq", _f(m.group(1)), None, m.group(0),
            _field_hint(lower, m.start()),
        ))
    return out


# ---------------------------------------------------------------------------
# String enum constraints (reference :304-392)
# ---------------------------------------------------------------------------

_SYNONYMS: List[Tuple[Tuple[str, ...], str]] = [
    (("men's", "mens", "for men", "male", "man's", "boys", "boy's"),
     "male"),
    (("women's", "womens", "for women", "female", "woman's", "girls",
      "girl's"), "female"),
    (("unisex", "gender neutral", "for everyone", "all genders"),
     "unisex"),
    (("kids", "children", "for kids", "child", "kid's", "children's"),
     "kids"),
]


def _match_synonym(query_lower: str, enum_value_lower: str) -> Optional[str]:
    for synonyms, target in _SYNONYMS:
        if target == enum_value_lower:
            for syn in synonyms:
                if syn in query_lower:
                    return syn
    return None


def extract_string_enum_constraints(
    query: str, filter_properties: Dict[str, Sequence[str]]
) -> List[StringEnumConstraint]:
    """Match query text against known schema enum values (+ synonyms)."""
    lower = query.lower()
    out: List[StringEnumConstraint] = []
    for field_name, values in (filter_properties or {}).items():
        for value in values:
            vl = str(value).lower()
            if vl and vl in lower:
                out.append(StringEnumConstraint(field_name, str(value),
                                                str(value)))
                continue
            syn = _match_synonym(lower, vl)
            if syn is not None:
                out.append(StringEnumConstraint(field_name, str(value), syn))
    return out


# ---------------------------------------------------------------------------
# Boolean constraints (reference :397-492)
# ---------------------------------------------------------------------------

_TRUE_PATTERNS = ("in stock", "available", "on sale", "active", "enabled",
                  "verified", "featured", "published", "approved")
_FALSE_PATTERNS = ("out of stock", "unavailable", "not on sale", "inactive",
                   "disabled", "not verified", "unpublished")

_BOOL_FIELD_GROUPS = (
    ("stock", "available", "availability"),
    ("sale", "discount", "offer"),
    ("active", "enabled", "published"),
)


def _match_bool_field(pattern: str, bool_fields: Sequence[str]) -> Optional[str]:
    for group in _BOOL_FIELD_GROUPS:
        if any(kw in pattern for kw in group):
            for f in bool_fields:
                if any(kw in f.lower() for kw in group):
                    return f
    if len(bool_fields) == 1:
        return bool_fields[0]
    return None


def extract_boolean_constraints(
    query: str, bool_fields: Sequence[str]
) -> List[BoolConstraint]:
    if not bool_fields:
        return []
    lower = query.lower()
    out: List[BoolConstraint] = []
    # negative phrases first: "out of stock" must not also emit the
    # "in stock"-family positives it contains textually
    claimed: List[str] = []
    for p in _FALSE_PATTERNS:
        if p in lower:
            out.append(BoolConstraint(False, p, _match_bool_field(p, bool_fields)))
            claimed.append(p)
    for p in _TRUE_PATTERNS:
        if p in lower and not any(p in c for c in claimed):
            out.append(BoolConstraint(True, p, _match_bool_field(p, bool_fields)))
    return out


# ---------------------------------------------------------------------------
# Combined extraction (reference :82)
# ---------------------------------------------------------------------------

def extract_constraints(
    query: str,
    filter_properties: Optional[Dict[str, Sequence[str]]] = None,
    bool_fields: Optional[Sequence[str]] = None,
) -> List[Constraint]:
    out: List[Constraint] = []
    out.extend(extract_numeric_constraints(query))
    if filter_properties:
        out.extend(extract_string_enum_constraints(query, filter_properties))
    if bool_fields:
        out.extend(extract_boolean_constraints(query, bool_fields))
    return out


# ---------------------------------------------------------------------------
# Field matching (reference :500-573)
# ---------------------------------------------------------------------------

def find_best_field_match(hint: str, fields: Sequence[str]) -> Optional[str]:
    hl = hint.lower()
    for f in fields:
        if f.lower() == hl:
            return f
    for f in fields:
        if hl in f.lower():
            return f
    for f in fields:
        if f.lower() in hl:
            return f
    return None


def match_numeric_constraints(
    constraints: Sequence[Constraint], number_fields: Sequence[str]
) -> List[Tuple[str, NumericConstraint]]:
    """Assign each numeric constraint to a schema number field: a single
    field takes everything; multiple disambiguate via context hints with
    a price-like fallback."""
    numeric = [c for c in constraints if isinstance(c, NumericConstraint)]
    if not numeric or not number_fields:
        return []
    if len(number_fields) == 1:
        return [(number_fields[0], c) for c in numeric]
    out: List[Tuple[str, NumericConstraint]] = []
    for c in numeric:
        if c.field_hint:
            f = find_best_field_match(c.field_hint, number_fields)
            if f is not None:
                out.append((f, c))
                continue
        price_like = next(
            (f for f in number_fields
             if any(k in f.lower() for k in ("price", "cost", "amount"))),
            None,
        )
        if price_like is not None:
            out.append((price_like, c))
    return out


# ---------------------------------------------------------------------------
# Prompt formatting (reference :578)
# ---------------------------------------------------------------------------

def format_constraints_for_prompt(
    constraints: Sequence[Constraint], number_fields: Sequence[str]
) -> str:
    if not constraints:
        return "No constraints detected."
    lines: List[str] = []
    for field_name, c in match_numeric_constraints(constraints, number_fields):
        if c.op == "between" and c.upper is not None:
            op_str = f"between {c.value} and {c.upper}"
        else:
            op_str = f"{c.op} {c.value}"
        lines.append(f'- {field_name}: {op_str} (from "{c.span}")')
    for c in constraints:
        if isinstance(c, StringEnumConstraint):
            lines.append(
                f'- {c.field_name}: "{c.matched_value}" (from "{c.span}", '
                f"matched to enum value)"
            )
    for c in constraints:
        if isinstance(c, BoolConstraint):
            f = c.field_hint or "(unknown field)"
            lines.append(f'- {f}: {str(c.value).lower()} (from "{c.span}")')
    return "\n".join(lines) if lines else "No constraints detected."


# ---------------------------------------------------------------------------
# Validation & injection (reference :658-797)
# ---------------------------------------------------------------------------

def _where_has_field(where: Optional[Dict[str, Any]], field_name: str) -> bool:
    if not where:
        return False
    for key, value in where.items():
        if key == "not":
            if _where_has_field(value, field_name):
                return True
        elif key in ("and", "or"):
            if any(_where_has_field(v, field_name) for v in value):
                return True
        elif key == field_name:
            return True
    return False


def validate_search_params(
    search_params: Dict[str, Any],
    constraints: Sequence[Constraint],
    number_fields: Sequence[str],
) -> List[Constraint]:
    """Constraints the LLM-composed params FAILED to carry (per field)."""
    where = search_params.get("where") or {}
    missing: List[Constraint] = []
    for field_name, c in match_numeric_constraints(constraints, number_fields):
        if not _where_has_field(where, field_name):
            missing.append(c)
    for c in constraints:
        if isinstance(c, StringEnumConstraint):
            if not _where_has_field(where, c.field_name):
                missing.append(c)
        elif isinstance(c, BoolConstraint) and c.field_hint:
            if not _where_has_field(where, c.field_hint):
                missing.append(c)
    return missing


def _num_value(v: float):
    return int(v) if float(v).is_integer() else float(v)


def inject_constraints(
    search_params: Dict[str, Any],
    missing: Sequence[Constraint],
    number_fields: Sequence[str],
) -> Dict[str, Any]:
    """Safety net: add every missing constraint to the where filter
    before the search executes (reference :732)."""
    if not missing:
        return search_params
    where = dict(search_params.get("where") or {})
    for field_name, c in match_numeric_constraints(missing, number_fields):
        if _where_has_field(where, field_name):
            continue
        if c.op == "between" and c.upper is not None:
            where[field_name] = {
                "between": [_num_value(c.value), _num_value(c.upper)]
            }
        else:
            where[field_name] = {c.op: _num_value(c.value)}
    for c in missing:
        if isinstance(c, StringEnumConstraint):
            if not _where_has_field(where, c.field_name):
                where[c.field_name] = c.matched_value
        elif isinstance(c, BoolConstraint) and c.field_hint:
            if not _where_has_field(where, c.field_hint):
                where[c.field_hint] = c.value
    out = dict(search_params)
    out["where"] = where
    return out


# ---------------------------------------------------------------------------
# Shared budget detection (reference :814)
# ---------------------------------------------------------------------------

_BUDGET_SIGNALS = ("budget", "total", "combined", "for both", "for all",
                   "altogether", "in total", "max for", "spend")
_BUDGET_NUMBER_RE = re.compile(
    rf"(?:under|below|max|budget|up\s+to|no\s+more\s+than)"
    rf"\s+(?:\w+\s+)*?{_CUR}{_NUM}", re.I,
)


def has_shared_budget(query: str) -> bool:
    """Budget language + multi-item coordination language."""
    lower = query.lower()
    return bool(_BUDGET_NUMBER_RE.search(lower)) and any(
        s in lower for s in _BUDGET_SIGNALS
    )


def shared_budget_amount(query: str) -> Optional[float]:
    """The shared budget amount, when the query implies one."""
    if not has_shared_budget(query):
        return None
    m = _BUDGET_NUMBER_RE.search(query.lower())
    return _f(m.group(1)) if m else None


# Back-compat helper used by the v1 autoquery path: True when the params
# already reflect every extracted constraint.
def validate_constraints(
    search_params: Dict[str, Any],
    constraints: Sequence[Constraint],
    number_fields: Sequence[str] = (),
) -> bool:
    if not constraints:
        return True
    nf = list(number_fields) or ["price"]
    return not validate_search_params(search_params, constraints, nf)
