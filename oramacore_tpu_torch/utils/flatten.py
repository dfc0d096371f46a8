"""Document JSON flattening and field type inference (the port's copy
of oramacore_tpu/utils/flatten.py, unchanged in behaviour).

Mirrors the semantics of the reference's automatic field discovery
(`Index::add_fields_if_needed` write/index/mod.rs:589 and the per-type
indexers in write/index/fields.rs:115-533):

- nested objects flatten to dot-joined paths ("a.b.c")
- arrays of strings are string fields (each element indexed)
- arrays of numbers are number fields (each element indexed)
- strings whose length is < 25 chars are ALSO filterable enums
  (EnumStrategy::StringLength(25), fields.rs:357-367)
- {"lat": .., "lon": ..} objects are geopoints
- date detection is NOT automatic (dates are declared or filter-typed)
- the reserved top-level "_omc" numeric field is a score multiplier
  (write/index/mod.rs:451-458), not an indexed field
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

ENUM_MAX_LEN = 25  # reference EnumStrategy default StringLength(25)
OMC_FIELD = "_omc"


def is_geopoint_shape(value: Any) -> bool:
    return (
        isinstance(value, dict)
        and set(value.keys()) == {"lat", "lon"}
        and all(isinstance(value[k], (int, float)) and not isinstance(value[k], bool) for k in ("lat", "lon"))
    )


def flatten_document(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten nested objects into dot-joined paths. Arrays and geopoints
    are kept as leaf values."""
    out: Dict[str, Any] = {}

    def rec(prefix: str, value: Any):
        if isinstance(value, dict) and not is_geopoint_shape(value):
            for k, v in value.items():
                rec(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[prefix] = value

    rec("", doc)
    return out


# Field type constants (string values so they serialize naturally)
T_STRING = "string"
T_NUMBER = "number"
T_BOOL = "bool"
T_DATE = "date"
T_GEO = "geopoint"
T_STRING_ARRAY = "string[]"
T_NUMBER_ARRAY = "number[]"
T_EMBEDDING = "embedding"


import re as _re

# strict ISO-like shapes only (YYYY-MM-DD with optional time); loose
# matches like "2024" or "1.2.3" must stay plain strings
_DATE_SHAPE_RE = _re.compile(
    r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$"
)


def looks_like_date(s: str) -> bool:
    """String-shaped date detection (reference: a string field whose
    value parses as OramaDate becomes a DATE filter field while staying
    a string score field — write/index/mod.rs:812)."""
    if not _DATE_SHAPE_RE.match(s.strip()):
        return False
    from ..types import parse_date_to_epoch_ms

    try:
        parse_date_to_epoch_ms(s)
        return True
    except (ValueError, TypeError):
        return False


def infer_field_type(value: Any) -> Optional[str]:
    """Infer the index type for one flattened leaf value.

    Returns None for unindexable values (null, empty arrays, mixed arrays).
    """
    if value is None:
        return None
    if isinstance(value, bool):
        return T_BOOL
    if isinstance(value, (int, float)):
        return T_NUMBER
    if isinstance(value, str):
        return T_DATE if looks_like_date(value) else T_STRING
    if is_geopoint_shape(value):
        return T_GEO
    if isinstance(value, list):
        if not value:
            return None
        if all(isinstance(v, str) for v in value):
            return T_STRING_ARRAY
        if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in value):
            return T_NUMBER_ARRAY
        return None
    return None


def string_values(value: Any) -> List[str]:
    """Extract the string(s) carried by a string/string[] leaf."""
    if isinstance(value, str):
        return [value]
    if isinstance(value, list):
        return [v for v in value if isinstance(v, str)]
    return []


def number_values(value: Any) -> List[float]:
    if isinstance(value, bool):
        return []
    if isinstance(value, (int, float)):
        return [float(value)]
    if isinstance(value, list):
        return [float(v) for v in value if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return []


def is_filterable_enum(value: Any) -> bool:
    """Strings shorter than ENUM_MAX_LEN are also indexed as filterable
    enum values (reference fields.rs:357-367)."""
    if isinstance(value, str):
        return len(value) < ENUM_MAX_LEN
    if isinstance(value, list):
        return all(isinstance(v, str) and len(v) < ENUM_MAX_LEN for v in value) and bool(value)
    return False


def extract_omc(flat: Dict[str, Any]) -> Optional[float]:
    """Extract the `_omc` score-multiplier value if present and numeric."""
    v = flat.get(OMC_FIELD)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return None


def all_string_properties_text(flat: Dict[str, Any]) -> List[Tuple[str, str]]:
    """(path, text) pairs for every string-bearing field — used for
    embedding input when DocumentFields::AllStringProperties."""
    out: List[Tuple[str, str]] = []
    for path, value in flat.items():
        if path == OMC_FIELD:
            continue
        for s in string_values(value):
            if s:
                out.append((path, s))
    return out
