"""The write side's per-document op body and embedding text (the port's
copy of `WriteSide._build_doc_op` and `WriteSide._embedding_text`,
oramacore_tpu/write/__init__.py), as plain functions over an explicit
field-type registry and the index's embedding settings.

`build_doc_op` returns exactly the JAX body of an `index_document` op
(`doc_id`, `user_id`, `strings_packed`, `numbers`, `bools`,
`string_filters`, `geos`, `dates`, `omc`, `raw`); the write side does the
tokenization, so the read side applies pre-parsed values:
`strings_packed[path]` is `[n_surface_tokens, payload]` in the wire
format that `StringIndex.index_text_packed` takes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..types import parse_date_to_epoch_ms
from ..utils.flatten import (
    OMC_FIELD,
    T_BOOL,
    T_DATE,
    T_GEO,
    T_NUMBER,
    T_NUMBER_ARRAY,
    T_STRING,
    T_STRING_ARRAY,
    extract_omc,
    infer_field_type,
    is_filterable_enum,
    number_values,
    string_values,
)


def build_doc_op(
    field_types: Dict[str, str],
    parser,
    internal: int,
    user_id: str,
    flat: Dict[str, Any],
    raw_doc: Dict[str, Any],
    token_cache: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Tokenize and type each field value of one flattened document into
    its op body. `field_types` maps a path to the type the index
    discovered for it (`utils.flatten.infer_field_type` decides for a
    path it lacks); `parser` is the index's `TextParser`; `token_cache`
    maps a string to its `tokenize_and_stem_packed` result."""
    strings: Dict[str, List[Any]] = {}  # path -> [n_tokens, payload]
    numbers: Dict[str, List[float]] = {}
    bools: Dict[str, bool] = {}
    string_filters: Dict[str, List[str]] = {}
    geos: Dict[str, List[float]] = {}
    dates: Dict[str, List[int]] = {}
    for path, value in flat.items():
        if path == OMC_FIELD:
            continue
        t = field_types.get(path) or infer_field_type(value)
        if t in (T_STRING, T_STRING_ARRAY, T_DATE):
            texts = string_values(value)
            n_total = 0
            payloads: List[str] = []
            for s in texts:
                cached = token_cache.get(s) if token_cache else None
                if cached is None:
                    cached = parser.tokenize_and_stem_packed(s)
                n_total += cached[0]
                if cached[1]:
                    payloads.append(cached[1])
            strings[path] = [n_total, "\x02".join(payloads)]
            if t == T_DATE:
                # a date-shaped string is ALSO a date filter column; the
                # string score field is kept beside it
                try:
                    dates[path] = [parse_date_to_epoch_ms(s) for s in texts]
                except (ValueError, TypeError):
                    pass  # a later non-date value: string side only
            elif path != "id" and is_filterable_enum(value):
                string_filters[path] = texts
        elif t in (T_NUMBER, T_NUMBER_ARRAY):
            numbers[path] = number_values(value)
        elif t == T_BOOL:
            bools[path] = bool(value)
        elif t == T_GEO:
            geos[path] = [float(value["lat"]), float(value["lon"])]
    return {
        "doc_id": internal,
        "user_id": user_id,
        "strings_packed": strings,
        "numbers": numbers,
        "bools": bools,
        "string_filters": string_filters,
        "geos": geos,
        "dates": dates,
        "omc": extract_omc(flat),
        "raw": raw_doc,
    }


def embedding_text(
    flat: Dict[str, Any],
    embedding_fields: Sequence[str] = (),
    automatic_embeddings: bool = True,
) -> str:
    """The text to embed (the reference's DocumentFields semantics): the
    listed source paths' strings, or, with none listed and automatic
    embeddings on, every string field but `id` and `_omc`; "" for none."""
    if not automatic_embeddings and not embedding_fields:
        return ""
    parts: List[str] = []
    if embedding_fields:
        for p in embedding_fields:
            parts.extend(string_values(flat.get(p)))
    else:
        for path, v in flat.items():
            if path in ("id", OMC_FIELD):
                continue
            parts.extend(string_values(v))
    return " ".join(x for x in parts if x)
