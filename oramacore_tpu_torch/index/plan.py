"""Query planning for the port's BM25F paths.

`plan_query` is the JAX package's `StringIndex.plan_query`, and the body
of the port's `StringIndex.plan_query` (index/string_index.py). With
`with_prefix=True` it also collects the pruned tier's inputs: impact-prefix
nomination ranges (heavy committed terms point at their side blocks;
other committed ranges and live ranges are covered whole, live ones
clipped at PREFIX_LEN), each main range's field ordinal and span ordinal,
and each token's spans. With-prefix plans are not coalesced: a merged
cross-field range would break the per-range doc-sorted order the rescores
rely on.

`query_tokens` is the read side's token loop in front of the planner
(`_plan_fulltext` and the batched planner of oramacore_tpu/read): a query
term's parsed tokens become the planner's token list.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.bm25 import MAX_RANGE_LEN
from . import string_index as _si
from .string_index import DEFAULT_B, QueryPlan, StringIndex, _coalesce_and_cap

Range = Tuple[int, int, float, float, float]  # start, len, weight, b, avg


def _fill(ranges_per_token: List[List[Range]]):
    """(starts, lens, weights, field_b, avg_flen, max_len) padded to (T, NR)."""
    T = max(1, len(ranges_per_token))
    NR = max(1, max((len(r) for r in ranges_per_token), default=1))
    starts = np.zeros((T, NR), np.int32)
    lens = np.zeros((T, NR), np.int32)
    weights = np.zeros((T, NR), np.float32)
    field_b = np.full((T, NR), DEFAULT_B, np.float32)
    avg_flen = np.ones((T, NR), np.float32)
    max_len = 1
    for ti, ranges in enumerate(ranges_per_token):
        for ri, (s, l, w, b, avg) in enumerate(ranges):
            starts[ti, ri] = s
            lens[ti, ri] = l
            weights[ti, ri] = w
            field_b[ti, ri] = b
            avg_flen[ti, ri] = avg
            max_len = max(max_len, l)
    return starts, lens, weights, field_b, avg_flen, max_len


def query_tokens(parser, term: str, exact: bool) -> List[str]:
    """The tokens a full-text query plans on: each surface token of
    `parser.tokenize_and_stem(term)`, followed by its stem variants
    unless `exact`; `[""]` when the term has no token."""
    tokens: List[str] = []
    for t, variants in parser.tokenize_and_stem(term):
        tokens.append(t)
        if not exact:
            tokens.extend(variants)
    return tokens or [""]


def plan_query(
    index: StringIndex,
    tokens: Sequence[str],
    properties: Sequence[str],
    boost: Dict[str, float],
    tolerance: Optional[int] = None,
    impact_cap: Optional[int] = None,
    field_params: Optional[Dict[str, Tuple[float, float]]] = None,
    token_weights: Optional[Sequence[float]] = None,
    use_champions: bool = False,
    with_prefix: bool = False,
) -> QueryPlan:
    """Padded range descriptors (T, NR) for the scoring kernels; the same
    plan `index.plan_query(...)` of the JAX package builds."""
    if index._dirty or index._slab_committed is None:
        index._build_slab()
    prefix_len = _si.PREFIX_LEN

    per_token: List[List[Range]] = []
    per_token_ford: List[List[int]] = []
    per_token_spanord: List[List[int]] = []
    per_token_pre: List[List[Range]] = []
    per_token_spans: List[List[Tuple[int, int, int, int]]] = []
    per_token_champs: List[List[Tuple[int, float]]] = []
    for ti, token in enumerate(tokens):
        tw = token_weights[ti] if token_weights is not None else 1.0
        ranges: List[Range] = []
        fords: List[int] = []
        span_ords: List[int] = []
        pre: List[Range] = []
        spans: List[Tuple[int, int, int, int]] = []
        champs: List[Tuple[int, float]] = []
        term_ord = 0
        for ford, path in enumerate(properties):
            stats = index._stats.get(path)
            if stats is None or stats.doc_count == 0:
                continue
            fw, fb = (field_params or {}).get(path, (1.0, DEFAULT_B))
            w = boost.get(path, 1.0) * fw * tw
            avg = stats.avg_len if stats.avg_len > 0 else 1.0
            # champion row: the heavy committed range becomes one dense
            # row-add, valid only when the baked params match
            champ_skip = None
            if use_champions and not tolerance:
                ci = index._champ_map.get((path, token))
                if ci is not None and abs(fb - DEFAULT_B) < 1e-9:
                    c_avg, covered = index._champ_meta[ci]
                    if abs(c_avg - avg) < 1e-6 * max(avg, 1.0):
                        champs.append((ci, w))
                        champ_skip = covered
            for term, cr, lr in index._match_terms_detail(
                path, token, tolerance
            ):
                span_base = len(spans)
                if with_prefix:
                    for (ps, pl) in index._slab_prefix_ranges.get(
                            (path, term), ()):
                        pre.append((ps, pl, w, fb, avg))
                    for (rs, rl) in cr:
                        # committed ranges > PREFIX_LEN have a block
                        if rl <= prefix_len:
                            pre.append((rs, rl, w, fb, avg))
                    for (rs, rl) in lr:
                        pre.append((rs, min(rl, prefix_len), w, fb, avg))
                    for (rs, rl) in list(cr) + list(lr):
                        spans.append((ford, term_ord, rs, rl))
                for si, (start, length) in enumerate(list(cr) + list(lr)):
                    if champ_skip is not None and \
                            (start, length) in champ_skip:
                        continue  # covered by the champion row
                    if impact_cap is not None and length > impact_cap:
                        length = impact_cap
                    so = span_base + si if with_prefix else -1
                    # split over-long ranges: device slices stay bounded
                    while length > MAX_RANGE_LEN:
                        ranges.append((start, MAX_RANGE_LEN, w, fb, avg))
                        fords.append(ford)
                        span_ords.append(so)
                        start += MAX_RANGE_LEN
                        length -= MAX_RANGE_LEN
                    ranges.append((start, length, w, fb, avg))
                    fords.append(ford)
                    span_ords.append(so)
                term_ord += 1
        if with_prefix:
            per_token.append(ranges)
            per_token_ford.append(fords)
            per_token_spanord.append(span_ords)
            per_token_pre.append(_coalesce_and_cap(pre, token))
        else:
            per_token.append(_coalesce_and_cap(ranges, token))
        per_token_spans.append(spans)
        per_token_champs.append(champs)

    starts, lens, weights, field_b, avg_flen, max_len = _fill(per_token)
    T, NR = starts.shape
    champ_idx = champ_w = None
    if any(per_token_champs):
        NC = max(len(c) for c in per_token_champs)
        champ_idx = np.full((T, NC), -1, np.int32)
        champ_w = np.zeros((T, NC), np.float32)
        for ti, champs in enumerate(per_token_champs):
            for cj, (ci, w) in enumerate(champs):
                champ_idx[ti, cj] = ci
                champ_w[ti, cj] = w
    plan = QueryPlan(
        starts=starts,
        lens=lens,
        weights=weights,
        field_b=field_b,
        avg_flen=avg_flen,
        n_tokens=len(tokens),
        max_range_len=max_len,
        champ_idx=champ_idx,
        champ_w=champ_w,
    )
    if with_prefix:
        plan.range_field = np.full((T, NR), -1, np.int32)
        plan.range_span = np.full((T, NR), -1, np.int32)
        for ti, (fords, sords) in enumerate(zip(per_token_ford,
                                                per_token_spanord)):
            plan.range_field[ti, :len(fords)] = fords
            plan.range_span[ti, :len(sords)] = sords
        (plan.pre_starts, plan.pre_lens, plan.pre_weights, plan.pre_field_b,
         plan.pre_avg, _) = _fill(per_token_pre)
        plan.spans = per_token_spans
    return plan
