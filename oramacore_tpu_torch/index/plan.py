"""Query planning for the port's dense BM25F path.

`plan_query` is the dense branch (`with_prefix=False`) of the JAX
package's `StringIndex.plan_query`, and the body of the port's
`StringIndex.plan_query` (index/string_index.py). The pruned tier's
`with_prefix` branch is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.bm25 import MAX_RANGE_LEN
from .string_index import DEFAULT_B, QueryPlan, StringIndex, _coalesce_and_cap

Range = Tuple[int, int, float, float, float]  # start, len, weight, b, avg


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
) -> QueryPlan:
    """Padded range descriptors (T, NR) for the scoring kernels; the same
    plan `index.plan_query(..., with_prefix=False)` builds."""
    if index._dirty or index._slab_committed is None:
        index._build_slab()

    per_token: List[List[Range]] = []
    per_token_champs: List[List[Tuple[int, float]]] = []
    for ti, token in enumerate(tokens):
        tw = token_weights[ti] if token_weights is not None else 1.0
        ranges: List[Range] = []
        champs: List[Tuple[int, float]] = []
        for path in properties:
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
            for _term, cr, lr in index._match_terms_detail(
                path, token, tolerance
            ):
                for start, length in list(cr) + list(lr):
                    if champ_skip is not None and \
                            (start, length) in champ_skip:
                        continue  # covered by the champion row
                    if impact_cap is not None and length > impact_cap:
                        length = impact_cap
                    # split over-long ranges: device slices stay bounded
                    while length > MAX_RANGE_LEN:
                        ranges.append((start, MAX_RANGE_LEN, w, fb, avg))
                        start += MAX_RANGE_LEN
                        length -= MAX_RANGE_LEN
                    ranges.append((start, length, w, fb, avg))
        per_token.append(_coalesce_and_cap(ranges, token))
        per_token_champs.append(champs)

    T = max(1, len(per_token))
    NR = max(1, max((len(r) for r in per_token), default=1))
    starts = np.zeros((T, NR), np.int32)
    lens = np.zeros((T, NR), np.int32)
    weights = np.zeros((T, NR), np.float32)
    field_b = np.full((T, NR), DEFAULT_B, np.float32)
    avg_flen = np.ones((T, NR), np.float32)
    max_len = 1
    for ti, ranges in enumerate(per_token):
        for ri, (s, l, w, b, avg) in enumerate(ranges):
            starts[ti, ri] = s
            lens[ti, ri] = l
            weights[ti, ri] = w
            field_b[ti, ri] = b
            avg_flen[ti, ri] = avg
            max_len = max(max_len, l)
    champ_idx = champ_w = None
    if any(per_token_champs):
        NC = max(len(c) for c in per_token_champs)
        champ_idx = np.full((T, NC), -1, np.int32)
        champ_w = np.zeros((T, NC), np.float32)
        for ti, champs in enumerate(per_token_champs):
            for cj, (ci, w) in enumerate(champs):
                champ_idx[ti, cj] = ci
                champ_w[ti, cj] = w
    return QueryPlan(
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
