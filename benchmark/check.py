"""The comparison that decides `correct`: the window's answers against the
plain reference (`reference.py`), and each number beside its limit.

A sample of the queries the window answered, drawn from the seed, with
the query of most postings in it, is scored again by the reference over
every document. For each query, with `v` the program's top-k values, `ids`
its doc ids, `top1` the reference's best score:

- `score_err`: the largest |v_j - ref(ids_j)| / top1 over the results
  (the distance to the reference's interval [lo, hi] where a cosine lies
  within rounding of the threshold); a returned doc that does not match
  reads 1.
- `topk_gap`: how far the returned set falls short of the reference's
  top-k: (the reference's n-th best - the worst returned doc's reference
  score) / top1, at least 0, where n is the number of results returned;
  a doc returned twice reads 1.
- `count_off`: the queries whose match count, or whose number of
  results, differs from the reference's (lies outside [n_lo, n_hi]).

The limits of each cell live in `limits/<workload>.json`, with the
readings they were set from.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NUMBERS = ("score_err", "topk_gap", "count_off")


def load_limits(workload: str) -> Dict[str, float]:
    with open(LIMITS_DIR / f"{workload}.json") as f:
        lim = json.load(f)["limits"]
    return {name: float(lim[name]) for name in NUMBERS}


def sample_queries(n_total: int, n_pick: int, must: int,
                   rng: np.random.Generator) -> List[int]:
    """n_pick distinct query positions of the window, `must` among them."""
    n_pick = min(n_pick, n_total)
    pick = rng.choice(n_total, size=n_pick, replace=False).tolist()
    if must not in pick:
        pick[-1] = must
    return sorted(set(pick))


def compare_query(vals: np.ndarray, ids: np.ndarray, count: int, lo, hi,
                  n_lo: int, n_hi: int, k: int) -> Dict[str, float]:
    """The three numbers for one query (count_off 0 or 1)."""
    n_ret = int(np.isfinite(vals).sum())
    lo_h = lo.cpu().numpy()
    hi_h = hi.cpu().numpy()
    top1 = float(np.max(hi_h)) if np.isfinite(hi_h).any() else 1.0
    top1 = top1 if top1 > 0 else 1.0
    off = int(not (n_lo <= count <= n_hi)
              or not (min(k, n_lo) <= n_ret <= min(k, n_hi))
              or not np.all(np.isfinite(vals[:n_ret])))
    if n_ret == 0:
        return {"score_err": 0.0, "topk_gap": 0.0, "count_off": off}
    got = ids[:n_ret].astype(np.int64)
    if got.min() < 0 or got.max() >= len(lo_h):
        return {"score_err": 1.0, "topk_gap": 1.0, "count_off": off}
    r_lo, r_hi = lo_h[got], hi_h[got]
    v = vals[:n_ret].astype(np.float64)
    dist = np.maximum(np.maximum(r_lo - v, v - r_hi), 0.0)
    dist = np.where(np.isfinite(r_hi), dist, top1)   # not a match
    err = float(dist.max()) / top1
    if len(set(got.tolist())) != n_ret:
        gap = 1.0
    else:
        nth = float(torch.topk(lo, n_ret).values[-1])
        worst = float(np.min(r_hi))
        if not np.isfinite(worst):
            gap = 1.0
        elif not np.isfinite(nth):     # fewer sure matches: count_off says
            gap = 0.0
        else:
            gap = max(0.0, nth - worst) / top1
    return {"score_err": min(err, 1.0), "topk_gap": min(gap, 1.0),
            "count_off": off}


def compare(results: Sequence, ref_scores: Sequence, k: int) -> Dict[str, float]:
    """The cell's numbers over the checked queries: results[i] is the
    program's (vals, ids, count) of query i, ref_scores[i] the reference's
    (lo, hi, n_lo, n_hi)."""
    out = {"score_err": 0.0, "topk_gap": 0.0, "count_off": 0}
    for (vals, ids, count), (lo, hi, n_lo, n_hi) in zip(results, ref_scores):
        q = compare_query(vals, ids, int(count), lo, hi, n_lo, n_hi, k)
        out["score_err"] = max(out["score_err"], q["score_err"])
        out["topk_gap"] = max(out["topk_gap"], q["topk_gap"])
        out["count_off"] += q["count_off"]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) in NUMBERS order."""
    shown = {name: {"value": numbers[name], "limit": limits[name]}
             for name in NUMBERS}
    ok = all(numbers[name] <= limits[name] for name in NUMBERS)
    return ok, shown


def malformed_rows(vals: np.ndarray, ids: np.ndarray, n_docs: int) -> int:
    """Queries of one batch whose result row cannot be an answer: a NaN,
    values out of order, or a finite result with a doc id out of range."""
    fin = np.isfinite(vals)
    bad = np.isnan(vals).any(axis=1)
    bad |= (np.diff(np.where(fin, vals, -np.inf), axis=1) > 0).any(axis=1)
    bad |= (fin & ((ids < 0) | (ids >= n_docs))).any(axis=1)
    return int(bad.sum())
