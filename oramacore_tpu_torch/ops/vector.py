"""Top-k selection for the port (counterpart of oramacore_tpu/ops/vector.py).

Only `topk_2level` is ported so far; the vector-search functions of the
JAX module are still to come.
"""

from __future__ import annotations

import torch


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k` along the last axis with its tie rule: among equal
    values the lower index comes first. `torch.topk` promises no order
    for ties, so this selects with a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_2level(s: torch.Tensor, k: int, group: int = 128):
    """Exact top-k via two-level selection, as `oramacore_tpu`'s
    `topk_2level`: the maxima of `group`-wide groups pick k groups, and
    only those k * group candidates are ranked. Ties order by group rank,
    then by position in the group, exactly as the JAX function's.

    s: f32[B, n]. Returns (values f32[B, k], indices int32[B, k])."""
    B, n = s.shape
    if n < 16384 or n % group or n // group < k:
        vals, idx = _top_k(s, k)
        return vals, idx.to(torch.int32)
    sg = s.view(B, n // group, group)
    _, gi = _top_k(sg.amax(dim=2), k)                        # (B, k) groups
    cand = torch.gather(sg, 1, gi[:, :, None].expand(B, k, group))
    cv, ci = _top_k(cand.reshape(B, k * group), k)
    grp = torch.gather(gi, 1, ci // group)
    return cv, (grp * group + ci % group).to(torch.int32)
