"""Top-k selection for the port (counterpart of oramacore_tpu/ops/vector.py).

Only the selection is ported so far (`topk_2level`, and `top_k_by_key`
for the sort-by pages); the vector-search functions of the JAX module
are still to come.
"""

from __future__ import annotations

import torch


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k` along the last axis with its tie rule: among equal
    values the lower index comes first. `torch.topk` promises no order
    for ties, so this selects with a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_by_key(x: torch.Tensor, k: int):
    """`lax.top_k` of f32 `x` along the last axis, in its exact order:
    IEEE total order of the values (so +0.0 ranks above -0.0, as
    `lax.top_k` ranks them), then the lower index first among equal
    values. One `torch.topk` over unique int64 keys does it: the
    order-preserving bits of each value in the high 32 bits, `n-1-index`
    in the low ones. Returns (values f32[..., k], indices int64[..., k])."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # signed int order == float order
    rev = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    _, idx = torch.topk(ordered.to(torch.int64) * (1 << 32) + rev, k, dim=-1)
    return x.gather(-1, idx), idx


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
