"""Vector similarity search and top-k selection for the port (counterpart
of oramacore_tpu/ops/vector.py).

Numerics follow the JAX functions: queries (and centroids) are rounded to
bf16 at every product, corpus rows are bf16 (or int8) on the device, and
every product accumulates in f32. A torch bf16 matmul would round its
OUTPUT to bf16 and reorder the top-k, so the bf16 operands are upcast to
f32 (exactly) and multiplied in f32 with TF32 off (`require_cuda`).
Int8 rows cast exactly to f32 and the per-row scale multiplies the dot
afterwards, as in the JAX functions.

Invalid rows score NEG_INF (-1e30), not -inf: callers test `s <= -1e29`.

Selection keeps `lax.top_k`'s tie rule (lower index first, `_top_k`), and
every scan keeps the JAX chunk structure: a per-chunk `topk_2level`
merged into a running (B, k) carry orders ties by group rank, which one
top-k over the whole row would not.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# f32 elements of upcast int8 / bf16 tiles that one step of a probe scan
# materialises (1 GiB): bounds memory at any batch, nprobe and window
_SCAN_ELEMS = 1 << 28


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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), held as f32."""
    return x.to(torch.bfloat16).float()


def _merge(vals, rows, tv, ti, k: int):
    """Merge a chunk's (B, k) top-k into the running carry: `lax.top_k`
    over [carry, chunk], so the carry wins ties."""
    new_v, sel = _top_k(torch.cat([vals, tv], dim=1), k)
    return new_v, torch.cat([rows, ti], dim=1).gather(1, sel)


def _carry(B: int, k: int, device):
    return (torch.full((B, k), NEG_INF, dtype=torch.float32, device=device),
            torch.full((B, k), -1, dtype=torch.int32, device=device))


def _chunked_topk(q, n: int, chunk: int, k: int, score):
    """The JAX chunk scan: per chunk, `score(rows slice)` gives f32[B,
    chunk] (NEG_INF where invalid), `topk_2level` selects, and the result
    merges into the carry. Returns (vals f32[B, k], rows int32[B, k])."""
    if n % chunk:
        raise ValueError("matrix rows must be padded to a chunk multiple")
    vals, rows = _carry(q.shape[0], k, q.device)
    for i in range(n // chunk):
        tv, ti = topk_2level(score(slice(i * chunk, (i + 1) * chunk)), k)
        vals, rows = _merge(vals, rows, tv, ti + i * chunk, k)
    return vals, rows


def flat_cosine_topk(
    queries: torch.Tensor,    # f32[B, D] L2-normalized query vectors
    matrix: torch.Tensor,     # bf16[N, D] L2-normalized corpus rows (padded)
    row_valid: torch.Tensor,  # bool[N] False for padding / filtered rows
    *,
    k: int,
    chunk: int = 65536,
):
    """Exact cosine top-k rows. Returns (scores f32[B, k], rows int32[B, k]).
    Only one chunk of the slab is upcast to f32 at a time."""
    q = _bf16(queries)

    def score(sl):
        s = q @ matrix[sl].float().T                        # (B, chunk)
        return s.masked_fill_(~row_valid[sl][None, :], NEG_INF)

    return _chunked_topk(q, matrix.shape[0], chunk, k, score)


def flat_cosine_topk_filtered(
    queries: torch.Tensor,    # f32[B, D]
    matrix: torch.Tensor,     # bf16[N, D]
    row_doc: torch.Tensor,    # int32[N] doc id per row (multi-vector docs)
    doc_mask: torch.Tensor,   # bool[cap] filter mask over doc ids
    row_valid: torch.Tensor,  # bool[N]
    *,
    k: int,
    chunk: int = 65536,
):
    """Top-k with a doc-level filter mask pushed down to rows."""
    mask_by_row = doc_mask[row_doc.clamp(0, doc_mask.shape[0] - 1).long()]
    return flat_cosine_topk(
        queries, matrix, row_valid & mask_by_row, k=k, chunk=chunk
    )


# ---------------------------------------------------------------------------
# int8 quantized corpus: per-row symmetric int8 rows (v ~= scale * q_i8),
# scored as scale * dot(bf16(q), q_i8). The IVF layout packs rows by
# cluster; probe units are cluster sub-blocks of `window` rows.
# ---------------------------------------------------------------------------

def quantize_rows_int8(rows: torch.Tensor):
    """Per-row symmetric int8 quantization. Returns (q int8[N, D],
    scale f32[N]); torch.round rounds half to even, as jnp.round does."""
    amax = rows.abs().amax(dim=1)
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.round(rows / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_scan_topk(
    queries: torch.Tensor,   # f32[B, D] L2-normalized
    mat_i8: torch.Tensor,    # int8[N, D] quantized rows (padded rows scale 0)
    scales: torch.Tensor,    # f32[N] per-row scales (0 = padding)
    *,
    k: int,
    chunk: int = 524288,
):
    """Exact top-k over the whole quantized corpus, chunk by chunk."""
    q = _bf16(queries)

    def score(sl):
        sc = scales[sl][None, :]
        s = (q @ mat_i8[sl].float().T) * sc
        return s.masked_fill_(~(sc > 0), NEG_INF)

    return _chunked_topk(q, mat_i8.shape[0], chunk, k, score)


def _probe_units(queries, centroids, nprobe: int):
    """(B, nprobe) int64 ids of the best centroids by bf16 dot; among
    equal dots the lower id first (`lax.top_k`)."""
    return _top_k(_bf16(queries) @ _bf16(centroids).T, nprobe)[1]


def _scan_windows(q, starts, n: int, window: int, k: int, score):
    """Top-k over the windows `[starts[b, p], + window)` of each query, in
    probe order, as the JAX per-query `lax.scan` computes it.

    The scan merges [carry, window] with `lax.top_k` from k (NEG_INF, -1)
    slots; that equals ONE stable top-k over [k initial slots, window 0,
    window 1, ...], which is what this computes. Rows are read from
    `clamp(start, 0, n - window)` (as `lax.dynamic_slice` clamps) and
    reported as `start + i`. A row covered by two windows comes back
    twice, as in JAX.

    score(idx int64[m, window], q_sel f32[m, D], b int64[m]) gives f32[m,
    window] for m (query, probe) pairs, NEG_INF where a row is invalid.
    The pairs go in steps whose upcast tiles hold at most _SCAN_ELEMS f32
    elements. Returns (vals f32[B, k], rows int32[B, k])."""
    B, P = starts.shape
    D = q.shape[1]
    dev = q.device
    iota = torch.arange(window, device=dev)
    first = starts.reshape(-1).long()
    data = first.clamp(max=n - window).clamp(min=0)
    qidx = torch.arange(B, device=dev).repeat_interleave(P)
    s = torch.empty((B * P, window), dtype=torch.float32, device=dev)
    step = max(1, _SCAN_ELEMS // (window * D))
    for m0 in range(0, B * P, step):
        m = slice(m0, min(m0 + step, B * P))
        s[m] = score(data[m, None] + iota, q[qidx[m]], qidx[m])
    init_v, init_r = _carry(B, k, dev)
    rows = (first[:, None] + iota).view(B, P * window)
    vals, sel = _top_k(torch.cat([init_v, s.view(B, P * window)], dim=1), k)
    rows = torch.cat([init_r, rows.to(torch.int32)], dim=1).gather(1, sel)
    return vals, rows


def _int8_window_score(mat_i8, scales, q_sel, idx):
    """(m, window) scale * dot(q, int8 row) over gathered window rows."""
    tile = mat_i8[idx].float()                               # (m, w, D)
    sc = scales[idx]
    s = torch.bmm(tile, q_sel[:, :, None]).squeeze(2) * sc
    return s, sc > 0


def ivf_int8_topk(
    queries: torch.Tensor,         # f32[B, D] L2-normalized
    mat_i8: torch.Tensor,          # int8[N, D] rows PACKED by cluster
    scales: torch.Tensor,          # f32[N]
    unit_centroids: torch.Tensor,  # f32[U, D] sub-block centroids
    unit_starts: torch.Tensor,     # int32[U] packed start row of each unit
    *,
    k: int,
    nprobe: int,
    window: int,                   # rows scanned per probed unit
):
    """Clustered search over the packed int8 corpus: each query scans the
    windows of its top-nprobe units (a window start is clamped to
    N - window, so it may overrun into the next unit)."""
    return ivf_int8_topk_masked(
        queries, mat_i8, scales, None, unit_centroids, unit_starts, None,
        k=k, nprobe=nprobe, window=window, has_mask=False,
    )


def ivf_int8_topk_masked(
    queries: torch.Tensor,         # f32[B, D] L2-normalized
    mat_i8: torch.Tensor,          # int8[N, D] rows packed by cluster
    scales: torch.Tensor,          # f32[N] (0 = padding)
    row_doc,                       # int32[N] doc id per row (has_mask)
    unit_centroids: torch.Tensor,  # f32[U, D]
    unit_starts: torch.Tensor,     # int32[U]
    doc_mask,                      # bool[B, cap] per-query filter (has_mask)
    *,
    k: int,
    nprobe: int,
    window: int,
    has_mask: bool,
):
    """`ivf_int8_topk` with a PER-QUERY doc-level filter pushed down into
    the probe scan (the hybrid path's per-query where-filters)."""
    n = mat_i8.shape[0]
    probe = _probe_units(queries, unit_centroids, nprobe)
    starts = unit_starts.long()[probe].clamp(max=n - window)
    if has_mask:
        cap = doc_mask.shape[1]

    def score(idx, q_sel, b):
        s, keep = _int8_window_score(mat_i8, scales, q_sel, idx)
        if has_mask:
            docs = row_doc[idx].clamp(0, cap - 1).long()
            keep &= doc_mask[b[:, None], docs]
        return s.masked_fill_(~keep, NEG_INF)

    return _scan_windows(_bf16(queries), starts, n, window, k, score)


def l2_normalize(x, axis=-1, eps=1e-12):
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, eps)


# ---------------------------------------------------------------------------
# IVF over a bf16 slab with padded cluster blocks (kept for parity with
# the JAX module; VectorIndex probes the int8 layout instead)
# ---------------------------------------------------------------------------

def top_centroids(
    queries: torch.Tensor,    # f32[B, D] normalized
    centroids: torch.Tensor,  # f32[C, D] normalized
    *,
    nprobe: int,
):
    """(scores f32[B, nprobe], centroid ids int64[B, nprobe])."""
    return _top_k(_bf16(queries) @ _bf16(centroids).T, nprobe)


def ivf_gather_topk(
    queries: torch.Tensor,      # f32[B, D]
    matrix: torch.Tensor,       # bf16[N, D] rows grouped by cluster
    row_valid: torch.Tensor,    # bool[N]
    list_starts: torch.Tensor,  # int32[C] start row of each cluster block
    probe_ids: torch.Tensor,    # int32[B, nprobe] clusters to scan per query
    *,
    k: int,
    rows_per_probe: int,        # padded rows scanned per cluster
):
    """Scan only the probed clusters' row blocks; top-k over them. As in
    JAX, rows are read from the start clamped into the slab and reported
    from the unclamped start."""
    n = matrix.shape[0]
    starts = list_starts.long()[probe_ids.long()]

    def score(idx, q_sel, b):
        s = torch.bmm(matrix[idx].float(), q_sel[:, :, None]).squeeze(2)
        return s.masked_fill_(~row_valid[idx], NEG_INF)

    return _scan_windows(_bf16(queries), starts, n, rows_per_probe, k, score)
