"""Fused hybrid (BM25F + vector) scoring in PyTorch (counterpart of
oramacore_tpu/ops/hybrid.py).

Reference semantics (token_score.rs:357-422): full-text and vector scores
are min-max normalized over BOTH score sets (min folded from 0.0, since
every kept score is non-negative), summed, then multiplied by the OMC
multipliers (search.rs:342).

BM25 runs through `ops/bm25.py` (the `score_ranges_accumulate` kernel).
The vector side is either the flat bf16 slab, whose (B, N) similarities
are scatter-maxed onto the dense doc space chunk by chunk, or the int8 IVF
layout, whose top-V probe candidates are scatter-maxed the same way.
Scatter-max is `scatter_reduce_(..., "amax")`: max is exact, so its
atomics on the card leave the result deterministic. Invalid rows go to
the overflow slot `cap`, which is cut off.
"""

from __future__ import annotations

import torch

from .bm25 import _packbits, bm25_score_batch
from .vector import _bf16, ivf_int8_topk_masked, topk_2level

NEG_INF = -1e30

# f32 elements of one chunk of (B, rows) similarities, and of one chunk of
# the slab upcast to f32 (256 MiB each)
_SIM_ELEMS = 1 << 26


def _scatter_max(vals, docs, cap: int) -> torch.Tensor:
    """(B, cap) maxima of `vals` per doc id, 0 where no value lands:
    zeros(B, cap + 1) scatter-maxed at `docs` (cap = overflow slot)."""
    acc = torch.zeros((vals.shape[0], cap + 1), dtype=torch.float32,
                      device=vals.device)
    acc.scatter_reduce_(1, docs, vals, "amax", include_self=True)
    return acc[:, :cap]


def _overflow(docs, keep, cap: int) -> torch.Tensor:
    """int64 doc ids, with rows not kept or outside [0, cap) moved to the
    overflow slot (the JAX scatter drops ids past cap)."""
    ok = keep & (docs >= 0) & (docs < cap)
    return torch.where(ok, docs, cap).long()


def _rescale(s, lo: float, hi: float):
    return ((s - lo) / (hi - lo)).clamp_(0.0, 1.0)


def _vector_dense_scores(
    vec_matrix,   # bf16[N, dim] L2-normalized rows
    vec_doc,      # int32[N] doc id per row
    vec_valid,    # bool[N]
    queries,      # f32[B, dim] L2-normalized query vectors
    sim,          # f32[B] similarity threshold per query
    *,
    cap: int,
    has_rescale: bool,
    rescale_lo: float,
    rescale_hi: float,
):
    """(B, cap) vector scores: max over a doc's rows, 0 below threshold.
    The (B, N) similarities are formed one chunk of rows at a time."""
    B, D = queries.shape
    N = vec_matrix.shape[0]
    q = _bf16(queries)
    rows = _overflow(vec_doc, vec_valid, cap)
    acc = torch.zeros((B, cap + 1), dtype=torch.float32, device=q.device)
    chunk = max(1, _SIM_ELEMS // max(B, D))
    for c0 in range(0, N, chunk):
        sl = slice(c0, min(c0 + chunk, N))
        sims = q @ vec_matrix[sl].float().T                  # (B, chunk)
        if has_rescale:
            sims = _rescale(sims, rescale_lo, rescale_hi)
        keep = vec_valid[sl][None, :] & (sims >= sim[:, None])
        acc.scatter_reduce_(1, rows[sl].expand(B, -1),
                            sims.masked_fill_(~keep, 0.0), "amax",
                            include_self=True)
    return acc[:, :cap]


def _fuse(bm25, matched, vec, thr_counts, doc_mask, omc, *, has_omc: bool):
    """Min-max fusion + threshold + OMC. Returns (fused, present).
    doc_mask None means every doc is allowed."""
    ft_keep = (bm25 > 0.0) & (matched >= thr_counts[:, None])
    vec_keep = vec > 0.0
    if doc_mask is not None:
        ft_keep &= doc_mask
        vec_keep &= doc_mask
    ft = bm25.masked_fill(~ft_keep, 0.0)
    vc = vec.masked_fill(~vec_keep, 0.0)
    # reference min-max folds lo from 0.0 and both sets share the span
    hi = torch.maximum(ft.amax(dim=1), vc.amax(dim=1))      # (B,)
    span = torch.where(hi > 0.0, hi, torch.ones_like(hi))
    fused = ft.add_(vc).div_(span[:, None])                 # (ft + vc) / span
    if has_omc:
        fused.mul_(omc[None, :])
    present = ft_keep | vec_keep
    return fused.masked_fill_(~present, float("-inf")), present


def _select(fused, present, k: int, with_bitmap: bool):
    counts = present.sum(dim=1, dtype=torch.int32)
    vals, idx = topk_2level(fused, k)
    if with_bitmap:
        return vals, idx, counts, _packbits(present)
    return vals, idx, counts


def hybrid_search_topk_packed(
    p_doc, p_tf, p_exact_tf, p_flen,
    idesc,       # int32[2, B, T, NR]: starts, lens
    fdesc,       # float32[3, B, T, NR]: weights, field_b, avg_flen
    scalars,     # float32[3, B]: n_docs, thr_counts, similarity
    vec_matrix,  # bf16[N, dim]
    vec_doc,     # int32[N]
    vec_valid,   # bool[N]
    queries,     # f32[B, dim]
    doc_mask,    # bool[B, cap] (read only when has_mask)
    omc,         # f32[cap] (read only when has_omc)
    *,
    lr: int, exact: bool, cap: int, k: int,
    has_mask: bool, has_omc: bool,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
    with_bitmap: bool = False,
):
    """Returns (vals f32[B, k], ids int32[B, k], counts int32[B]);
    with_bitmap appends the match set as packed bits (uint8[B, cap/8],
    np.packbits order) for fused facet counting."""
    mask = doc_mask if has_mask else None
    bm25, matched = bm25_score_batch(
        p_doc, p_tf, p_exact_tf, p_flen,
        idesc[0], idesc[1], fdesc[0], fdesc[1], fdesc[2], scalars[0], mask,
        lr=lr, exact=exact, cap=cap,
    )
    vec = _vector_dense_scores(
        vec_matrix, vec_doc, vec_valid, queries, scalars[2],
        cap=cap, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi,
    )
    fused, present = _fuse(
        bm25, matched, vec, scalars[1], mask, omc, has_omc=has_omc
    )
    return _select(fused, present, k, with_bitmap)


def _vector_dense_scores_int8(
    mat_i8,       # int8[N, D] packed by cluster
    scales,       # f32[N]
    row_doc,      # int32[N]
    unit_cen,     # f32[U, D]
    unit_starts,  # int32[U]
    queries,      # f32[B, dim]
    sim,          # f32[B]
    doc_mask,     # bool[B, cap] (read only when has_mask)
    *,
    cap: int,
    V: int,
    nprobe: int,
    window: int,
    has_mask: bool,
    has_rescale: bool,
    rescale_lo: float,
    rescale_hi: float,
):
    """(B, cap) vector scores for the int8/IVF tier: probe the top-nprobe
    cluster units, keep the top-V candidate rows per query, scatter-max
    onto the dense doc space. Scores are the quantized int8 dots (no f32
    rerank on this path, as in JAX)."""
    vals, rows = ivf_int8_topk_masked(
        queries, mat_i8, scales, row_doc, unit_cen, unit_starts, doc_mask,
        k=V, nprobe=nprobe, window=window, has_mask=has_mask,
    )  # (B, V)
    if has_rescale:
        vals = _rescale(vals, rescale_lo, rescale_hi)
    keep = (rows >= 0) & (vals >= sim[:, None]) & (vals > NEG_INF / 2)
    docs = row_doc[rows.clamp(0, row_doc.shape[0] - 1).long()]
    return _scatter_max(vals.masked_fill(~keep, 0.0),
                        _overflow(docs, keep, cap), cap)


def hybrid_search_topk_packed_int8(
    p_doc, p_tf, p_exact_tf, p_flen,
    idesc, fdesc,
    scalars,      # float32[3, B]: n_docs, thr_counts, similarity
    mat_i8, scales, row_doc, unit_cen, unit_starts,
    queries,      # f32[B, dim]
    doc_mask, omc,
    champs=None, ch_idx=None, ch_w=None,   # champion dense rows
    *,
    lr: int, exact: bool, cap: int, k: int,
    V: int, nprobe: int, window: int,
    has_mask: bool, has_omc: bool,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
    has_champ: bool = False,
    with_bitmap: bool = False,
):
    """Fused hybrid for int8/IVF-tier vector indexes: BM25 ranged scoring
    (champion rows for heavy terms) + IVF candidate probe + fusion + OMC +
    top-k."""
    mask = doc_mask if has_mask else None
    bm25, matched = bm25_score_batch(
        p_doc, p_tf, p_exact_tf, p_flen,
        idesc[0], idesc[1], fdesc[0], fdesc[1], fdesc[2], scalars[0], mask,
        champs, ch_idx, ch_w,
        lr=lr, exact=exact, cap=cap, has_champ=has_champ,
    )
    vec = _vector_dense_scores_int8(
        mat_i8, scales, row_doc, unit_cen, unit_starts, queries, scalars[2],
        mask, cap=cap, V=V, nprobe=nprobe, window=window,
        has_mask=has_mask, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi,
    )
    fused, present = _fuse(
        bm25, matched, vec, scalars[1], mask, omc, has_omc=has_omc
    )
    return _select(fused, present, k, with_bitmap)


def hybrid_finalize_topk_int8(
    scores, matched, thr_counts,
    mat_i8, scales, row_doc, unit_cen, unit_starts,
    queries, sim, doc_mask, omc,
    *,
    cap: int, k: int, V: int, nprobe: int, window: int,
    has_mask: bool, has_omc: bool,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
):
    """Batched-hybrid tail over the int8/IVF layout for the shared
    (term-dedup) BM25 path."""
    mask = doc_mask if has_mask else None
    vec = _vector_dense_scores_int8(
        mat_i8, scales, row_doc, unit_cen, unit_starts, queries, sim,
        mask, cap=cap, V=V, nprobe=nprobe, window=window,
        has_mask=has_mask, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi,
    )
    fused, present = _fuse(
        scores, matched, vec, thr_counts, mask, omc, has_omc=has_omc
    )
    return _select(fused, present, k, False)


def hybrid_finalize_topk(
    scores,      # f32[B, cap] accumulated shared BM25 scores
    matched,     # f32[B, cap]
    thr_counts,  # f32[B]
    vec_matrix, vec_doc, vec_valid,
    queries,     # f32[B, dim]
    sim,         # f32[B]
    doc_mask,    # bool[B, cap] (read only when has_mask)
    omc,         # f32[cap] (read only when has_omc)
    *,
    cap: int, k: int, has_mask: bool, has_omc: bool,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
):
    """Batched-hybrid tail for the shared (term-dedup) BM25 path: vector
    similarities + fusion + OMC + top-k."""
    vec = _vector_dense_scores(
        vec_matrix, vec_doc, vec_valid, queries, sim,
        cap=cap, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi,
    )
    fused, present = _fuse(
        scores, matched, vec, thr_counts, doc_mask if has_mask else None,
        omc, has_omc=has_omc,
    )
    return _select(fused, present, k, False)
