"""BM25F scoring in PyTorch (counterpart of oramacore_tpu/ops/bm25.py).

Scoring semantics are the JAX module's, function for function:

    idf(t)   = ln(1 + (N - df_t + 0.5) / (df_t + 0.5))
    ntf      = w * tf / max((1 - b) + b * flen / avg, 1e-9)   per range
    S_t(d)   = sum of ntf over the postings of token t for doc d
    score_t  = idf(t) * (k+1) * S_t / (k + S_t)
    score(d) = sum_t score_t(d)

What changes is the device work under them. The JAX functions gather
posting windows (`slice_all`) and aggregate them into the dense
`(rows, cap)` doc space with a one-hot MXU matmul or a scatter
(`_aggregate_dense`), because the TPU has no fast scatter. Here both
stages are one hand-written kernel, `score_ranges_accumulate`
(ops/score_windows.py), which walks each range for exactly its length and
atomically adds ntf into the dense row. On the shared path, where the
JAX functions carry each unique term's saturated row to its queries with
`(B, cu) @ (cu, cap)` assignment matmuls, two more kernels
(ops/assign_rows.py) count each row's df (`count_present`) and add each
query's own term rows, saturated, into its rows (`assign_rows_accumulate`,
which computes the idf from df); the masked df product stays f32
`torch.matmul` (the package's `require_cuda` turns TF32 off for it). The
per-query path (`bm25_score_batch`) keeps df / idf / saturation as torch
elementwise code.

Unlike JAX, the accumulators are updated in place where that saves a
`(B, cap)` copy: the shared-path functions add into `scores_in` /
`matched_in` and return them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .assign_rows import assign_rows_accumulate, count_present
from .score_windows import score_ranges_accumulate
from .vector import top_k_by_key, topk_2level

K1 = 1.2  # reference k parameter (token_score.rs:283)

MAX_RANGE_LEN = 131072   # ranges longer than this are split at plan time

_SLAB_DTYPES = (torch.int32, torch.float32, torch.float32, torch.float32)


class PostingsDevice(NamedTuple):
    """Posting slab resident on the device, as four parallel columns."""

    doc: torch.Tensor       # int32[P]   internal doc id per posting
    tf: torch.Tensor        # float32[P] term frequency
    exact_tf: torch.Tensor  # float32[P] surface-form-exact term frequency
    flen: torch.Tensor      # float32[P] field length of (doc, field)

    @classmethod
    def from_numpy(cls, arrays4: Sequence[np.ndarray], device,
                   pad: int = MAX_RANGE_LEN) -> "PostingsDevice":
        """Device copy of a host slab (doc, tf, exact_tf, flen) — e.g.
        either half of `StringIndex.slab_split()` — followed by `pad` zero
        postings, so no range of up to MAX_RANGE_LEN reads past the end."""
        cols = []
        for a, dt in zip(arrays4, _SLAB_DTYPES):
            t = torch.as_tensor(np.asarray(a)).to(dt)
            if pad:
                t = torch.cat([t, torch.zeros(pad, dtype=dt)])
            cols.append(t.to(device).contiguous())
        return cls(*cols)

    @classmethod
    def concat(cls, parts: Sequence["PostingsDevice"]) -> "PostingsDevice":
        if len(parts) == 1:
            return parts[0]
        return cls(*(torch.cat([p[i] for p in parts]) for i in range(4)))


def round_up_pow2(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _idf(n_docs, df):
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))


def _masked_df(acc, mask_f, axis=None):
    """(rows, B) df under per-query filters: df[u, b] = present_u . mask_b
    (a large-K f32 product), summed over the shards on a mesh."""
    df = (acc > 0.0).to(torch.float32) @ mask_f.T
    return df if axis is None else axis.psum(df)


def _entry_map(token_map: torch.Tensor, entry_token: torch.Tensor) -> torch.Tensor:
    """(B, T) index into `entry_token` of each slot's id, -1 for a slot
    whose id no entry has (padding -1 among them). Entries are distinct."""
    hit = token_map[:, :, None] == entry_token[None, None, :]
    idx = torch.arange(1, entry_token.shape[0] + 1, device=token_map.device,
                       dtype=torch.int32)
    return ((hit * idx).sum(dim=2, dtype=torch.int32) - 1).contiguous()


def _champion_acc(champs, ch_rows, ch_w):
    """(U, cap) accumulated normalized TF for champion tokens: each row
    sums its per-field champion rows (ch_rows (U, NC), -1 = empty slot).

    A -1 row index in torch would read the LAST row, so empty slots index
    row 0 (clipped) and weigh zero, as the JAX function does."""
    safe = ch_rows.clamp(0, champs.shape[0] - 1).to(torch.int64)
    w_eff = torch.where(ch_rows >= 0, ch_w, torch.zeros_like(ch_w))
    acc = torch.zeros((ch_rows.shape[0], champs.shape[1]),
                      dtype=torch.float32, device=champs.device)
    for j in range(ch_rows.shape[1]):
        acc.addcmul_(champs.index_select(0, safe[:, j]), w_eff[:, j:j + 1])
    return acc


def _packbits(keep: torch.Tensor) -> torch.Tensor:
    """np.packbits(keep, axis=1): uint8[B, ceil(n/8)], big-endian bits."""
    B, n = keep.shape
    pad = (-n) % 8
    if pad:
        keep = torch.cat([keep, keep.new_zeros((B, pad))], dim=1)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                           dtype=torch.uint8, device=keep.device)
    return (keep.view(B, -1, 8).to(torch.uint8) * weights).sum(
        dim=2, dtype=torch.uint8
    )


def bm25_score_batch(
    p_doc, p_tf, p_exact_tf, p_flen,
    starts,      # int32[B, T, NR] posting-range starts
    lens,        # int32[B, T, NR] posting-range lengths (<= lr)
    weights,     # f32[B, T, NR] field boost per range
    field_b,     # f32[B, T, NR] BM25 b per range's field
    avg_flen,    # f32[B, T, NR] avg field len per range's field
    n_docs,      # f32[B] corpus size per query
    doc_mask: Optional[torch.Tensor],   # bool[B, cap] (None = all allowed)
    champs=None,      # f32[C, cap] champion rows (has_champ)
    ch_idx=None,      # int32[B, T, NC] champion row per slot
    ch_w=None,        # f32[B, T, NC] weight per champion slot
    *,
    lr: int,
    exact: bool,
    cap: int,
    has_champ: bool = False,
    axis=None,        # mesh axis for GLOBAL df under doc-id sharding
):
    """Score a batch of queries against one posting slab.

    On a doc-sharded mesh (parallel/engine.py) pass the shard's `axis`:
    each token's document frequency, hence its IDF, is then summed over
    the shards (`axis.psum`), so the scores equal an unsharded run's.

    Returns (scores f32[B, cap], matched_tokens f32[B, cap])."""
    B, T, _NR = starts.shape
    dev = p_doc.device
    scores = torch.zeros((B, cap), dtype=torch.float32, device=dev)
    matched = torch.zeros((B, cap), dtype=torch.float32, device=dev)
    for t in range(T):
        acc = torch.zeros((B, cap), dtype=torch.float32, device=dev)
        score_ranges_accumulate(
            p_doc, p_tf, p_exact_tf, p_flen,
            starts[:, t].contiguous(), lens[:, t].contiguous(),
            weights[:, t].contiguous(), field_b[:, t].contiguous(),
            avg_flen[:, t].contiguous(), acc, exact=exact, max_len=lr,
        )  # (B, cap) == S_t per doc
        if has_champ:
            # champion rows: one dense add replaces a heavy term's whole
            # posting-range scan
            acc += _champion_acc(champs, ch_idx[:, t], ch_w[:, t])
        if doc_mask is not None:
            acc.masked_fill_(~doc_mask, 0.0)  # filtered-IDF semantics
        present = acc > 0.0
        df = present.sum(dim=1, dtype=torch.float32)
        if axis is not None:
            df = axis.psum(df)  # global df over doc shards
        df = df.clamp(min=1.0)
        sat = _idf(n_docs, df)[:, None] * (K1 + 1.0) * acc / (K1 + acc)
        scores += sat.masked_fill_(~present, 0.0)
        matched += present
    return scores, matched


def bm25_search_topk_packed(
    p_doc, p_tf, p_exact_tf, p_flen,
    idesc,               # int32[2, B, T, NR]: starts, lens
    fdesc,               # f32[3, B, T, NR]: weights, field_b, avg_flen
    scalars,             # f32[2, B]: n_docs, thr_counts
    doc_mask,            # bool[B, cap] (read only when has_mask)
    omc,                 # f32[cap] (read only when has_omc)
    champs=None,         # f32[C, cap] champion rows (has_champ)
    ch_idx=None,         # int32[B, T, NC]
    ch_w=None,           # f32[B, T, NC]
    *,
    lr: int, exact: bool, cap: int, k: int,
    has_mask: bool, has_omc: bool, has_champ: bool = False,
    with_bitmap: bool = False,
):
    """Fused search: scoring + threshold + OMC + top-k + exact match
    counts; with_bitmap also returns the match set as packed bits
    (uint8[B, cap/8], np.packbits bit order)."""
    scores, matched = bm25_score_batch(
        p_doc, p_tf, p_exact_tf, p_flen,
        idesc[0], idesc[1], fdesc[0], fdesc[1], fdesc[2], scalars[0],
        doc_mask if has_mask else None, champs, ch_idx, ch_w,
        lr=lr, exact=exact, cap=cap, has_champ=has_champ,
    )
    keep = (matched >= scalars[1][:, None]) & (scores > 0.0)
    counts = keep.sum(dim=1, dtype=torch.int32)
    s = scores * omc[None, :] if has_omc else scores
    vals, idx = topk_2level(s.masked_fill_(~keep, float("-inf")), k)
    if with_bitmap:
        return vals, idx, counts, _packbits(keep)
    return vals, idx, counts


NEG_F32 = -3.0e38  # sentinel below any real f32 sort value


def _score_keep(p_doc, p_tf, p_exact_tf, p_flen, idesc, fdesc, scalars,
                doc_mask, omc, *, lr, exact, cap, has_mask, has_omc):
    """Scoring + threshold of the sort-by / group-by searches: returns
    (s = scores * omc, unmasked; keep bool[B, cap]; counts int32[B])."""
    scores, matched = bm25_score_batch(
        p_doc, p_tf, p_exact_tf, p_flen,
        idesc[0], idesc[1], fdesc[0], fdesc[1], fdesc[2], scalars[0],
        doc_mask if has_mask else None, lr=lr, exact=exact, cap=cap,
    )
    keep = (matched >= scalars[1][:, None]) & (scores > 0.0)
    counts = keep.sum(dim=1, dtype=torch.int32)
    s = scores * omc[None, :] if has_omc else scores
    return s, keep, counts


def bm25_search_sorted_packed(
    p_doc, p_tf, p_exact_tf, p_flen,
    idesc, fdesc, scalars,
    doc_mask,            # bool[B, cap] (read only when has_mask)
    omc,                 # f32[cap] (read only when has_omc)
    svals,               # f32[cap] sort column (NaN = doc lacks it)
    *,
    lr: int, exact: bool, cap: int, k: int,
    has_mask: bool, has_omc: bool, desc: bool,
):
    """Fused sort-by search: score + threshold + sort-field top-k.

    Matched docs WITH the sort field come by (value asc|desc, doc asc),
    then matched docs WITHOUT it by doc asc. Returns
    (docs1, vals1, sc1, docs2, valid2, sc2, counts): the with-field page
    (vals1 > NEG_F32/2 marks real entries), the fieldless page, and exact
    match counts. sc1 / sc2 read `scores * omc`, which is not masked to
    -inf here, as in the JAX function. `top_k_by_key` keeps `lax.top_k`'s
    exact order, so the pages equal the JAX pages doc for doc."""
    s, keep, counts = _score_keep(
        p_doc, p_tf, p_exact_tf, p_flen, idesc, fdesc, scalars, doc_mask,
        omc, lr=lr, exact=exact, cap=cap, has_mask=has_mask, has_omc=has_omc,
    )
    have = ~torch.isnan(svals)
    key1 = torch.where(keep & have, svals if desc else -svals, NEG_F32)
    vals1, docs1 = top_k_by_key(key1, k)
    iota = torch.arange(cap, device=s.device, dtype=torch.float32)
    key2 = torch.where(keep & ~have, -iota, NEG_F32)
    vals2, docs2 = top_k_by_key(key2, k)
    return (
        docs1.to(torch.int32), vals1, s.gather(1, docs1),
        docs2.to(torch.int32), vals2 > NEG_F32 / 2, s.gather(1, docs2),
        counts,
    )


def bm25_search_grouped_packed(
    p_doc, p_tf, p_exact_tf, p_flen,
    idesc, fdesc, scalars,
    doc_mask,            # bool[B, cap] (read only when has_mask)
    omc,                 # f32[cap] (read only when has_omc)
    gid,                 # int32[cap] group ids (-1 = doc lacks the field)
    *,
    lr: int, exact: bool, cap: int, k: int, R: int, G: int,
    has_mask: bool, has_omc: bool,
):
    """Fused group-by search: score + threshold + main top-k + per-group
    top-R pages. Returns (vals f32[B, k], idx int32[B, k], counts int32[B],
    gvals f32[B, G, R], gdocs int32[B, G, R]).

    Group g's page holds its kept docs by (score desc, doc asc); docs with
    a group id outside [0, G) drop out; empty slots hold -inf and doc 0.
    One design serves every G: the JAX function's 3-key sort on
    (gid, -score, doc), built as two stable sorts (score, then gid) over
    rows already in doc order, then a binary search of each group's run
    start. The JAX package's masked scan for G <= 16 gives the same
    finite entries (it leaves other doc ids beside -inf)."""
    s, keep, counts = _score_keep(
        p_doc, p_tf, p_exact_tf, p_flen, idesc, fdesc, scalars, doc_mask,
        omc, lr=lr, exact=exact, cap=cap, has_mask=has_mask, has_omc=has_omc,
    )
    s = s.masked_fill(~keep, float("-inf"))
    vals, idx = topk_2level(s, k)
    B = s.shape[0]
    in_group = keep & (gid >= 0) & (gid < G)
    gidk = torch.where(in_group, gid, G)
    # lax.sort takes -0.0 == +0.0; a radix sort on the card would not
    neg = torch.where(in_group, -s, float("inf"))
    neg.masked_fill_(neg == 0, 0.0)
    by_score = torch.sort(neg, dim=1, stable=True).indices
    g_sorted, by_gid = torch.sort(gidk.gather(1, by_score), dim=1, stable=True)
    order = by_score.gather(1, by_gid)   # docs in (gid, -score, doc) order
    bounds = torch.searchsorted(
        g_sorted,
        torch.arange(G + 1, device=s.device, dtype=torch.int32)
        .expand(B, G + 1).contiguous(),
    )                                    # run starts of groups 0..G
    page = bounds[:, :G, None] + torch.arange(R, device=s.device)
    in_run = page < bounds[:, 1:, None]
    docs = order.gather(1, page.clamp(max=cap - 1).view(B, G * R)).view(B, G, R)
    gvals = torch.where(
        in_run, s.gather(1, docs.view(B, G * R)).view(B, G, R), float("-inf")
    )
    gdocs = torch.where(in_run, docs, 0).to(torch.int32)
    return vals, idx, counts, gvals, gdocs


# ---------------------------------------------------------------------------
# Shared (term-deduplicated) batched scoring: each UNIQUE token of a batch
# is scored once into a dense row, and `assign_rows_accumulate` adds each
# query's own term rows into its rows (see oramacore_tpu/ops/bm25.py for
# the derivation, which does that step as a (B, U) assignment matmul).
# ---------------------------------------------------------------------------

def _ranged_chunk_acc(p_doc, p_tf, p_exact_tf, p_flen, u_starts, u_lens,
                      u_weights, u_field_b, u_avg, rows: slice, *,
                      lr: int, cap: int, exact: bool):
    acc = torch.zeros((rows.stop - rows.start, cap), dtype=torch.float32,
                      device=p_doc.device)
    return score_ranges_accumulate(
        p_doc, p_tf, p_exact_tf, p_flen,
        u_starts[rows], u_lens[rows], u_weights[rows], u_field_b[rows],
        u_avg[rows], acc, exact=exact, max_len=lr,
    )


def bm25_shared_partial(
    p_doc, p_tf, p_exact_tf, p_flen,
    u_starts,    # int32[U, NR] posting ranges of unique tokens (U % cu == 0)
    u_lens,      # int32[U, NR]
    u_weights,   # f32[U, NR]
    u_field_b,   # f32[U, NR]
    u_avg,       # f32[U, NR]
    token_map,   # int32[B, T] unique-token index per query slot (U = padding)
    n_docs,      # corpus size (float or f32 scalar)
    scores_in,   # f32[B, cap], updated in place
    matched_in,  # f32[B, cap], updated in place
    *,
    lr: int, cap: int, cu: int, exact: bool,
    axis=None,   # mesh axis for GLOBAL df under doc-id sharding
):
    U = u_starts.shape[0]
    for ci in range(U // cu):
        rows = slice(ci * cu, (ci + 1) * cu)
        acc = _ranged_chunk_acc(
            p_doc, p_tf, p_exact_tf, p_flen, u_starts, u_lens, u_weights,
            u_field_b, u_avg, rows, lr=lr, cap=cap, exact=exact,
        )  # (cu, cap)
        df = count_present(acc)
        if axis is not None:
            df = axis.psum(df)  # global df over doc shards
        assign_rows_accumulate(acc, df, token_map, scores_in, matched_in,
                               row0=rows.start, n_docs=n_docs, k1=K1)
    return scores_in, matched_in


def bm25_shared_partial_masked(
    p_doc, p_tf, p_exact_tf, p_flen,
    u_starts, u_lens, u_weights, u_field_b, u_avg,
    token_map,   # int32[B, T]
    doc_mask,    # bool[B, cap] per-query filter masks
    n_docs,
    scores_in, matched_in,
    *,
    lr: int, cap: int, cu: int, exact: bool,
    axis=None,   # mesh axis for GLOBAL filtered df under doc sharding
):
    """Shared scoring WITH per-query filters, still exact: the
    per-(query, token) filtered df comes from one extra matmul per chunk
    (df[u, b] = present_u · mask_b)."""
    U = u_starts.shape[0]
    mask_f = doc_mask.to(torch.float32)  # (B, cap)
    for ci in range(U // cu):
        rows = slice(ci * cu, (ci + 1) * cu)
        acc = _ranged_chunk_acc(
            p_doc, p_tf, p_exact_tf, p_flen, u_starts, u_lens, u_weights,
            u_field_b, u_avg, rows, lr=lr, cap=cap, exact=exact,
        )
        assign_rows_accumulate(acc, _masked_df(acc, mask_f, axis), token_map,
                               scores_in, matched_in, row0=rows.start,
                               n_docs=n_docs, k1=K1)
    # the per-query mask zeroes contributions of filtered-out docs
    scores_in.mul_(mask_f)
    matched_in.mul_(mask_f)
    return scores_in, matched_in


def bm25_shared_champions(
    champs,       # f32[C, cap] champion rows (normalized TF, unweighted)
    ch_rows,      # int32[U, NC] champion rows per champion token (-1 empty)
    ch_w,         # f32[U, NC] weights (boost * field weight)
    entry_token,  # int32[U] GLOBAL unique-token id of each entry
    token_map,    # int32[B, T] unique-token index per query slot (-1 pad)
    n_docs,
    scores_in,    # f32[B, cap], updated in place
    matched_in,   # f32[B, cap], updated in place
):
    """Champion class: heavy tokens score from precomputed dense rows (no
    posting gather), then reach the queries through the same row kernel
    as the ranged classes."""
    acc = _champion_acc(champs, ch_rows, ch_w)               # (U, cap)
    assign_rows_accumulate(acc, count_present(acc),
                           _entry_map(token_map, entry_token),
                           scores_in, matched_in, row0=0, n_docs=n_docs, k1=K1)
    return scores_in, matched_in


def bm25_shared_champions_masked(
    champs, ch_rows, ch_w, entry_token, token_map,
    doc_mask,    # bool[B, cap]
    n_docs, scores_in, matched_in,
):
    """Champion class under per-query filters (bm25_shared_partial_masked
    semantics)."""
    mask_f = doc_mask.to(torch.float32)
    acc = _champion_acc(champs, ch_rows, ch_w)
    assign_rows_accumulate(acc, _masked_df(acc, mask_f),
                           _entry_map(token_map, entry_token),
                           scores_in, matched_in, row0=0, n_docs=n_docs, k1=K1)
    scores_in.mul_(mask_f)
    matched_in.mul_(mask_f)
    return scores_in, matched_in


def finalize_topk(scores, matched, thr_counts, omc, *, k: int):
    """Threshold + OMC + top-k + exact match counts."""
    keep = (matched >= thr_counts[:, None]) & (scores > 0.0)
    counts = keep.sum(dim=1, dtype=torch.int32)
    s = (scores * omc[None, :]).masked_fill_(~keep, float("-inf"))
    vals, idx = topk_2level(s, k)
    return vals, idx, counts
