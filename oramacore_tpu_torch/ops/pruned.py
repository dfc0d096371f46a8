"""Pruned BM25F scoring for large corpora: candidates + exact rescore
(counterpart of oramacore_tpu/ops/pruned.py).

The dense path (ops/bm25.py) keeps one (B, cap) f32 accumulator per
batch; at the 10M tier cap rounds up to 2^24, so B=1024 would need 64
GiB. This tier keeps (B, C) candidate state instead, in two phases:

- PHASE 1, nomination. `_prefix_candidates` scores the impact-ordered
  prefix of every range (the commit-time side blocks of
  index/string_index.py) with a stable sort on (doc, token) keys and
  segmented sums, and keeps the top-C docs by partial score.
  `_sliced_candidates` takes the first `hp` doc ids of each prefix
  instead (the v4 entry point with nom_accum=False).
- PHASE 2, exact rescore of the candidates, by one of two hand-written
  CUDA kernels (`csrc/pruned_rescore.cu`):
  - `rescore_bsearch` (default route, v4): one thread per (query,
    candidate, token, range) finds the candidate in the range's bucket
    window of the static offset tables (`boff`; else the whole range),
    reading 16 postings at the doc's even-spread place in one round; a
    block sums its pairs' searches in order and saturates per token with
    the host idf.
  - `rescore_worklist` (filtered, exact-tf, multi-field and tolerance
    searches, v3): a grid of (entry, block) streams the worklist's
    postings in tiles of 2,048 through a two-tile cp.async ring in shared
    memory; it gathers the filter (a bitmap, `pack_mask_bits`,
    where the caller has one), looks each kept doc up in the query's
    candidate table in shared memory and adds its ntf atomically; the
    same pass counts df, less the postings whose doc an earlier span of
    the token already holds (`nre`). A second kernel of the same entry
    point takes df to idf and saturates.

The JAX functions are written around the TPU's lack of a fast scatter:
the worklist rescore there takes prefix-sum differences over each
chunk. The port adds each matched posting's ntf directly, so its sums
carry no cancellation (JAX's prefix-sum differences are off by up to
~1e-3 relative on 4096-posting chunks); scores compare within a stated
tolerance, `matched` and counts exactly.

`pruned_fulltext_topk` (v3) and `pruned_fulltext_topk_bs` (v4) are the
fused searches (nomination, rescore, threshold / OMC / top-k tail);
`pruned_exact_counts` is the opt-in exact match count (one int64-keyed
sort of the batch's postings). A wrapper given CPU tensors runs its
plain PyTorch version; given CUDA tensors it launches its kernel or
raises.

Facets over a pruned plan run in two phases: `pruned_match_reps` (phase
A) sorts the plan's postings once and flags one rep per distinct matched
doc; the `facet_hist` kernels (ops/facet_hist.py, phase B) count the
reps per bucket of one field. `pruned_hybrid_match_reps` widens phase A by the IVF
probe's docs. `pruned_hybrid_topk_int8` (v3) and
`pruned_hybrid_topk_int8_bs` (v4) are the pruned hybrid searches over the
int8 IVF layout: the full-text candidates united with the probe's, both
sides scored exactly on them and fused by min-max.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bm25 import K1
from .hybrid import _rescale
from .score_windows import _check, _device_of, _raise_on
from .vector import _bf16, _top_k, ivf_int8_topk_masked

NEG_INF = -1e30

# Kernel launches per entry point, counted only where a kernel is
# enqueued (never for the plain versions). Reset with reset_launch_counts.
LAUNCHES = {"rescore_bsearch": 0, "rescore_worklist": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("pruned_rescore")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.rescore_bsearch_launch.argtypes = [
            ptr, ptr, ptr, i64,                 # p_doc, tf, flen, n
            ptr, ptr, ptr, ptr, ptr,            # st, ln, w, fb, av
            ptr, ptr,                           # idf, cand
            i64, i64, i64, i64, i64,            # B, T, NR, C, bs_steps
            ptr, i64, ptr, ptr,                 # flat, n_flat, base, shift
            i64,                                # pairs per block
            ptr, ptr, ptr,                      # scores, matched, stream
        ]
        lib.rescore_bsearch_launch.restype = ctypes.c_int
        lib.rescore_worklist_launch.argtypes = [
            ptr, ptr, ptr, i64,                 # p_doc, tf, flen, n
            ptr, ptr, i64, ptr,                 # wl_i, wl_f, W, n_docs
            ptr, i64, i64, i64, i64,            # cand, B, C, T, lch
            ptr, i64, i64,                      # wl_prev, nre, bs_steps
            ptr, ptr, i64,                      # fmask, fbits, n_mask
            i64,                                # blocks per entry
            ptr, ptr, ptr,                      # work, scores, matched
            i64, ptr,                           # parts, stream
        ]
        lib.rescore_worklist_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# launch shapes, as the constants of csrc/pruned_rescore.cu set them
KERNEL_THREADS = 256
TILE_POSTINGS = 2048   # a tile of rescore_worklist: 512 16-byte vectors


def bsearch_pairs_per_block(T: int, NR: int) -> int:
    """(query, candidate) pairs one block of rescore_bsearch takes: as
    many as give each thread one (token, range) search, else one pair
    whose searches the block's threads share."""
    tn = T * NR
    return KERNEL_THREADS // tn if tn < KERNEL_THREADS else 1


TILES_PER_BLOCK = 4    # tiles of a full lch entry that one block walks


def worklist_tiles(lch: int) -> int:
    """The most tiles an entry of rescore_worklist has: enough for lch
    postings read from the 16-byte boundary at or below the entry's start
    (up to 3 postings ahead of it)."""
    return -(-(lch + 3) // TILE_POSTINGS)


def worklist_blocks(lch: int) -> int:
    """Blocks per entry in rescore_worklist's (entry, block) grid: block
    g walks the entry's tiles g, g + blocks, ... (about TILES_PER_BLOCK
    of a full entry)."""
    return -(-worklist_tiles(lch) // TILES_PER_BLOCK)


def pack_mask_bits(fmask: torch.Tensor) -> torch.Tensor:
    """The filter mask as the bitmap rescore_worklist reads in its place:
    int32[ceil(L / 32)], bit d % 32 of word d // 32 set where fmask[d] >
    0 (1.3 MB at 10.49M docs, against 42 MB of f32)."""
    keep = fmask > 0
    pad = (-keep.shape[0]) % 32
    if pad:
        keep = torch.cat([keep, keep.new_zeros(pad)])
    shifts = torch.arange(32, device=fmask.device, dtype=torch.int64)
    words = (keep.view(-1, 32).to(torch.int64) << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


# ---------------------------------------------------------------------------
# small helpers (JAX names)
# ---------------------------------------------------------------------------

def _seg_totals_sorted(keys: torch.Tensor, vals: torch.Tensor):
    """Segmented sums over runs of equal (sorted) keys along axis 1.
    vals must be NON-NEGATIVE (so the masked cumsum is non-decreasing and
    one cummax recovers each run's base). Returns (is_end bool[B, M],
    totals f32[B, M]) with the run sum at each run-end position."""
    B = keys.shape[0]
    dev = keys.device
    cs = torch.cumsum(vals, dim=1)
    is_end = torch.cat(
        [keys[:, 1:] != keys[:, :-1], torch.ones((B, 1), dtype=torch.bool,
                                                 device=dev)], dim=1)
    end_cs = torch.where(is_end, cs, NEG_INF)
    prev = torch.cat(
        [torch.full((B, 1), NEG_INF, dtype=cs.dtype, device=dev),
         end_cs[:, :-1]], dim=1)
    prev = torch.cummax(prev, dim=1).values
    base = torch.where(prev > NEG_INF / 2, prev, 0.0)
    return is_end, cs - base


def _lower_bound(sorted_vals: torch.Tensor, queries: torch.Tensor):
    """First index where sorted_vals >= query, per row: int32[B, L] in
    [0, C]. The JAX function's uniform binary search is
    `torch.searchsorted(..., right=False)`."""
    return torch.searchsorted(
        sorted_vals.contiguous(), queries.contiguous(), right=False
    ).to(torch.int32)


def _slices(src: torch.Tensor, starts: torch.Tensor, width: int):
    """`jax.lax.dynamic_slice(src, (s,), (width,))` for each start:
    starts clamp to [0, P - width] (the window then holds postings
    s_eff + j). Returns (values [S, width], s_eff int64[S]). Slots past
    the slab's end (P < width, where JAX refuses the slice) read the last
    posting and must be masked by the caller."""
    P = src.shape[0]
    s_eff = starts.to(torch.int64).clamp(0, max(P - width, 0))
    idx = s_eff[:, None] + torch.arange(width, device=src.device)
    return src[idx.clamp(max=max(P - 1, 0))], s_eff


# ---------------------------------------------------------------------------
# phase 1: nomination
# ---------------------------------------------------------------------------

def _prefix_candidates(
    p_doc, tf_src, p_flen,
    pre_starts, pre_lens,      # int32[B, T, NPR] (lens <= lp)
    pre_w, pre_fb, pre_av,     # f32[B, T, NPR]
    idf,                       # f32[B, T]
    fmask=None,                # f32[cap(+pad)] filter (1 = doc allowed)
    *,
    lp: int, cap: int, C: int,
):
    """Phase 1: top-C candidate docs per query from impact prefixes.
    Returns cand int32[B, C] sorted ascending; `cap` marks empty slots.

    As the JAX function: the slices clamp at the slab's end (slot j holds
    posting s_eff + j, the range sits at [shift, shift + len)); one
    stable sort on key = doc * TT + tok; the NPR == 1 and WRUN <= 8
    shortcuts; the top C by partial score with lower positions first
    among ties (a stable descending sort, `lax.top_k`'s order); dedup
    and re-sort."""
    B, T, NPR = pre_starts.shape
    TT = 1
    while TT < T + 1:
        TT *= 2
    assert cap * TT + TT < 2**31, "doc-id x token key overflows int32"
    dev = p_doc.device
    P = p_doc.shape[0]
    flat = pre_starts.reshape(-1)
    docs, s_eff = _slices(p_doc, flat, lp)
    tf, _ = _slices(tf_src, flat, lp)
    fl, _ = _slices(p_flen, flat, lp)
    docs = docs.view(B, T, NPR, lp)
    tf = tf.view(B, T, NPR, lp)
    fl = fl.view(B, T, NPR, lp)
    shift = (flat.to(torch.int64) - s_eff).view(B, T, NPR, 1)
    slot = torch.arange(lp, device=dev).view(1, 1, 1, lp)
    valid = (slot >= shift) & (slot < shift + pre_lens[..., None])
    valid &= (s_eff.view(B, T, NPR, 1) + slot) < P
    fb = pre_fb[..., None]
    denom = (1.0 - fb) + fb * fl / torch.clamp(pre_av[..., None], min=1e-9)
    ntf = pre_w[..., None] * tf / torch.clamp(denom, min=1e-9)
    keep = valid & (tf > 0)
    if fmask is not None:
        # filtered searches nominate only in-filter docs
        keep &= fmask[docs.clamp(0, fmask.shape[0] - 1).long()] > 0.0
    ntf = torch.where(keep, ntf, 0.0)
    docs = torch.where(keep, docs, cap)
    tok = torch.arange(T, device=dev, dtype=torch.int32).view(1, T, 1, 1)
    M = T * NPR * lp
    key = (docs * TT + tok).reshape(B, M)
    ntf = ntf.reshape(B, M)
    key_s, order = torch.sort(key, dim=1, stable=True)
    ntf_s = ntf.gather(1, order)

    # per-(doc, token) accumulation -> saturation; with NPR == 1 a
    # term's prefix holds distinct docs, so the token-level sum is the
    # identity
    if NPR == 1:
        t_end = torch.ones_like(key_s, dtype=torch.bool)
        t_acc = ntf_s
    else:
        t_end, t_acc = _seg_totals_sorted(key_s, ntf_s)
    tok_s = torch.clamp(key_s - (key_s // TT) * TT, 0, T - 1)
    idf_s = torch.zeros_like(t_acc)
    for t in range(T):
        idf_s = idf_s + torch.where(tok_s == t, idf[:, t, None], 0.0)
    sat = idf_s * (K1 + 1.0) * t_acc / (K1 + t_acc)
    sat = torch.where(t_end & (t_acc > 0.0) & (key_s < cap * TT), sat, 0.0)

    # per-doc partial score: a doc's run holds at most T * NPR entries,
    # so small plans sum a window of shifted adds instead of a scan pair
    dkey = key_s // TT
    WRUN = T * NPR
    if WRUN <= 8:
        d_end = torch.cat(
            [dkey[:, 1:] != dkey[:, :-1],
             torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
        d_tot = sat
        for k in range(1, WRUN):
            same = dkey[:, k:] == dkey[:, :-k]
            shifted = torch.where(same, sat[:, :-k], 0.0)
            d_tot = d_tot + torch.nn.functional.pad(shifted, (k, 0))
    else:
        d_end, d_tot = _seg_totals_sorted(dkey, sat)
    part = torch.where(d_end & (d_tot > 0.0) & (dkey < cap), d_tot, NEG_INF)

    if C > part.shape[1]:  # tiny prefix pools: pad up to the budget
        padn = C - part.shape[1]
        part = torch.nn.functional.pad(part, (0, padn), value=NEG_INF)
        dkey = torch.nn.functional.pad(dkey, (0, padn), value=cap)
    pv, pi = _top_k(part, C)
    cand = dkey.gather(1, pi)
    cand = torch.where(pv > NEG_INF / 2, cand, cap)
    return _dedup_sorted(cand, cap)


def _dedup_sorted(cand: torch.Tensor, cap: int) -> torch.Tensor:
    """Sort ascending, turn repeats into `cap`, sort again."""
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat(
        [torch.zeros((cand.shape[0], 1), dtype=torch.bool,
                     device=cand.device),
         cand[:, 1:] == cand[:, :-1]], dim=1)
    cand = torch.where(dup, cap, cand)
    return torch.sort(cand, dim=1).values


def _sliced_candidates(p_doc, pre_starts, pre_lens, *, hp: int, cap: int):
    """v4 phase 1 by slicing: the first `hp` doc ids of each prefix range
    (with the end-of-slab clamp of `_prefix_candidates`), sorted and
    deduplicated. Returns cand int32[B, T*NPR*hp]; `cap` = empty."""
    B, T, NPR = pre_starts.shape
    P = p_doc.shape[0]
    flat = pre_starts.reshape(-1)
    docs, s_eff = _slices(p_doc, flat, hp)
    docs = docs.view(B, T, NPR, hp)
    shift = (flat.to(torch.int64) - s_eff).view(B, T, NPR, 1)
    slot = torch.arange(hp, device=p_doc.device).view(1, 1, 1, hp)
    valid = (slot >= shift) & (slot < shift + pre_lens[..., None])
    valid &= (s_eff.view(B, T, NPR, 1) + slot) < P
    docs = torch.where(valid, docs, cap)
    return _dedup_sorted(docs.reshape(B, T * NPR * hp), cap)


# ---------------------------------------------------------------------------
# phase 2, default route: rescore_bsearch (kernel A)
# ---------------------------------------------------------------------------

def rescore_bsearch_plain(
    p_doc, tf_src, p_flen, rng_st, rng_ln, rng_w, rng_fb, rng_av, idf, cand,
    *, bs_steps: int, boff=None,
):
    """Plain PyTorch version of `rescore_bsearch`: the JAX function
    vectorized over (B, T, NR, C), as JAX writes it."""
    P = p_doc.shape[0]
    B, C = cand.shape
    _, T, NR = rng_st.shape
    cq = cand.to(torch.int64)[:, None, None, :]
    st = rng_st.to(torch.int64)[..., None]
    ln = rng_ln.to(torch.int64)[..., None]
    shape4 = (B, T, NR, C)
    if boff is not None:
        flat, b_base, b_shift = boff
        L = flat.shape[0]
        j = cq.expand(shape4) >> b_shift.to(torch.int64)[..., None]
        at_j = b_base.to(torch.int64)[..., None] + j
        pos = flat[at_j.clamp(0, L - 1)].to(torch.int64)
        hi = flat[(at_j + 1).clamp(0, L - 1)].to(torch.int64)
    else:
        pos = torch.zeros(shape4, dtype=torch.int64, device=p_doc.device)
        hi = ln.expand(shape4)
    step = 1 << (bs_steps - 1)
    while step >= 1:
        probe = pos + step
        ok = probe <= hi
        v = p_doc[(st + probe - 1).clamp(0, P - 1)]
        pos = torch.where(ok & (v < cq), probe, pos)
        step >>= 1
    at = (st + pos).clamp(0, P - 1)
    hit = (pos < ln) & (p_doc[at] == cq)
    tf = torch.where(hit, tf_src[at], 0.0)
    fl = p_flen[at]
    fb = rng_fb[..., None]
    denom = (1.0 - fb) + fb * fl / torch.clamp(rng_av[..., None], min=1e-9)
    ntf = rng_w[..., None] * tf / torch.clamp(denom, min=1e-9)
    acc = ntf.sum(dim=2)                                  # (B, T, C)
    return _saturate(acc, idf)


def _saturate(acc, idf):
    """(scores, matched) f32[B, C] from per-token sums acc f32[B, T, C]."""
    present = acc > 0.0
    sat = idf[:, :, None] * (K1 + 1.0) * acc / (K1 + acc)
    scores = torch.where(present, sat, 0.0).sum(dim=1)
    return scores, present.to(torch.float32).sum(dim=1)


def rescore_bsearch(
    p_doc, tf_src, p_flen,
    rng_st, rng_ln,            # int32[B, T, NR] UNSPLIT doc-sorted ranges
    rng_w, rng_fb, rng_av,     # f32[B, T, NR]
    idf,                       # f32[B, T] exact host idf
    cand,                      # int32[B, C] ascending (cap = empty)
    *,
    bs_steps: int,
    boff=None,                 # (flat int32[L], base, shift int32[B, T, NR])
):
    """v4 phase 2: each candidate's exact BM25F score and matched-token
    count by binary search into its tokens' doc-sorted ranges, inside the
    bucket window [flat[base + j], flat[base + j + 1]) with j = cand >>
    shift when `boff` is given, else [0, len). Returns (scores f32[B, C],
    matched f32[B, C])."""
    _check(p_doc, "p_doc", torch.int32, 1)
    _check(tf_src, "tf_src", torch.float32, 1)
    _check(p_flen, "p_flen", torch.float32, 1)
    for t, name in ((rng_st, "rng_st"), (rng_ln, "rng_ln")):
        _check(t, name, torch.int32, 3)
    for t, name in ((rng_w, "rng_w"), (rng_fb, "rng_fb"), (rng_av, "rng_av")):
        _check(t, name, torch.float32, 3)
    _check(idf, "idf", torch.float32, 2)
    _check(cand, "cand", torch.int32, 2)
    n = p_doc.shape[0]
    if tf_src.shape[0] != n or p_flen.shape[0] != n:
        raise ValueError("p_doc, tf_src and p_flen must have one length")
    B, T, NR = rng_st.shape
    for t, name in ((rng_ln, "rng_ln"), (rng_w, "rng_w"),
                    (rng_fb, "rng_fb"), (rng_av, "rng_av")):
        if tuple(t.shape) != (B, T, NR):
            raise ValueError(f"{name} must be {(B, T, NR)}, got {tuple(t.shape)}")
    if tuple(idf.shape) != (B, T) or cand.shape[0] != B:
        raise ValueError("idf must be (B, T) and cand (B, C)")
    if not 1 <= bs_steps <= 31:
        raise ValueError(f"bs_steps must be in [1, 31], got {bs_steps}")
    tensors = [p_doc, tf_src, p_flen, rng_st, rng_ln, rng_w, rng_fb, rng_av,
               idf, cand]
    if boff is not None:
        flat, b_base, b_shift = boff
        _check(flat, "boff flat", torch.int32, 1)
        for t, name in ((b_base, "boff base"), (b_shift, "boff shift")):
            _check(t, name, torch.int32, 3)
            if tuple(t.shape) != (B, T, NR):
                raise ValueError(f"{name} must be {(B, T, NR)}")
        tensors += [flat, b_base, b_shift]
    dev = _device_of(tensors)
    if dev.type == "cpu":
        return rescore_bsearch_plain(
            p_doc, tf_src, p_flen, rng_st, rng_ln, rng_w, rng_fb, rng_av,
            idf, cand, bs_steps=bs_steps, boff=boff)
    C = cand.shape[1]
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    matched = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B * C == 0:
        return scores, matched
    lib = load_kernels()
    flat_p = base_p = shift_p = None
    n_flat = 0
    if boff is not None:
        flat_p, base_p, shift_p = (t.data_ptr() for t in boff)
        n_flat = boff[0].shape[0]
    with torch.cuda.device(dev):
        err = lib.rescore_bsearch_launch(
            p_doc.data_ptr(), tf_src.data_ptr(), p_flen.data_ptr(), n,
            rng_st.data_ptr(), rng_ln.data_ptr(), rng_w.data_ptr(),
            rng_fb.data_ptr(), rng_av.data_ptr(), idf.data_ptr(),
            cand.data_ptr(), B, T, NR, C, bs_steps,
            flat_p, n_flat, base_p, shift_p, bsearch_pairs_per_block(T, NR),
            scores.data_ptr(), matched.data_ptr(), _stream(dev),
        )
    _raise_on(err, "rescore_bsearch")
    _build.count_launch(LAUNCHES, "rescore_bsearch")
    return scores, matched


# ---------------------------------------------------------------------------
# phase 2, streamed route: rescore_worklist (kernel B)
# ---------------------------------------------------------------------------

# worklist entries per step of the plain version (JAX's scan step `wch`)
_PLAIN_WCH = 128


def rescore_worklist_accumulate_plain(
    p_doc, tf_src, p_flen, wl_i, wl_f, cand, wl_prev=None, fmask=None,
    *, lch: int, T: int, nre: int = 0, bs_steps: int = 0,
):
    """Plain PyTorch version of the kernel's pass: (acc f32[B*T, C], df
    int32[B*T]). acc[b*T + t, c] sums the ntf of entry postings of (b, t)
    whose doc is the first candidate slot c holding it; df counts the
    kept postings (tf > 0, inside the filter) less those whose doc an
    earlier span of the token holds. Slots map to postings as in JAX:
    slot j of an entry is posting s_eff + j with s_eff the start clamped
    to [0, P - lch]."""
    P = p_doc.shape[0]
    B, C = cand.shape
    dev = p_doc.device
    acc = torch.zeros(B * T * C, dtype=torch.float32, device=dev)
    df = torch.zeros(B * T, dtype=torch.int64, device=dev)
    W = wl_i.shape[1]
    iot = torch.arange(lch, device=dev)
    for j0 in range(0, W, _PLAIN_WCH):
        sl = slice(j0, min(W, j0 + _PLAIN_WCH))
        bw, tw, st, ln = (wl_i[r, sl].to(torch.int64) for r in range(4))
        ww, fbw, avw = (wl_f[r, sl][:, None] for r in range(3))
        docs, s_eff = _slices(p_doc, st, lch)
        tf, _ = _slices(tf_src, st, lch)
        fl, _ = _slices(p_flen, st, lch)
        validm = (iot < ln[:, None]) & ((s_eff[:, None] + iot) < P)
        denom = (1.0 - fbw) + fbw * fl / torch.clamp(avw, min=1e-9)
        ntf = ww * tf / torch.clamp(denom, min=1e-9)
        keepm = validm & (tf > 0)
        if fmask is not None:
            keepm &= fmask[docs.clamp(0, fmask.shape[0] - 1).long()] > 0.0
        df_inc = keepm.sum(dim=1)
        if nre:
            seen = torch.zeros_like(keepm)
            dl = docs.to(torch.int64)
            for e in range(nre):
                st_e = wl_prev[0, sl, e].to(torch.int64)[:, None]
                ln_e = wl_prev[1, sl, e].to(torch.int64)[:, None]
                pos = torch.zeros_like(dl)
                bstep = 1 << (bs_steps - 1)
                while bstep >= 1:
                    cpos = pos + bstep
                    ok = cpos <= ln_e
                    v = p_doc[(st_e + cpos - 1).clamp(0, P - 1)]
                    pos = torch.where(ok & (v < dl), cpos, pos)
                    bstep >>= 1
                at = (st_e + pos).clamp(0, P - 1)
                seen |= ((pos < ln_e) & (p_doc[at] == dl) & (ln_e > 0)
                         & (tf_src[at] > 0))
            df_inc = df_inc - (seen & keepm).sum(dim=1)
        row = bw * T + tw
        df.index_add_(0, row, df_inc)
        cw = cand[bw]                                          # (w, C)
        pos = torch.searchsorted(cw, docs, right=False).clamp(max=C - 1)
        hit = keepm & (cw.gather(1, pos) == docs)
        flat = row[:, None] * C + pos
        acc.index_add_(0, flat[hit], ntf[hit])
    return acc.view(B * T, C), df.to(torch.int32)


def _worklist_tail(acc_bt, df_bt, cand, n_docs, T: int):
    """The saturation tail (JAX `_rescore_worklist` after its scan):
    every slot of a repeated candidate takes its first slot's sum, then
    df -> idf -> saturation. Returns (scores, matched) f32[B, C]."""
    B, C = cand.shape
    first = torch.searchsorted(cand, cand, right=False)
    acc = acc_bt.view(B, T, C).gather(2, first[:, None, :].expand(B, T, C))
    df = torch.clamp(df_bt.view(B, T).to(torch.float32), min=1.0)
    idf_dev = torch.log1p((n_docs[:, None] - df + 0.5) / (df + 0.5))
    return _saturate(acc, idf_dev)


def rescore_worklist_plain(p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand,
                           wl_prev=None, fmask=None, *, lch: int, T: int,
                           nre: int = 0, bs_steps: int = 0, axis=None):
    """Plain PyTorch version of `rescore_worklist`."""
    acc, df = rescore_worklist_accumulate_plain(
        p_doc, tf_src, p_flen, wl_i, wl_f, cand, wl_prev, fmask,
        lch=lch, T=T, nre=nre, bs_steps=bs_steps)
    if axis is not None:
        df = axis.psum(df)  # global df over doc shards
    return _worklist_tail(acc, df, cand, n_docs, T)


def rescore_worklist(
    p_doc, tf_src, p_flen,
    wl_i,                      # int32[4, W]: b, t, start, len (len <= lch)
    wl_f,                      # f32[3, W]: weight, field_b, avg_flen
    n_docs,                    # f32[B] corpus size (for the idf)
    cand,                      # int32[B, C] sorted ascending (cap = empty)
    wl_prev=None,              # int32[2, W, NRE]: earlier spans of the token
    fmask=None,                # f32[L] filter (1 = doc allowed)
    *,
    lch: int, T: int, nre: int = 0, bs_steps: int = 0,
    fbits=None,                # int32[ceil(L / 32)]: pack_mask_bits(fmask)
    axis=None,                 # mesh axis for GLOBAL df under doc sharding
):
    """v3 phase 2: exact BM25F scores and matched-token counts of the
    candidates, streaming the worklist's postings; df (and so the idf) is
    counted on the device, under the filter and deduplicated across the
    token's spans. `fbits`, the filter's bitmap, is optional: the kernel
    reads it in place of `fmask`, whose plain version it equals. On a
    doc-sharded mesh (`axis` given) the pass and the tail launch apart,
    with the shards' df summed between them (`axis.psum`). Returns
    (scores f32[B, C], matched f32[B, C])."""
    _check(p_doc, "p_doc", torch.int32, 1)
    _check(tf_src, "tf_src", torch.float32, 1)
    _check(p_flen, "p_flen", torch.float32, 1)
    _check(wl_i, "wl_i", torch.int32, 2)
    _check(wl_f, "wl_f", torch.float32, 2)
    _check(n_docs, "n_docs", torch.float32, 1)
    _check(cand, "cand", torch.int32, 2)
    n = p_doc.shape[0]
    if tf_src.shape[0] != n or p_flen.shape[0] != n:
        raise ValueError("p_doc, tf_src and p_flen must have one length")
    W = wl_i.shape[1]
    if wl_i.shape[0] != 4 or tuple(wl_f.shape) != (3, W):
        raise ValueError("wl_i must be (4, W) and wl_f (3, W)")
    B, C = cand.shape
    if n_docs.shape[0] != B:
        raise ValueError("n_docs must be (B,)")
    if lch <= 0 or T <= 0:
        raise ValueError("lch and T must be positive")
    tensors = [p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand]
    if nre:
        if wl_prev is None:
            raise ValueError("nre > 0 needs wl_prev")
        _check(wl_prev, "wl_prev", torch.int32, 3)
        if tuple(wl_prev.shape) != (2, W, nre):
            raise ValueError(f"wl_prev must be {(2, W, nre)}")
        if not 1 <= bs_steps <= 31:
            raise ValueError(f"bs_steps must be in [1, 31], got {bs_steps}")
        tensors.append(wl_prev)
    if fmask is not None:
        _check(fmask, "fmask", torch.float32, 1)
        tensors.append(fmask)
    if fbits is not None:
        if fmask is None:
            raise ValueError("fbits is the bitmap of fmask: give both")
        _check(fbits, "fbits", torch.int32, 1)
        if fbits.shape[0] != -(-fmask.shape[0] // 32):
            raise ValueError("fbits must hold ceil(len(fmask) / 32) words")
        tensors.append(fbits)
    dev = _device_of(tensors)
    if dev.type == "cpu":
        return rescore_worklist_plain(
            p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand, wl_prev, fmask,
            lch=lch, T=T, nre=nre, bs_steps=bs_steps, axis=axis)
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    matched = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B * C == 0:
        return scores, matched
    # the pass's sums f32[B*T, C], then its df counts int32[B*T]
    work = torch.empty(B * T * C + B * T, dtype=torch.float32, device=dev)
    inputs = (p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand, wl_prev,
              fmask, fbits)
    kw = dict(lch=lch, T=T, nre=nre, bs_steps=bs_steps)
    if axis is None:
        _worklist_launch(inputs, (work, scores, matched), parts=7, **kw)
    else:
        _worklist_launch(inputs, (work, scores, matched), parts=3, **kw)
        df = work[B * T * C:].view(torch.int32)
        df.copy_(axis.psum(df))
        _worklist_launch(inputs, (work, scores, matched), parts=4, **kw)
    _build.count_launch(LAUNCHES, "rescore_worklist")
    return scores, matched


def _worklist_launch(inputs, outputs, *, lch, T, nre, bs_steps, parts):
    """Enqueue the stages `parts` of rescore_worklist (1 zeroes `work`, 2
    runs the pass, 4 the tail) on checked CUDA tensors: inputs as the
    wrapper takes them (p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand,
    wl_prev, fmask, fbits), outputs (work, scores, matched). The wrapper
    runs all three; benches time the pass alone."""
    (p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand, wl_prev, fmask,
     fbits) = inputs
    work, scores, matched = outputs
    B, C = cand.shape
    dev = p_doc.device
    lib = load_kernels()
    with torch.cuda.device(dev):
        err = lib.rescore_worklist_launch(
            p_doc.data_ptr(), tf_src.data_ptr(), p_flen.data_ptr(),
            p_doc.shape[0], wl_i.data_ptr(), wl_f.data_ptr(), wl_i.shape[1],
            n_docs.data_ptr(), cand.data_ptr(), B, C, T, lch,
            wl_prev.data_ptr() if nre else None, nre, bs_steps,
            fmask.data_ptr() if fmask is not None else None,
            fbits.data_ptr() if fbits is not None else None,
            fmask.shape[0] if fmask is not None else 0, worklist_blocks(lch),
            work.data_ptr(), scores.data_ptr(), matched.data_ptr(), parts,
            _stream(dev),
        )
    _raise_on(err, "rescore_worklist")


# ---------------------------------------------------------------------------
# fused searches
# ---------------------------------------------------------------------------

def _topk_tail(scores, matched, cand, thr_counts, omc, has_omc, cap, k):
    """Threshold, OMC, -inf fill and top-k: (vals f32[B, k], ids int32[B,
    k], cand_counts int32[B]). cand_counts counts the verified candidates
    that pass, a lower bound on the corpus-wide match count."""
    keep = (matched >= thr_counts[:, None]) & (scores > 0.0) & (cand < cap)
    if has_omc:
        s = scores * omc[cand.clamp(0, omc.shape[0] - 1).long()]
    else:
        s = scores
    counts = keep.sum(dim=1).to(torch.int32)
    s = torch.where(keep, s, float("-inf"))
    vals, ci = _top_k(s, k)
    return vals, cand.gather(1, ci), counts


def pruned_fulltext_topk(
    p_doc, p_tf, p_exact_tf, p_flen,
    pre_idesc,    # int32[2, B, T, NPR] impact-prefix ranges (lens <= lp)
    pre_fdesc,    # f32[3, B, T, NPR] weights, field_b, avg_flen
    wl_i,         # int32[4, W] rescore worklist: b, t, start, len<=lch
    wl_f,         # f32[3, W] weight, field_b, avg_flen per entry
    idf,          # f32[B, T] host idf, ranks phase-1 nominations only
    n_docs,       # f32[B] corpus size (device idf in the rescore)
    thr_counts,   # f32[B] min distinct matched tokens
    omc,          # f32[cap] (dummy (1,) when has_omc=False)
    wl_prev=None, # int32[2, W, NRE] earlier spans (multi-field df)
    fmask=None,   # f32[cap] filter mask (dummy when has_filter=False)
    cand_in=None, # int32[B, C] caller-supplied candidates (small filters)
    *,
    lp: int, lch: int, cap: int, C: int, k: int, T: int,
    exact: bool, has_omc: bool, nre: int = 0, bs_steps: int = 0,
    has_filter: bool = False, cand_given: bool = False,
    fbits=None,   # int32 bitmap of fmask (pack_mask_bits), optional
):
    """Fused v3 pruned full-text search: nomination (skipped when the
    caller gives the candidates), worklist rescore, tail. Returns (vals
    f32[B, k], ids int32[B, k], cand_counts int32[B])."""
    tf_src = p_exact_tf if exact else p_tf
    fm = fmask if has_filter else None
    fbits = fbits if has_filter else None
    if cand_given:
        cand = cand_in
    else:
        cand = _prefix_candidates(
            p_doc, tf_src, p_flen, pre_idesc[0], pre_idesc[1],
            pre_fdesc[0], pre_fdesc[1], pre_fdesc[2], idf, fm,
            lp=lp, cap=cap, C=C,
        )
    scores, matched = rescore_worklist(
        p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand, wl_prev, fm,
        lch=lch, T=T, nre=nre, bs_steps=bs_steps, fbits=fbits,
    )
    return _topk_tail(scores, matched, cand, thr_counts, omc, has_omc, cap, k)


def pruned_fulltext_topk_bs(
    p_doc, p_tf, p_flen,
    pre_starts, pre_lens,      # int32[B, T, NPR] impact-prefix ranges
    rng_i,                     # int32[2, B, T, NR] unsplit start/len
    rng_f,                     # f32[3, B, T, NR] weight, field_b, avg
    idf,                       # f32[B, T] exact host idf
    thr_counts,                # f32[B] min distinct matched tokens
    omc,                       # f32[cap] (dummy (1,) when has_omc=False)
    cand_in=None,              # int32[B, C] caller candidates (optional)
    pre_fdesc=None,            # f32[3, B, T, NPR] (nom_accum only)
    boff=None,                 # (flat, base, shift) bucket-offset tables
    *,
    hp: int, cap: int, k: int, bs_steps: int,
    has_omc: bool, cand_given: bool = False,
    nom_accum: bool = False, lp: int = 0, C: int = 0,
):
    """Fused v4 pruned full-text search: nomination (accumulated partial
    scores with nom_accum, else head slices), binary-search rescore,
    tail. The caller gates it: single-span tokens, non-exact tf, no
    filter. Returns (vals f32[B, k], ids int32[B, k], cand_counts
    int32[B])."""
    if cand_given:
        cand = cand_in
    elif nom_accum:
        cand = _prefix_candidates(
            p_doc, p_tf, p_flen, pre_starts, pre_lens,
            pre_fdesc[0], pre_fdesc[1], pre_fdesc[2], idf, None,
            lp=lp, cap=cap, C=C,
        )
    else:
        cand = _sliced_candidates(p_doc, pre_starts, pre_lens, hp=hp, cap=cap)
    scores, matched = rescore_bsearch(
        p_doc, p_tf, p_flen, rng_i[0], rng_i[1], rng_f[0], rng_f[1],
        rng_f[2], idf, cand, bs_steps=bs_steps, boff=boff,
    )
    return _topk_tail(scores, matched, cand, thr_counts, omc, has_omc, cap, k)


# ---------------------------------------------------------------------------
# exact counts
# ---------------------------------------------------------------------------

def pruned_exact_counts(
    p_doc, p_tf, p_exact_tf,
    wl_i,         # int32[4, W]: b, t, start, len<=lch (the rescore worklist)
    thr_counts,   # f32[B] min distinct matched tokens
    fmask=None,   # f32[cap] filter mask (dummy when has_filter=False)
    *,
    lch: int, cap: int, T: int, exact: bool, has_filter: bool = False,
):
    """EXACT corpus-wide match counts for the pruned path, the opt-in
    second dispatch: every worklist posting, one sort by (query, doc,
    token), then the distinct docs whose distinct-token run clears the
    query's threshold. Returns counts int32[B]."""
    tf_src = p_exact_tf if exact else p_tf
    return _exact_counts_core(
        p_doc, tf_src, wl_i, thr_counts, fmask if has_filter else None,
        lch=lch, cap=cap, T=T,
    )


def _exact_counts_core(p_doc, tf_src, wl_i, thr_counts, fmask=None, *,
                       lch: int, cap: int, T: int, axis=None):
    """The counting body of `pruned_exact_counts`. The JAX function's
    3-key sort on (b, doc, t) is one stable sort of int64 keys b << 39 |
    doc << 8 | t; run boundaries and cumsum / cummax count exactly. On a
    doc-sharded mesh a doc's postings all lie in its shard, so the
    shards' counts are disjoint and `axis.psum` sums them exactly."""
    B = thr_counts.shape[0]
    assert T < 256 and B < (1 << 24), "exact-count key fields overflow"
    P = p_doc.shape[0]
    dev = p_doc.device
    bw, tw, st, ln = (wl_i[r].to(torch.int64) for r in range(4))
    docs, s_eff = _slices(p_doc, st, lch)
    tf, _ = _slices(tf_src, st, lch)
    iot = torch.arange(lch, device=dev)
    valid = (iot < ln[:, None]) & ((s_eff[:, None] + iot) < P) & (tf > 0)
    if fmask is not None:
        valid &= fmask[docs.clamp(0, fmask.shape[0] - 1).long()] > 0.0
    bk = torch.where(valid, bw[:, None], B).reshape(-1)
    dk = torch.where(valid, docs.to(torch.int64), cap).reshape(-1)
    tk = torch.where(valid, tw[:, None], T).reshape(-1)
    key = torch.sort((bk << 39) | (dk << 8) | tk).values
    bk, dk, tk = key >> 39, (key >> 8) & 0x7FFFFFFF, key & 0xFF

    validk = bk < B
    same_doc = (bk[1:] == bk[:-1]) & (dk[1:] == dk[:-1])
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_tok = torch.cat([one, ~(same_doc & (tk[1:] == tk[:-1]))]) & validk
    is_end = torch.cat([~same_doc, one]) & validk
    # distinct tokens of a (b, doc) run: the inclusive distinct-triple
    # cumsum at its end less the value at the previous run's end
    s = torch.cumsum(new_tok.to(torch.int64), dim=0)
    e = torch.where(is_end, s, 0)
    prev_end = torch.cat([torch.zeros(1, dtype=s.dtype, device=dev),
                          torch.cummax(e, dim=0).values[:-1]])
    tokcnt = (s - prev_end).to(torch.float32)
    thr_b = thr_counts[bk.clamp(max=B - 1)]
    hit = is_end & (tokcnt >= torch.clamp(thr_b, min=1.0))
    counts = torch.bincount(bk[hit], minlength=B)[:B].to(torch.int32)
    if axis is not None:
        counts = axis.psum(counts)
    return counts


def estimate_match_count(n_docs: float, dfs) -> int:
    """Union-probability estimate of the corpus-wide match count for the
    pruned path: E[|union|] = N * (1 - prod_t (1 - df_t / N))."""
    n = max(float(n_docs), 1.0)
    miss = 1.0
    for df in dfs:
        miss *= max(0.0, 1.0 - float(df) / n)
    return int(round(n * (1.0 - miss)))


# ---------------------------------------------------------------------------
# facets: phase A (run-end reps of the matched docs), phase B (histograms)
# ---------------------------------------------------------------------------

def _match_reps_core(p_doc, tf_src, wl_i, thr: float, fmask=None, *,
                     lch: int, cap: int):
    """Distinct matched docs of a plan as sorted run-end reps: every
    worklist posting (the (W, lch) slices, clamped as JAX's), one sort of
    int64 keys doc << 32 | token (JAX's 2-key sort on (doc, token)), then
    rep = 1.0 at the end of each doc's run whose distinct-token count
    clears thr (thr <= 1 keeps any match). A run's count is the inclusive
    new-token scan at its end less the scan at its first element, which
    `searchsorted` over the sorted doc keys finds without a cummax.
    Returns (docs int32[N] ascending, cap = empty; rep f32[N]), N = W *
    lch."""
    P = p_doc.shape[0]
    dev = p_doc.device
    tw, st, ln = (wl_i[r].to(torch.int64) for r in (1, 2, 3))
    docs, s_eff = _slices(p_doc, st, lch)
    tf, _ = _slices(tf_src, st, lch)
    iot = torch.arange(lch, device=dev)
    valid = (iot < ln[:, None]) & ((s_eff[:, None] + iot) < P) & (tf > 0)
    if fmask is not None:
        valid &= fmask[docs.clamp(0, fmask.shape[0] - 1).long()] > 0.0
    dk = torch.where(valid, docs.to(torch.int64), cap)
    tk = torch.where(valid, tw[:, None], 2**30)
    key = torch.sort(((dk << 32) | tk).reshape(-1)).values
    dk = key >> 32
    validk = dk < cap
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_tok = torch.cat([one, key[1:] != key[:-1]]) & validk
    is_end = torch.cat([dk[1:] != dk[:-1], one]) & validk
    s = torch.cumsum(new_tok.to(torch.int32), dim=0)
    first = torch.searchsorted(dk, dk, right=False)
    tokcnt = s - s[first] + 1
    rep = (is_end & (tokcnt >= max(float(thr), 1.0))).to(torch.float32)
    return dk.to(torch.int32), rep


def pruned_match_reps(
    p_doc, p_tf, p_exact_tf,
    wl_i,         # int32[4, W]: b(=0), t, start, len<=lch
    thr: float,   # min distinct matched tokens (<= 1 = any)
    fmask=None,   # f32[cap] alive mask (used when has_filter)
    *,
    lch: int, cap: int, exact: bool, has_filter: bool = False,
):
    """Phase A of the facet path: (docs, rep) for phase B, computed once
    per plan. rep.sum() is the exact match count under the threshold and
    the mask."""
    tf_src = p_exact_tf if exact else p_tf
    return _match_reps_core(p_doc, tf_src, wl_i, thr,
                            fmask if has_filter else None, lch=lch, cap=cap)


def _vec_reps_core(vdocs, docs_ft, rep_ft, cap: int):
    """One rep per distinct vector-candidate doc that the full-text reps do
    not already count: vdocs int32[V] (cap = none) sorted; a doc is counted
    by the full-text side when its run end (lower_bound(doc + 1) - 1 in
    the ascending docs_ft) has rep > 0. A doc that fails its threshold has
    rep 0 there, so the vector side counts it. Returns (vd int32[V], vrep
    f32[V])."""
    vd = torch.sort(vdocs).values
    one = torch.ones(1, dtype=torch.bool, device=vd.device)
    is_end = torch.cat([vd[1:] != vd[:-1], one]) & (vd < cap)
    ub = torch.searchsorted(docs_ft, vd + 1, right=False) - 1
    ubc = ub.clamp(min=0)
    member = (ub >= 0) & (docs_ft[ubc] == vd) & (rep_ft[ubc] > 0.0)
    return vd, (is_end & ~member).to(torch.float32)


def _probe_docs(queries, mat_i8, scales, row_doc, unit_cen, unit_starts,
                doc_mask, *, V: int, nprobe: int, window: int, cap: int):
    """The IVF probe's top-V rows as (vals f32[B, V], docs int32[B, V]),
    docs = cap where a slot holds no row. `doc_mask` bool[B, L] pushes a
    filter into the scan (None: no filter)."""
    vals, rows = ivf_int8_topk_masked(
        queries, mat_i8, scales, row_doc, unit_cen, unit_starts, doc_mask,
        k=V, nprobe=nprobe, window=window, has_mask=doc_mask is not None)
    docs = row_doc[rows.clamp(0, row_doc.shape[0] - 1).long()]
    ok = (rows >= 0) & (vals > NEG_INF / 2)
    return vals, torch.where(ok, docs, cap)


def pruned_hybrid_match_reps(
    docs_ft, rep_ft,   # phase A's full-text reps (pruned_match_reps)
    mat_i8, scales, row_doc, unit_cen, unit_starts,
    query,             # f32[1, dim] L2-normalized
    sim: float,        # similarity floor
    fmask=None,        # f32[cap] alive mask (used when has_filter)
    *,
    V: int, nprobe: int, window: int, cap: int, pad: int,
    has_filter: bool, has_rescale: bool,
    rescale_lo: float, rescale_hi: float,
):
    """Hybrid phase A: the IVF probe's top-V rows (under the mask), kept
    where valid, >= sim and > 0 after rescale (as the dense int8 path's
    scatter-max sets its match set), deduplicated against the full-text
    reps and appended, padded with `pad - V` sentinel slots."""
    mask2d = (fmask > 0.0)[None, :] if has_filter else None
    vals, rows = ivf_int8_topk_masked(
        query, mat_i8, scales, row_doc, unit_cen, unit_starts, mask2d,
        k=V, nprobe=nprobe, window=window, has_mask=has_filter)
    vals, rows = vals[0], rows[0]
    if has_rescale:
        vals = _rescale(vals, rescale_lo, rescale_hi)
    keep = (rows >= 0) & (vals >= sim) & (vals > 0.0)
    vd = torch.where(
        keep, row_doc[rows.clamp(0, row_doc.shape[0] - 1).long()], cap)
    vd, vrep = _vec_reps_core(vd, docs_ft, rep_ft, cap)
    fill = pad - V
    vd = torch.cat([vd, vd.new_full((fill,), cap)])
    vrep = torch.cat([vrep, vrep.new_zeros(fill)])
    return torch.cat([docs_ft, vd]), torch.cat([rep_ft, vrep])


# ---------------------------------------------------------------------------
# the pruned hybrid over the int8 IVF layout
# ---------------------------------------------------------------------------

# f32 elements of the upcast candidate rows one step of the gather-dot
# materialises (1 GiB)
_GATHER_ELEMS = 1 << 28


def _candidate_vec(cand, doc2row, mat_i8, scales, queries, cap: int):
    """Each candidate's vector score: its doc's int8 row (doc2row) times
    the bf16-rounded query, in f32, times the row's scale; 0 where the doc
    has no row or the slot is empty. f32[B, Ct]."""
    B, Ct = cand.shape
    rows_c = doc2row[cand.clamp(0, doc2row.shape[0] - 1).long()]
    safe = rows_c.clamp(0, mat_i8.shape[0] - 1).long()
    q = _bf16(queries)
    vec = torch.empty((B, Ct), dtype=torch.float32, device=cand.device)
    step = max(1, _GATHER_ELEMS // max(Ct * mat_i8.shape[1], 1))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        tiles = mat_i8[safe[sl]].float()                     # (b, Ct, D)
        vec[sl] = torch.bmm(tiles, q[sl, :, None]).squeeze(2)
    vec = vec * scales[safe]
    return torch.where((rows_c >= 0) & (cand < cap), vec, 0.0)


def _hybrid_tail(scores, matched, cand, v_vals, v_docs, vec, sim, thr_counts,
                 omc, *, has_omc: bool, cap: int, k: int, has_rescale: bool,
                 rescale_lo: float, rescale_hi: float):
    """Fold the probe's own values into the candidates' vector scores
    (scatter-max: a miss writes max(vec, 0) at its clamped slot, as JAX's
    `.at[].max` does), rescale, similarity floor, min-max fusion over the
    candidates (span 1 where nothing scored), OMC, -inf for absent docs,
    top-k in `lax.top_k`'s order. Returns (vals, ids, counts)."""
    Ct = cand.shape[1]
    pos = _lower_bound(cand, v_docs).clamp(max=Ct - 1).long()
    hit = (cand.gather(1, pos) == v_docs) & (v_docs < cap)
    vec = vec.scatter_reduce(1, pos, torch.where(hit, v_vals, 0.0), "amax",
                             include_self=True)
    if has_rescale:
        vec = _rescale(vec, rescale_lo, rescale_hi)
    vec = torch.where(vec >= sim[:, None], vec, 0.0)
    ft_keep = (scores > 0.0) & (matched >= thr_counts[:, None]) & (cand < cap)
    vc_keep = (vec > 0.0) & (cand < cap)
    ft = torch.where(ft_keep, scores, 0.0)
    vc = torch.where(vc_keep, vec, 0.0)
    hi = torch.maximum(ft.amax(dim=1), vc.amax(dim=1))
    span = torch.where(hi > 0.0, hi, 1.0)
    fused = (ft + vc) / span[:, None]
    if has_omc:
        fused = fused * omc[cand.clamp(0, omc.shape[0] - 1).long()]
    present = ft_keep | vc_keep
    counts = present.sum(dim=1).to(torch.int32)
    s = torch.where(present, fused, float("-inf"))
    vals, ci = _top_k(s, k)
    return vals, cand.gather(1, ci), counts


def pruned_hybrid_topk_int8(
    p_doc, p_tf, p_exact_tf, p_flen,
    pre_idesc, pre_fdesc, wl_i, wl_f,
    idf, n_docs, thr_counts,
    mat_i8,       # int8[N, D] packed by cluster
    scales,       # f32[N]
    row_doc,      # int32[N] packed row -> doc id
    unit_cen,     # f32[U, D]
    unit_starts,  # int32[U]
    doc2row,      # int32[cap + 1] doc id -> packed row (-1 = no vector)
    queries,      # f32[B, dim] L2-normalized
    sim,          # f32[B] similarity floor
    omc,          # f32[cap] (dummy (1,) when has_omc=False)
    wl_prev=None, # int32[2, W, NRE] earlier spans (multi-field df)
    fmask=None,   # f32[cap] filter mask (used when has_filter)
    cand_in=None, # int32[B, Ct] caller-supplied candidates (small filters)
    *,
    lp: int, lch: int, cap: int, C: int, k: int, T: int,
    exact: bool, has_omc: bool,
    V: int, nprobe: int, window: int,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
    nre: int = 0, bs_steps: int = 0,
    has_filter: bool = False, cand_given: bool = False,
    fbits=None,   # int32 bitmap of fmask (pack_mask_bits), optional
):
    """Fused v3 pruned hybrid: candidates = the full-text top C (or the
    caller's) united with the IVF probe's top-V docs (inside the filter),
    both sides scored exactly on them (`rescore_worklist`; the int8 row
    gather-dot), fused by min-max over the candidates. Returns (vals f32[B,
    k], ids int32[B, k], counts int32[B])."""
    tf_src = p_exact_tf if exact else p_tf
    fm = fmask if has_filter else None
    v_vals, v_docs = _probe_docs(
        queries, mat_i8, scales, row_doc, unit_cen, unit_starts, None,
        V=V, nprobe=nprobe, window=window, cap=cap)
    if fm is not None:
        # out-of-filter probe hits never become candidates
        inside = fm[v_docs.clamp(0, fm.shape[0] - 1).long()] > 0.0
        v_docs = torch.where(inside, v_docs, cap)
    if cand_given:
        cand = cand_in
    else:
        ft_cand = _prefix_candidates(
            p_doc, tf_src, p_flen, pre_idesc[0], pre_idesc[1],
            pre_fdesc[0], pre_fdesc[1], pre_fdesc[2], idf, fm,
            lp=lp, cap=cap, C=C,
        )
        cand = _dedup_sorted(torch.cat([ft_cand, v_docs], dim=1), cap)
    scores, matched = rescore_worklist(
        p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand, wl_prev, fm,
        lch=lch, T=T, nre=nre, bs_steps=bs_steps,
        fbits=fbits if has_filter else None,
    )
    vec = _candidate_vec(cand, doc2row, mat_i8, scales, queries, cap)
    return _hybrid_tail(
        scores, matched, cand, v_vals, v_docs, vec, sim, thr_counts, omc,
        has_omc=has_omc, cap=cap, k=k, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi)


def pruned_hybrid_topk_int8_bs(
    p_doc, p_tf, p_flen,
    pre_starts, pre_lens, rng_i, rng_f,
    idf, thr_counts,
    mat_i8, scales, row_doc, unit_cen, unit_starts, doc2row,
    queries, sim, omc,
    cand_in=None,
    pre_fdesc=None,
    boff=None,                 # (flat, base, shift) bucket-offset tables
    *,
    hp: int, cap: int, k: int, bs_steps: int, has_omc: bool,
    V: int, nprobe: int, window: int,
    has_rescale: bool, rescale_lo: float, rescale_hi: float,
    cand_given: bool = False,
    nom_accum: bool = False, lp: int = 0, C: int = 0,
):
    """Fused v4 pruned hybrid: the full-text side nominates as
    `pruned_fulltext_topk_bs` does and rescores with `rescore_bsearch`;
    the vector side and the fusion are those of v3. Same gating as the
    full-text v4 route (no filter, non-exact tf, single-span tokens)."""
    v_vals, v_docs = _probe_docs(
        queries, mat_i8, scales, row_doc, unit_cen, unit_starts, None,
        V=V, nprobe=nprobe, window=window, cap=cap)
    if cand_given:
        cand = cand_in
    else:
        if nom_accum:
            ft_cand = _prefix_candidates(
                p_doc, p_tf, p_flen, pre_starts, pre_lens,
                pre_fdesc[0], pre_fdesc[1], pre_fdesc[2], idf, None,
                lp=lp, cap=cap, C=C,
            )
        else:
            ft_cand = _sliced_candidates(p_doc, pre_starts, pre_lens, hp=hp,
                                         cap=cap)
        cand = _dedup_sorted(torch.cat([ft_cand, v_docs], dim=1), cap)
    scores, matched = rescore_bsearch(
        p_doc, p_tf, p_flen, rng_i[0], rng_i[1], rng_f[0], rng_f[1],
        rng_f[2], idf, cand, bs_steps=bs_steps, boff=boff,
    )
    vec = _candidate_vec(cand, doc2row, mat_i8, scales, queries, cap)
    return _hybrid_tail(
        scores, matched, cand, v_vals, v_docs, vec, sim, thr_counts, omc,
        has_omc=has_omc, cap=cap, k=k, has_rescale=has_rescale,
        rescale_lo=rescale_lo, rescale_hi=rescale_hi)
