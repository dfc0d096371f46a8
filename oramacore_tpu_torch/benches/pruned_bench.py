"""The pruned tier's 10M-doc text configuration, the checks and timings
of its two rescore kernels that `chip_smoke.py` runs, and their bench.

    python -m oramacore_tpu_torch.benches.pruned_bench [--baseline OLD.cu]

The bench builds the index on the card, records the rescore calls of
phase 12's first v4 B=64 batch, the first chunk of its v4 B=256 batch and
its v3 B=64 batch under the 50% filter, holds each kernel to its plain
version there and times it as CUDA-graph replays: the wrapper with the L2
warm (as phase 12 does) and cold, and the kernel alone (for the worklist,
the pass without the zeroing and the tail) cold, beside the bound and the
design's sector-level bytes, then the limit cases (`limit_cases`).
`--baseline OLD.cu` builds the earlier `pruned_rescore.cu` (one thread
per (query, candidate) and one block per worklist entry; e.g. `git show
966d65d:oramacore_tpu_torch/ops/csrc/pruned_rescore.cu` into the
gitignored `build/archive/`) and times it in turns with the current
kernels: baseline, current, current, baseline.

The data is the text side of `benches/hybrid10m_bench.py` at its defaults
(`:50-71`, `:139-205`), made with numpy from a seed in place of
`jax.random`: N = 20 x 524,288 = 10,485,760 docs and P = 2^27 postings
over a vocabulary of 65,536 terms with df proportional to 1 / (rank +
50). Term t's doc ids are a stratified uniform sample, doc-sorted by
construction: doc_j = floor((j + u_j (1 - df/N)) N / df), the bench's
sample with u_j scaled so that no two postings of a term share a doc
(the engine dedups (term, doc) pairs at commit). tf is iid uniform in
{1, 2, 3} (the bench's default, the worst case for impact nomination),
flen uniform on [5, 50), the field's average length 27.5. It is one
committed segment of field "body" in the port's `StringIndex`, whose
commit-time side blocks give the top-PREFIX_LEN postings by impact of
each term with df > PREFIX_LEN (about 235 terms) to the nomination.

Queries are 3 terms with ranks log-uniform in [10, 5000) (`:400-405`):
df from about 300k down to about 3.5k.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import bound_ms, time_cuda, time_graph

CH = 524288                     # docs per chunk of the bench
N_CHUNKS = 20
N_DOCS = N_CHUNKS * CH          # 10,485,760
N_POSTINGS = 128 * 1024 * 1024  # 134,217,728
V_TERMS = 65536
AVG_FLEN = 27.5
FIELD = "body"

_GEN_CHUNK = 1 << 23            # postings generated per numpy step


def synth_postings(n_docs: int, n_postings: int, vocab: int = V_TERMS,
                   seed: int = 0):
    """(doc int32[P], tf f32[P], flen f32[P], starts int64[vocab], df
    int64[vocab]): per-term doc-sorted ranges, see the module doc."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(vocab, dtype=np.float64) + 50.0)
    df = np.maximum((w / w.sum() * n_postings).astype(np.int64), 1)
    df[0] += n_postings - df.sum()          # exact total
    assert df.max() <= n_docs, "a term cannot hold more docs than the corpus"
    tstart = np.zeros(vocab + 1, np.int64)
    np.cumsum(df, out=tstart[1:])
    doc = np.empty(n_postings, np.int32)
    tf = np.empty(n_postings, np.float32)
    flen = np.empty(n_postings, np.float32)
    for c0 in range(0, n_postings, _GEN_CHUNK):
        c1 = min(n_postings, c0 + _GEN_CHUNK)
        idx = np.arange(c0, c1, dtype=np.int64)
        term = np.searchsorted(tstart, idx, side="right") - 1
        dft = df[term].astype(np.float64)
        u = rng.random(c1 - c0) * (1.0 - dft / n_docs)
        d = ((idx - tstart[term]) + u) * (n_docs / dft)
        doc[c0:c1] = np.minimum(d.astype(np.int64), n_docs - 1)
        tf[c0:c1] = 1.0 + np.floor(rng.random(c1 - c0) * 3.0)
        flen[c0:c1] = 5.0 + rng.random(c1 - c0) * 45.0
    return doc, tf, flen, tstart[:-1], df


def build_index(n_docs: int = N_DOCS, n_postings: int = N_POSTINGS,
                vocab: int = V_TERMS, seed: int = 0):
    """The corpus as one committed segment of field "body" (terms "t0",
    "t1", ... by rank) in the port's StringIndex, with its impact-prefix
    side blocks; the slab is built. Raises if a term with df >
    PREFIX_LEN got no side block (nomination would then read clipped
    whole ranges)."""
    from ..index import string_index as si

    doc, tf, flen, starts, df = synth_postings(n_docs, n_postings, vocab, seed)
    stats = si.FieldStats(doc_count=n_docs, sum_len=AVG_FLEN * n_docs)
    cf = si._CommittedField(
        terms=[f"t{i}" for i in range(vocab)],
        starts=starts, lens=df.astype(np.int32),
        doc=doc, tf=tf, exact_tf=tf, flen=flen, stats=stats,
    )
    si.StringIndex._build_prefix_blocks(cf)
    idx = si.StringIndex()
    idx._committed[FIELD] = [cf]
    idx._stats[FIELD] = si.FieldStats(n_docs, AVG_FLEN * n_docs)
    idx.slab_split()
    heavy = {f"t{i}" for i in np.nonzero(df > si.PREFIX_LEN)[0]}
    blocks = {term for (_f, term) in idx._slab_prefix_ranges}
    if heavy != blocks:
        raise RuntimeError(f"{len(heavy)} terms with df > PREFIX_LEN, "
                           f"{len(blocks)} side blocks")
    return idx


def term_sets(B: int, T: int = 3, seed: int = 7) -> np.ndarray:
    """Term ranks int64[B, T], log-uniform in [10, 5000)."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(10), np.log(5000), size=(B, T))).astype(
        np.int64)


def make_queries(B: int, T: int = 3, seed: int = 7) -> List[List[str]]:
    return [[f"t{r}" for r in row] for row in term_sets(B, T, seed)]


def match_count(idx, tokens, doc_mask: Optional[np.ndarray] = None) -> int:
    """Docs holding at least one of the tokens in field "body" (inside
    the mask): the exact match count of an unthresholded query."""
    p_doc = idx.slab()[0]
    parts = [p_doc[s:s + n] for t in tokens
             for (s, n) in idx._match_terms(FIELD, t, None)]
    docs = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int32)
    if doc_mask is not None:
        docs = docs[doc_mask[docs]]
    return int(len(docs))


# ---------------------------------------------------------------------------
# phase-1 nomination, in numpy (float64)
# ---------------------------------------------------------------------------

def nominate_numpy(slab, plan, idf_row, fmask=None, exact=False) -> Dict[int, float]:
    """One query's phase-1 partial scores {doc: score} from its plan's
    impact-prefix ranges: per (doc, token) summed ntf, saturated with
    the host idf, summed over tokens."""
    p_doc, p_tf, p_etf, p_flen = slab
    tf_src = p_etf if exact else p_tf
    part: Dict[int, float] = {}
    for t in range(plan.pre_starts.shape[0]):
        acc: Dict[int, float] = {}
        for r in range(plan.pre_starts.shape[1]):
            s, n = int(plan.pre_starts[t, r]), int(plan.pre_lens[t, r])
            if n <= 0:
                continue
            d = p_doc[s:s + n].astype(np.int64)
            tf = tf_src[s:s + n].astype(np.float64)
            fl = p_flen[s:s + n].astype(np.float64)
            w, fb, av = (float(a[t, r]) for a in (
                plan.pre_weights, plan.pre_field_b, plan.pre_avg))
            ntf = w * tf / np.maximum((1.0 - fb) + fb * fl / max(av, 1e-9),
                                      1e-9)
            keep = tf > 0
            if fmask is not None:
                keep &= fmask[d] > 0
            for doc, v in zip(d[keep].tolist(), ntf[keep].tolist()):
                acc[doc] = acc.get(doc, 0.0) + v
        idf_t = float(idf_row[t])
        for doc, a in acc.items():
            if a > 0:
                part[doc] = part.get(doc, 0.0) + idf_t * 2.2 * a / (1.2 + a)
    return part


def nomination_errors(cand_row, partial: Dict[int, float], C: int, cap: int,
                      rtol: float = 1e-5, extra=(), edge=()) -> List[str]:
    """A device candidate set against the numpy nomination united with
    the docs of `extra` (a probe's hits): equal outside near-ties at the
    C-th partial score (relative rtol) and outside the docs of `edge`,
    which may be in the set or not."""
    got = {int(d) for d in cand_row if d < cap}
    ranked = sorted(partial.items(), key=lambda kv: -kv[1])
    kth = ranked[C - 1][1] if len(ranked) >= C else 0.0
    top, extra = {d for d, _ in ranked[:C]}, set(extra)
    errs = []
    for d in got ^ (top | extra):
        s = partial.get(d, 0.0)
        near = abs(s - kth) <= rtol * max(abs(kth), 1e-30)
        if d in got:
            wrong = not (near or d in edge)
        else:
            wrong = (d in top and not near) or (d in extra and d not in edge)
        if wrong:
            errs.append(f"doc {d} (partial {s}, C-th {kth}) "
                        f"{'only on the device' if d in got else 'missed'}")
    return errs


# ---------------------------------------------------------------------------
# the rescore kernels at a call's own inputs
# ---------------------------------------------------------------------------

def capture(module, name: str, run):
    """Run `run()` with `module.<name>` wrapped: returns (its result, the
    positional and keyword arguments of every call, tensors cloned)."""
    real = getattr(module, name)
    calls = []

    def record(*args, **kw):
        calls.append((
            tuple(a.clone() if isinstance(a, torch.Tensor) else
                  tuple(x.clone() for x in a) if isinstance(a, tuple) else a
                  for a in args),
            {k: (tuple(x.clone() for x in v) if isinstance(v, tuple) else v)
             for k, v in kw.items()},
        ))
        return real(*args, **kw)

    setattr(module, name, record)
    try:
        out = run()
    finally:
        setattr(module, name, real)
    return out, calls


def bsearch_bound(args, kw):
    """(bytes, ops) one rescore_bsearch call must move and do: per
    (query, token, range, candidate) search of a non-empty range, 4 B per
    binary-search round its window needs, the bucket pair, the final doc
    and, on a hit, tf and flen; the candidates, descriptors and outputs
    once. Ops: ~8 f32 operations per search."""
    from ..ops import pruned as pr

    p_doc, tf_src, p_flen, st, ln, w, fb, av, idf, cand = args
    B, T, NR = st.shape
    C = cand.shape[1]
    boff = kw.get("boff")
    cq = cand.to(torch.int64)[:, None, None, :]
    live = (ln > 0)[..., None].expand(B, T, NR, C)
    if boff is not None:
        flat, base, shift = boff
        at_j = base.to(torch.int64)[..., None] + (cq >> shift.to(torch.int64)[..., None])
        L = flat.shape[0]
        window = (flat[(at_j + 1).clamp(0, L - 1)]
                  - flat[at_j.clamp(0, L - 1)]).to(torch.float64)
    else:
        window = ln.to(torch.float64)[..., None].expand(B, T, NR, C)
    rounds = torch.ceil(torch.log2(window.clamp(min=0) + 1.0))
    scores, matched = pr.rescore_bsearch_plain(*args, **kw)
    hits = float(matched.sum())
    n_search = float(live.sum())
    per_search = 4 + (8 if boff is not None else 0)
    n_bytes = (4 * float(rounds[live].sum()) + per_search * n_search
               + 8 * hits + 4 * B * C + 20 * B * T * NR + 4 * B * T
               + 8 * B * C)
    return n_bytes, 8 * n_search


def _filter_units(p_doc, tf_src, wl_i, lch: int, docs_per_unit: int) -> float:
    """Distinct units of `docs_per_unit` docs that the docs of the entry
    postings the filter is read for (in the entry, inside the slab, tf >
    0) fall in."""
    from ..ops import pruned as pr

    n = p_doc.shape[0]
    ln = wl_i[3].to(torch.int64).clamp(min=0)
    s_eff = wl_i[2].to(torch.int64).clamp(0, max(n - lch, 0))
    docs, _ = pr._slices(p_doc, wl_i[2], lch)
    tf, _ = pr._slices(tf_src, wl_i[2], lch)
    slot = torch.arange(lch, device=p_doc.device)
    kept = (slot < ln[:, None]) & ((s_eff[:, None] + slot) < n) & (tf > 0)
    return float(torch.unique(docs[kept].to(torch.int64)
                              // docs_per_unit).numel())


def worklist_bound(args, kw):
    """(bytes, ops) one rescore_worklist call must move and do: 8 B (doc,
    tf) per entry posting, 4 B of flen per candidate hit, the filter as
    the bitmap's 4-byte words that the kept postings' docs touch (a bit a
    doc is all the call needs: at most n_docs / 8 bytes); the worklist,
    the candidate table and the (B*T, C) sums once. PR 5's count took 4 B
    of f32 mask per kept posting instead, more than the whole bitmap and
    the whole mask. Ops: the ntf formula (6) per hit and the log2(C)
    compares of each kept posting's lookup."""
    p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand = args[:7]
    fmask = args[8] if len(args) > 8 else kw.get("fmask")
    T = kw["T"]
    B, C = cand.shape
    n_post = float(wl_i[3].clamp(min=0).sum())
    from ..ops import pruned as pr

    acc, _df = pr.rescore_worklist_accumulate_plain(
        p_doc, tf_src, p_flen, wl_i, wl_f, cand,
        args[7] if len(args) > 7 else kw.get("wl_prev"), fmask,
        lch=kw["lch"], T=T, nre=kw.get("nre", 0),
        bs_steps=kw.get("bs_steps", 0))
    hits = float((acc > 0).sum())
    words = (_filter_units(p_doc, tf_src, wl_i, kw["lch"], 32)
             if fmask is not None else 0.0)
    n_bytes = (8 * n_post + 4 * words + 4 * hits + 28 * wl_i.shape[1]
               + 4 * B * C + 4 * B * T * C + 4 * B * T + 8 * B * C)
    ops = 6 * hits + np.log2(max(C, 2)) * n_post
    return n_bytes, ops


def _sector_span(first, count):
    """32-byte sectors that `count` int32 / f32 values from index `first`
    cover (0 where count is 0)."""
    last = first + count - 1
    return torch.where(count > 0, (4 * last) // 32 - (4 * first) // 32 + 1, 0)


def bsearch_sectors(args, kw) -> float:
    """Device-memory bytes the redesigned rescore_bsearch moves, counted
    in 32-byte sectors per search (no sharing between searches), as the
    kernel reads the window: the bucket pair's sector; a window of up to
    13 postings in one chunk; a wider one in the chunk guessed at the
    doc's even-spread place (bucket tables) and, where the search ends
    outside it, 8 probe sectors a round of probes and 2 for the last
    chunk; tf and flen's sectors on a hit; the candidates, descriptors,
    idf and outputs once."""
    p_doc, tf_src, p_flen, st, ln, w, fb, av, idf, cand = args
    B, T, NR = st.shape
    C = cand.shape[1]
    boff = kw.get("boff")
    cq = cand.to(torch.int64)[:, None, None, :]
    s0 = st.to(torch.int64)[..., None]
    live = (ln > 0)[..., None].expand(B, T, NR, C)
    if boff is not None:
        flat, base, shift = boff
        L = flat.shape[0]
        at_j = base.to(torch.int64)[..., None] + (cq >> shift.to(torch.int64)[..., None])
        lo = flat[at_j.clamp(0, L - 1)].to(torch.int64)
        hi = flat[(at_j + 1).clamp(0, L - 1)].to(torch.int64)
    else:
        lo = torch.zeros_like(cq.expand(B, T, NR, C))
        hi = ln.to(torch.int64)[..., None].expand(B, T, NR, C)
    hi = torch.minimum(hi, lo + (1 << kw["bs_steps"]) - 1)
    width = (hi - lo).clamp(min=0)
    # where the search ends (the plain version's rounds)
    n = p_doc.shape[0]
    pos = lo.clone()
    step = 1 << (kw["bs_steps"] - 1)
    while step >= 1:
        probe = pos + step
        v = p_doc[(s0 + probe - 1).clamp(0, n - 1)]
        pos = torch.where((probe <= hi) & (v < cq), probe, pos)
        step >>= 1

    def rounds(rest):   # probe rounds of 8 that cut `rest` to one chunk
        return torch.ceil(torch.log(rest.to(torch.float64).clamp(min=13) / 13)
                          / np.log(8.0))

    # up to 13 postings: one chunk; wider: rounds of 8 probes, then a chunk
    # (<= 2 sectors); with bucket tables a guessed chunk comes first
    win = torch.where(width <= 13, _sector_span(s0 + lo, width).to(torch.float64),
                      8.0 * rounds(width) + 2)
    if boff is not None:
        sh = shift.to(torch.int64)[..., None].clamp(0, 31)
        est = lo + (((cq & ((1 << sh) - 1)) * width) >> sh)
        c0 = torch.minimum(torch.maximum(est - 8, lo), hi - 13)
        take = torch.minimum(hi - c0, 16 - ((s0 + c0) & 3))
        inside = ((pos > c0) & (pos < c0 + take)) | (pos == c0) & (c0 == lo) \
            | (pos == c0 + take) & (c0 + take == hi)
        rest = torch.where(pos <= c0, c0 - lo, hi - c0 - take)
        guessed = _sector_span(s0 + c0, take).to(torch.float64) + torch.where(
            inside, 0.0, 8.0 * rounds(rest) + 2)
        win = torch.where(width <= 13, win, guessed)
    from ..ops import pruned as pr

    _s, matched = pr.rescore_bsearch_plain(*args, **kw)
    n_search = float(live.sum())
    return (32 * float(win[live].sum())
            + (32 * n_search if boff is not None else 0)
            + 64 * float(matched.sum())
            + 4 * B * C + 20 * B * T * NR + 4 * B * T + 8 * B * C)


def worklist_sectors(args, kw) -> float:
    """Device-memory bytes the redesigned rescore_worklist moves, counted
    in 32-byte sectors: each entry's doc and tf sectors, the filter's
    distinct sectors that the kept docs touch (of the bitmap when the
    call has one, else of the f32 mask; both stay in L2 after the first
    touch), flen's sector per hit, the worklist, the candidates, and the
    sums and df zeroed, added and read once."""
    p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand = args[:7]
    fmask = args[8] if len(args) > 8 else kw.get("fmask")
    fbits = kw.get("fbits")
    lch, T = kw["lch"], kw["T"]
    B, C = cand.shape
    n = p_doc.shape[0]
    ln = wl_i[3].to(torch.int64).clamp(min=0)
    s_eff = wl_i[2].to(torch.int64).clamp(0, max(n - lch, 0))
    n_bytes = 2 * 32 * float(_sector_span(s_eff, ln).sum())
    if fmask is not None:   # docs a sector covers: 256 of bits, 8 of f32
        n_bytes += 32 * _filter_units(p_doc, tf_src, wl_i, lch,
                                      256 if fbits is not None else 8)
    from ..ops import pruned as pr

    acc, _df = pr.rescore_worklist_accumulate_plain(
        p_doc, tf_src, p_flen, wl_i, wl_f, cand,
        args[7] if len(args) > 7 else kw.get("wl_prev"), fmask,
        lch=lch, T=T, nre=kw.get("nre", 0), bs_steps=kw.get("bs_steps", 0))
    hits = float((acc > 0).sum())
    return (n_bytes + 32 * hits + 28 * wl_i.shape[1] + 4 * B * C
            + 3 * 4 * (B * T * C + B * T) + 8 * B * C)


def _plain_kw(kw):
    """A recorded call's keyword arguments for the plain version, which
    reads the f32 mask and takes no bitmap."""
    return {k: v for k, v in kw.items() if k != "fbits"}


def check_kernel(name: str, args, kw, reps: int = 20, timed: bool = True) -> Dict:
    """One rescore kernel against its plain version at a recorded call's
    inputs (scores within rtol 1e-5 / atol 1e-5, matched exact), then,
    when `timed`, the wrapper's time (a CUDA graph replay), the plain
    version's, the bound (bsearch_bound / worklist_bound) and the
    design's sector-level bytes."""
    from ..ops import pruned as pr

    kernel = getattr(pr, name)
    plain = getattr(pr, f"{name}_plain")
    before = pr.LAUNCHES[name]
    scores, matched = kernel(*args, **kw)
    ps, pm = plain(*args, **_plain_kw(kw))
    torch.cuda.synchronize()
    if pr.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch its kernel")
    err = float((scores - ps).abs().max()) if scores.numel() else 0.0
    if not torch.equal(matched, pm):
        raise AssertionError(f"{name}: matched differs from the plain version")
    if not torch.allclose(scores, ps, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: scores outside rtol 1e-5 / atol 1e-5 "
                             f"of the plain version (max abs err {err:.3g})")
    out = dict(max_abs_err=err, library_ms=None,
               hits=float((matched > 0).sum()))
    if not timed:
        return out
    ms = time_graph(lambda: kernel(*args, **kw), reps)
    plain_ms = time_cuda(lambda: plain(*args, **_plain_kw(kw)), 3)
    n_bytes, ops = (bsearch_bound if name == "rescore_bsearch"
                    else worklist_bound)(args, kw)
    bound, by = bound_ms(n_bytes, ops)
    sectors = (bsearch_sectors if name == "rescore_bsearch"
               else worklist_sectors)(args, kw)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               bytes=n_bytes, sector_bytes=sectors)
    return out


# ---------------------------------------------------------------------------
# the bench: an earlier design against the current one, in turns
# ---------------------------------------------------------------------------

def route_batch(route: int, j: int, B: int, n_shared: int = 4):
    """Batch j of route `route` of chip_smoke.py's phase 12: the first
    batch opens with the n_shared checked queries (seed 7), every other
    batch is distinct."""
    head = make_queries(n_shared, seed=7)[:B] if j == 0 else []
    return head + make_queries(B - len(head), seed=1000 * route + j)


def half_mask(n: int = N_DOCS) -> np.ndarray:
    """Phase 12's 50% filter."""
    return np.random.default_rng(12).random(n) < 0.5


def record_calls(idx, device) -> Dict[str, tuple]:
    """The rescore calls of phase 12's first batches, recorded as made:
    {label: (kernel name, args, kwargs)} for the v4 B=64 call, the first
    chunk of v4 B=256 and the v3 B=64 call under the 50% filter."""
    from ..index.plan import plan_query
    from ..index.search_exec import PrunedPlanMixin
    from ..ops import pruned as pr

    ex = PrunedPlanMixin(device)

    def search(qs, **kw):
        plans = [plan_query(idx, q, [FIELD], {}, with_prefix=True) for q in qs]
        return ex.search_topk_pruned(idx, plans, [float(N_DOCS)] * len(qs),
                                     N_DOCS, 10, **kw)

    out = {}
    for label, name, route, B, kw in (
            ("v4 B=64", "rescore_bsearch", 0, 64, {}),
            ("v4 B=256, first chunk", "rescore_bsearch", 1, 256, {}),
            ("v3 50% filter B=64", "rescore_worklist", 3, 64,
             dict(mask=half_mask(), mask_key=("pruned", "half")))):
        _, calls = capture(pr, name, lambda: search(route_batch(route, 0, B),
                                                    **kw))
        out[label] = (name, *calls[0])
    return out


def load_baseline(source: Path) -> Dict[str, Callable]:
    """Runners over the earlier `pruned_rescore.cu`, whose launchers take
    no pairs-per-block and whose worklist launcher adds into acc and df
    zeroed by the caller and leaves the tail to torch, built with the
    port's nvcc flags: {name: run(args, kw, alone)}; `alone` runs only the
    worklist pass (no zeroing, no tail)."""
    from ..ops import _build
    from ..ops import pruned as pr

    lib = _build.load_source(source, "baseline_pruned")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rescore_bsearch_launch.argtypes = [
        ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i64, i64, i64, i64, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr]
    lib.rescore_worklist_launch.argtypes = [
        ptr, ptr, ptr, i64, ptr, ptr, i64, ptr, i64, i64, i64,
        ptr, i64, i64, ptr, i64, ptr, ptr, ptr]
    bufs = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError_t {err}")

    def bsearch(args, kw, alone=False):
        p_doc, tf, flen, st, ln, w, fb, av, idf, cand = args
        B, T, NR = st.shape
        C = cand.shape[1]
        boff = kw.get("boff")
        scores = torch.empty((B, C), device=p_doc.device)
        matched = torch.empty((B, C), device=p_doc.device)
        check(lib.rescore_bsearch_launch(
            *(t.data_ptr() for t in args[:3]), p_doc.shape[0],
            *(t.data_ptr() for t in args[3:]), B, T, NR, C, kw["bs_steps"],
            boff[0].data_ptr() if boff else None,
            boff[0].shape[0] if boff else 0,
            boff[1].data_ptr() if boff else None,
            boff[2].data_ptr() if boff else None,
            scores.data_ptr(), matched.data_ptr(), stream()))
        return scores, matched

    def worklist(args, kw, alone=False):
        p_doc, tf_src, p_flen, wl_i, wl_f, n_docs, cand = args[:7]
        wl_prev = args[7] if len(args) > 7 else kw.get("wl_prev")
        fmask = args[8] if len(args) > 8 else kw.get("fmask")
        B, C = cand.shape
        T, nre = kw["T"], kw.get("nre", 0)
        if alone:
            key = (B, T, C)
            if key not in bufs:
                bufs[key] = (torch.zeros((B * T, C), device=p_doc.device),
                             torch.zeros(B * T, dtype=torch.int32,
                                         device=p_doc.device))
            acc, df = bufs[key]
        else:
            acc = torch.zeros((B * T, C), device=p_doc.device)
            df = torch.zeros(B * T, dtype=torch.int32, device=p_doc.device)
        check(lib.rescore_worklist_launch(
            p_doc.data_ptr(), tf_src.data_ptr(), p_flen.data_ptr(),
            p_doc.shape[0], wl_i.data_ptr(), wl_f.data_ptr(), wl_i.shape[1],
            cand.data_ptr(), C, T, kw["lch"],
            wl_prev.data_ptr() if nre else None, nre, kw.get("bs_steps", 0),
            fmask.data_ptr() if fmask is not None else None,
            fmask.shape[0] if fmask is not None else 0,
            acc.data_ptr(), df.data_ptr(), stream()))
        if alone:
            return None
        return pr._worklist_tail(acc, df, cand, n_docs, T)

    return {"rescore_bsearch": bsearch, "rescore_worklist": worklist}


def current_runners() -> Dict[str, Callable]:
    """The current wrappers as run(args, kw, alone); `alone` runs only the
    worklist pass (`_worklist_launch` with parts=2)."""
    from ..ops import pruned as pr

    outs = {}

    def bsearch(args, kw, alone=False):
        return pr.rescore_bsearch(*args, **kw)

    def worklist(args, kw, alone=False):
        if not alone:
            return pr.rescore_worklist(*args, **kw)
        cand = args[6]
        B, C = cand.shape
        T = kw["T"]
        key = (B, T, C)
        if key not in outs:
            dev = cand.device
            outs[key] = (torch.zeros(B * T * C + B * T, device=dev),
                         torch.empty((B, C), device=dev),
                         torch.empty((B, C), device=dev))
        full = list(args) + [None] * (9 - len(args))
        full[7] = full[7] if full[7] is not None else kw.get("wl_prev")
        full[8] = full[8] if full[8] is not None else kw.get("fmask")
        pr._worklist_launch(
            (*full[:9], kw.get("fbits")), outs[key], lch=kw["lch"], T=T,
            nre=kw.get("nre", 0), bs_steps=kw.get("bs_steps", 0), parts=2)
        return None

    return {"rescore_bsearch": bsearch, "rescore_worklist": worklist}


def time_cold(fn, flush, reps: int) -> float:
    """Device ms of fn() with the L2 cold: CUDA-graph replays of (a write
    of `flush`, five times the 50 MB L2; fn) less those of the write
    alone."""
    both = time_graph(lambda: (flush.zero_(), fn()), reps)
    alone = time_graph(flush.zero_, reps)
    return both - alone


def limit_cases(name: str, args, kw) -> Dict[str, tuple]:
    """Copies of a recorded call that show what sets the kernel's floor.
    rescore_bsearch: `empty` (every range empty: the launch, the
    descriptor loads and the sums) and `one search` (B = C = T = NR = 1:
    the launch and one chain of dependent loads). rescore_worklist:
    `padding only` (every entry empty: the zeroing, the launch of the
    grid and the tail), `no hits` (every candidate the sentinel: the
    posting stream and the filter, no lookups) and `unfiltered` (no
    filter: the posting stream and the lookups)."""
    if name == "rescore_bsearch":
        empty = list(args)
        empty[4] = torch.zeros_like(args[4])
        one = [a for a in args[:3]] + [a[:1, :1, :1].contiguous()
                                       for a in args[3:8]]
        one += [args[8][:1, :1].contiguous(), args[9][:1, :1].contiguous()]
        kw1 = dict(kw)
        if kw.get("boff") is not None:
            flat, base, shift = kw["boff"]
            kw1["boff"] = (flat, base[:1, :1, :1].contiguous(),
                           shift[:1, :1, :1].contiguous())
        return {"empty": (tuple(empty), kw), "one search": (tuple(one), kw1)}
    wl_i, cand = args[3], args[6]
    pad = list(args)
    pad[3] = wl_i.clone()
    pad[3][3] = 0
    sentinel = list(args)
    sentinel[6] = torch.full_like(cand, 2**31 - 1)
    unf = list(args[:8]) + [None]
    kw_unf = {k: v for k, v in kw.items() if k not in ("fmask", "fbits")}
    return {"padding only": (tuple(pad), kw), "no hits": (tuple(sentinel), kw),
            "unfiltered": (tuple(unf), kw_unf)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier pruned_rescore.cu to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pruned_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda
    from ..ops import pruned as pr
    from . import card_line

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    idx = build_index()
    calls = record_calls(idx, device)
    print(f"index and recorded calls: {time.perf_counter() - t0:.1f} s",
          flush=True)
    flush = torch.empty(64 << 20, device=device)
    runners = {"current": current_runners()}
    if args.baseline is not None:
        runners["baseline"] = load_baseline(args.baseline)
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    for label, (name, a, kw) in calls.items():
        res = check_kernel(name, a, kw, reps=args.reps)
        if args.baseline is not None:   # the baseline against the plain too
            bs, bm = runners["baseline"][name](a, kw)
            ps, pm = getattr(pr, f"{name}_plain")(*a, **_plain_kw(kw))
            if not torch.equal(bm, pm) or not torch.allclose(
                    bs, ps, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{label}: the baseline differs from "
                                     f"the plain version")
        print(f"{name} [{label}]: bound {res['bound_ms'] * 1e3:.2f} us "
              f"({res['bound_by']}, {res['bytes'] / 1e6:.1f} MB), sector-"
              f"level bytes of this design {res['sector_bytes'] / 1e6:.1f} MB "
              f"({bound_ms(res['sector_bytes'], 0)[0] * 1e3:.2f} us); plain "
              f"{res['plain_ms']:.4f} ms; hits {res['hits']:.0f}; max abs "
              f"err {res['max_abs_err']:.3g} [{card}]", flush=True)
        times = {}
        for who in turns:
            run = runners[who][name]
            t = dict(
                warm=time_graph(lambda: run(a, kw), args.reps),
                cold=time_cold(lambda: run(a, kw), flush, args.reps),
                alone_cold=time_cold(lambda: run(a, kw, True), flush,
                                     args.reps))
            for k, v in t.items():
                times.setdefault((who, k), []).append(v)
        for who in dict.fromkeys(turns):
            cold = min(times[(who, "cold")])
            print(f"  {who}: wrapper {min(times[(who, 'warm')]):.4f} ms "
                  f"(L2 warm), {cold:.4f} ms (L2 cold), "
                  f"{100 * res['bound_ms'] / cold:.1f}% of bound; kernel "
                  f"alone {min(times[(who, 'alone_cold')]):.4f} ms (L2 cold) "
                  f"[{card}]", flush=True)
            print(f"    turns: " + "; ".join(
                f"{k} " + ", ".join(f"{v:.4f}" for v in times[(who, k)])
                for k in ("warm", "cold", "alone_cold")), flush=True)
        if label.startswith("v4 B=256"):
            continue
        for case, (ca, ckw) in limit_cases(name, a, kw).items():
            run = runners["current"][name]
            print(f"  limit case [{case}]: wrapper "
                  f"{time_graph(lambda: run(ca, ckw), args.reps):.4f} ms "
                  f"(L2 warm), "
                  f"{time_cold(lambda: run(ca, ckw), flush, args.reps):.4f} "
                  f"ms (L2 cold) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
