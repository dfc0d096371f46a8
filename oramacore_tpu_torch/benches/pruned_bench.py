"""The pruned tier's 10M-doc text configuration, and the checks and
timings of its two rescore kernels that `chip_smoke.py` runs.

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

from typing import Dict, List, Optional

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
                      rtol: float = 1e-5) -> List[str]:
    """A device candidate set against the numpy nomination: equal outside
    near-ties at the C-th partial score (relative rtol)."""
    got = {int(d) for d in cand_row if d < cap}
    ranked = sorted(partial.items(), key=lambda kv: -kv[1])
    kth = ranked[C - 1][1] if len(ranked) >= C else 0.0
    errs = []
    for d in got ^ {d for d, _ in ranked[:C]}:
        s = partial.get(d, 0.0)
        if abs(s - kth) > rtol * max(abs(kth), 1e-30):
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


def worklist_bound(args, kw):
    """(bytes, ops) one rescore_worklist call must move and do: 8 B (doc,
    tf) per entry posting, 4 B more per kept posting for the filter mask,
    4 B of flen per candidate hit; the worklist, the candidate table and
    the (B*T, C) sums once. Ops: the ntf formula (6) per hit and the
    log2(C) compares of each kept posting's lookup."""
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
    n_bytes = (8 * n_post + (4 * n_post if fmask is not None else 0)
               + 4 * hits + 28 * wl_i.shape[1] + 4 * B * C + 4 * B * T * C
               + 4 * B * T + 8 * B * C)
    ops = 6 * hits + np.log2(max(C, 2)) * n_post
    return n_bytes, ops


def check_kernel(name: str, args, kw, reps: int = 20) -> Dict:
    """One rescore kernel against its plain version at a recorded call's
    inputs (scores within rtol 1e-5 / atol 1e-5, matched exact), then
    its time (a CUDA graph replay), the plain version's and the bound."""
    from ..ops import pruned as pr

    kernel = getattr(pr, name)
    plain = getattr(pr, f"{name}_plain")
    scores, matched = kernel(*args, **kw)
    ps, pm = plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((scores - ps).abs().max())
    if not torch.equal(matched, pm):
        raise AssertionError(f"{name}: matched differs from the plain version")
    if not torch.allclose(scores, ps, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: scores outside rtol 1e-5 / atol 1e-5 "
                             f"of the plain version (max abs err {err:.3g})")
    ms = time_graph(lambda: kernel(*args, **kw), reps)
    plain_ms = time_cuda(lambda: plain(*args, **kw), 3)
    n_bytes, ops = (bsearch_bound if name == "rescore_bsearch"
                    else worklist_bound)(args, kw)
    bound, by = bound_ms(n_bytes, ops)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
                bound_by=by, library_ms=None, bytes=n_bytes,
                hits=float((matched > 0).sum()))
