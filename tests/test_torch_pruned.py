"""oramacore_tpu_torch.ops.pruned against oramacore_tpu.ops.pruned on the
same numpy inputs (CPU; the rescore wrappers run their plain versions).

Inputs come from the JAX tests' synthetic slab (`tests/test_pruned.py`'s
`build_corpus`: doc-sorted per-term ranges, impact-prefix side blocks,
MAX_RANGE_LEN zero padding). Tolerances:
- nomination: candidate sets equal outside near-ties at the C-th partial
  score (relative 1e-5; the segmented sums are cumsums, whose rounding
  differs between XLA's scan and torch's), and equal outright when the
  budget covers the corpus;
- `rescore_bsearch`: scores within rtol 1e-5 / atol 1e-6 of JAX (the same
  gathered postings, summed in order), matched exact;
- `rescore_worklist`: scores within rtol 1e-5 / atol 1e-6 of an exact
  float64 rescore, and within V3_RTOL of JAX, whose prefix-sum
  differences lose low bits to cancellation; matched exact;
- counts exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oramacore_tpu.ops import pruned as jpr
from oramacore_tpu_torch.ops import pruned as tpr
from tests.test_pruned import build_corpus
from tests.test_torch_cuda import _boff

RTOL = 1e-5
V3_RTOL = 2e-3
N_DOCS = 2500
N_TERMS = 40
LCH = 1024


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def corpus():
    return build_corpus(n_docs=N_DOCS, n_terms=N_TERMS, seed=3, prefix_len=128)


def _slab(corpus):
    return tuple(corpus[k] for k in ("p_doc", "p_tf", "p_etf", "p_flen"))


def _queries(seed, B, T):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(N_TERMS, int(rng.integers(1, T + 1)), replace=False))
            for _ in range(B)]


def _pre_inputs(corpus, queries, T, NPR=1, avg=30.0):
    """(pre_starts, pre_lens, pre_w, pre_fb, pre_av, idf): each token's
    prefix range (its side block, or the whole range), cut into NPR
    pieces."""
    df, pre = corpus["df"], corpus["pre"]
    B = len(queries)
    st = np.zeros((B, T, NPR), np.int32)
    ln = np.zeros((B, T, NPR), np.int32)
    rng = np.random.default_rng(len(queries) * 7 + NPR)
    w = rng.uniform(0.5, 2.0, (B, T, NPR)).astype(np.float32)
    fb = np.full((B, T, NPR), 0.75, np.float32)
    av = np.full((B, T, NPR), avg, np.float32)
    idf = np.zeros((B, T), np.float32)
    for b, q in enumerate(queries):
        for t, term in enumerate(q):
            s, n = pre[int(term)]
            cuts = np.linspace(0, n, NPR + 1).astype(int)
            for r in range(NPR):
                st[b, t, r] = s + cuts[r]
                ln[b, t, r] = cuts[r + 1] - cuts[r]
            d = float(df[int(term)])
            idf[b, t] = np.log1p((N_DOCS - d + 0.5) / (d + 0.5))
    return st, ln, w, fb, av, idf


def _partial_scores(corpus, st, ln, w, fb, av, idf, fmask=None, exact=False):
    """Per query {doc: phase-1 partial score} in float64."""
    p_doc, p_tf, p_etf, p_flen = _slab(corpus)
    tf_src = p_etf if exact else p_tf
    out = []
    for b in range(st.shape[0]):
        part = {}
        for t in range(st.shape[1]):
            acc = {}
            for r in range(st.shape[2]):
                s, n = int(st[b, t, r]), int(ln[b, t, r])
                for p in range(s, s + n):
                    tf = float(tf_src[p])
                    d = int(p_doc[p])
                    if tf <= 0 or (fmask is not None and fmask[d] <= 0):
                        continue
                    den = (1 - float(fb[b, t, r])) + float(fb[b, t, r]) * \
                        float(p_flen[p]) / float(av[b, t, r])
                    acc[d] = acc.get(d, 0.0) + float(w[b, t, r]) * tf / den
            for d, a in acc.items():
                part[d] = part.get(d, 0.0) + float(idf[b, t]) * 2.2 * a / (1.2 + a)
        out.append(part)
    return out


def _assert_same_candidates(got, exp, partials, C, cap):
    """Candidate rows equal outside near-ties at the C-th partial score."""
    for b in range(got.shape[0]):
        g, e = set(got[b].tolist()) - {cap}, set(exp[b].tolist()) - {cap}
        ranked = sorted(partials[b].values(), reverse=True)
        kth = ranked[C - 1] if len(ranked) >= C else 0.0
        for d in g ^ e:
            s = partials[b].get(d, 0.0)
            assert abs(s - kth) <= RTOL * kth, (b, d, s, kth)
        np.testing.assert_array_equal(np.sort(got[b]), got[b])


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 7, 64, 100])
def test_lower_bound_is_searchsorted(C):
    rng = np.random.default_rng(C)
    sv = np.sort(rng.integers(0, 50, (3, C))).astype(np.int32)
    q = rng.integers(-5, 60, (3, 40)).astype(np.int32)
    exp = np.asarray(jpr._lower_bound(_j(sv), _j(q)))
    got = tpr._lower_bound(_t(sv), _t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


def test_seg_totals_sorted_matches_jax():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 30, (4, 200)), axis=1).astype(np.int32)
    vals = rng.uniform(0, 3, (4, 200)).astype(np.float32)
    vals[:, ::5] = 0.0
    ee, et = (np.asarray(a) for a in jpr._seg_totals_sorted(_j(keys), _j(vals)))
    ge, gt = tpr._seg_totals_sorted(_t(keys), _t(vals))
    np.testing.assert_array_equal(ge.numpy(), ee)
    np.testing.assert_allclose(gt.numpy()[ee], et[ee], rtol=RTOL, atol=1e-6)


def test_estimate_match_count():
    assert tpr.estimate_match_count(1000, [100, 100]) == \
        jpr.estimate_match_count(1000, [100, 100]) == 190


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

# (T, NPR, filtered, exact, C): NPR == 1 with WRUN <= 8, NPR > 1
# (segmented token sums), WRUN > 8 (segmented doc sums), a filter, exact
# tf, and budgets above and below the pool
NOM_CASES = {
    "npr1": (3, 1, False, False, 64),
    "npr2": (3, 2, False, False, 64),
    "wrun_over_8": (5, 2, False, False, 64),
    "filtered": (3, 1, True, False, 64),
    "exact_tf": (3, 2, False, True, 32),
    "budget_over_corpus": (3, 2, False, False, 4096),
}


@pytest.mark.parametrize("case", list(NOM_CASES))
def test_prefix_candidates_match_jax(corpus, case):
    T, NPR, filtered, exact, C = NOM_CASES[case]
    qs = _queries(11 + T + NPR, 6, T)
    qs[0] = list(range(T))                      # the heaviest terms
    st, ln, w, fb, av, idf = _pre_inputs(corpus, qs, T, NPR)
    lp = 8
    while lp < max(int(ln.max()), 8):
        lp *= 2
    p_doc, p_tf, p_etf, p_flen = _slab(corpus)
    tf_src = p_etf if exact else p_tf
    fmask = None
    if filtered:
        fmask = (np.random.default_rng(2).random(N_DOCS) < 0.5).astype(np.float32)
    cap = N_DOCS
    exp = np.asarray(jpr._prefix_candidates(
        _j(p_doc), _j(tf_src), _j(p_flen), _j(st), _j(ln), _j(w), _j(fb),
        _j(av), _j(idf), None if fmask is None else _j(fmask),
        lp=lp, cap=cap, C=C))
    got = tpr._prefix_candidates(
        _t(p_doc), _t(tf_src), _t(p_flen), _t(st), _t(ln), _t(w), _t(fb),
        _t(av), _t(idf), None if fmask is None else _t(fmask),
        lp=lp, cap=cap, C=C)
    assert got.dtype == torch.int32 and tuple(got.shape) == exp.shape
    got = got.numpy()
    if C >= N_DOCS:
        np.testing.assert_array_equal(got, exp)
    else:
        partials = _partial_scores(corpus, st, ln, w, fb, av, idf, fmask, exact)
        _assert_same_candidates(got, exp, partials, C, cap)
        _assert_same_candidates(exp, got, partials, C, cap)
        if fmask is not None:
            assert all(fmask[d] > 0 for d in got.ravel() if d < cap)
    assert (got < cap).sum() > 0


@pytest.mark.parametrize("hp", [8, 64])
def test_sliced_candidates_match_jax(corpus, hp):
    qs = _queries(5, 4, 3)
    st, ln, *_ = _pre_inputs(corpus, qs, 3, 2)
    p_doc = corpus["p_doc"]
    exp = np.asarray(jpr._sliced_candidates(_j(p_doc), _j(st), _j(ln), hp=hp,
                                            cap=N_DOCS))
    got = tpr._sliced_candidates(_t(p_doc), _t(st), _t(ln), hp=hp, cap=N_DOCS)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("fn", ["prefix", "sliced"])
def test_nomination_end_of_slab_clamp(fn):
    """A prefix range that ends the (unpadded) slab: the slice clamps to
    P - lp, and the range's postings sit at [shift, shift + len)."""
    rng = np.random.default_rng(9)
    P, lp = 300, 64
    p_doc = np.sort(rng.integers(0, 500, P)).astype(np.int32)
    p_tf = rng.integers(1, 4, P).astype(np.float32)
    p_flen = rng.uniform(5, 50, P).astype(np.float32)
    st = np.array([[[P - 20], [100]]], np.int32)     # (1, 2, 1)
    ln = np.array([[[20], [40]]], np.int32)
    if fn == "sliced":
        exp = jpr._sliced_candidates(_j(p_doc), _j(st), _j(ln), hp=lp, cap=500)
        got = tpr._sliced_candidates(_t(p_doc), _t(st), _t(ln), hp=lp, cap=500)
    else:
        f = np.ones((1, 2, 1), np.float32)
        idf = np.ones((1, 2), np.float32)
        exp = jpr._prefix_candidates(
            _j(p_doc), _j(p_tf), _j(p_flen), _j(st), _j(ln), _j(f),
            _j(f * 0.75), _j(f * 27.5), _j(idf), lp=lp, cap=500, C=128)
        got = tpr._prefix_candidates(
            _t(p_doc), _t(p_tf), _t(p_flen), _t(st), _t(ln), _t(f),
            _t(f * 0.75), _t(f * 27.5), _t(idf), lp=lp, cap=500, C=128)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(exp))
    expect = set(p_doc[P - 20:].tolist()) | set(p_doc[100:140].tolist())
    assert set(got.ravel().tolist()) - {500} == expect


# ---------------------------------------------------------------------------
# phase 2: rescore_bsearch
# ---------------------------------------------------------------------------

def _bs_inputs(corpus, queries, T, NR=1, seed=0):
    """Unsplit doc-sorted ranges (a term's range cut into NR doc-sorted
    pieces stands in for NR segments), exact host idf, and candidates
    (random docs, each query's padding at cap)."""
    df, tstart = corpus["df"], corpus["tstart"]
    B = len(queries)
    rng = np.random.default_rng(seed)
    st = np.zeros((B, T, NR), np.int32)
    ln = np.zeros((B, T, NR), np.int32)
    w = rng.uniform(0.5, 2.0, (B, T, NR)).astype(np.float32)
    fb = rng.uniform(0.3, 0.9, (B, T, NR)).astype(np.float32)
    av = rng.uniform(10, 40, (B, T, NR)).astype(np.float32)
    idf = np.zeros((B, T), np.float32)
    for b, q in enumerate(queries):
        for t, term in enumerate(q):
            s, n = int(tstart[term]), int(df[term])
            cuts = np.linspace(0, n, NR + 1).astype(int)
            st[b, t] = s + cuts[:-1]
            ln[b, t] = np.diff(cuts)
            idf[b, t] = np.log1p((N_DOCS - n + 0.5) / (n + 0.5))
    C = 256
    cand = np.full((B, C), N_DOCS, np.int32)
    for b in range(B):
        c = np.sort(rng.choice(N_DOCS, C - 10 * b, replace=False))
        cand[b, :len(c)] = c
    return st, ln, w, fb, av, idf, cand


@pytest.mark.parametrize("NR", [1, 3])
@pytest.mark.parametrize("with_boff", [False, True])
def test_rescore_bsearch_matches_jax(corpus, NR, with_boff):
    qs = _queries(20 + NR, 5, 3)
    qs[0] = [0, 1, 2]
    st, ln, w, fb, av, idf, cand = _bs_inputs(corpus, qs, 3, NR)
    ln[1, :, 0] = 0                          # empty ranges
    p_doc, p_tf, _, p_flen = _slab(corpus)
    max_len = int(ln.max())
    steps = 4
    while (1 << steps) < max_len + 1:
        steps += 4
    capb = 4096
    boff = None
    if with_boff:
        flat, base, shift, steps = _boff(corpus, st, ln, capb)
        boff = (flat, base, shift)
    es, em = (np.asarray(a) for a in jpr._rescore_bsearch(
        _j(p_doc), _j(p_tf), _j(p_flen), _j(st), _j(ln), _j(w), _j(fb),
        _j(av), _j(idf), _j(cand), bs_steps=steps,
        boff=None if boff is None else tuple(_j(a) for a in boff), cap=capb))
    before = dict(tpr.LAUNCHES)
    gs, gm = tpr.rescore_bsearch(
        _t(p_doc), _t(p_tf), _t(p_flen), _t(st), _t(ln), _t(w), _t(fb),
        _t(av), _t(idf), _t(cand), bs_steps=steps,
        boff=None if boff is None else tuple(_t(a) for a in boff))
    assert tpr.LAUNCHES == before           # the plain version: no launch
    np.testing.assert_array_equal(gm.numpy(), em)
    np.testing.assert_allclose(gs.numpy(), es, rtol=RTOL, atol=1e-6)
    assert (em > 0).sum() > 50 and (gs.numpy()[cand == N_DOCS] == 0).all()


def test_rescore_bsearch_checks_its_inputs(corpus):
    st, ln, w, fb, av, idf, cand = _bs_inputs(corpus, [[0, 1]], 2)
    p_doc, p_tf, _, p_flen = (_t(a) for a in _slab(corpus))
    args = [p_doc, p_tf, p_flen, _t(st), _t(ln), _t(w), _t(fb), _t(av),
            _t(idf), _t(cand)]
    with pytest.raises(TypeError):
        tpr.rescore_bsearch(*args[:9], args[9].long(), bs_steps=8)
    with pytest.raises(ValueError):
        tpr.rescore_bsearch(*args[:8], args[8][:, :1], args[9], bs_steps=8)
    with pytest.raises(ValueError):
        tpr.rescore_bsearch(*args, bs_steps=0)


# ---------------------------------------------------------------------------
# phase 2: rescore_worklist
# ---------------------------------------------------------------------------

def _worklist(corpus, queries, T, two_fields=False, lch=LCH, seed=0):
    """(wl_i, wl_f, wl_prev, nre, bs_steps) as _pruned_host_inputs packs
    them. With two_fields, token t's term q[t] is field A and term
    q[t] + 1 field B: B's entries carry A's span as an earlier span."""
    df, tstart = corpus["df"], corpus["tstart"]
    rng = np.random.default_rng(seed)
    wl, earlier_of = [], []
    max_span = 0
    for b, q in enumerate(queries):
        for t, term in enumerate(q):
            spans = [(int(tstart[term]), int(df[term]))]
            if two_fields:
                spans.append((int(tstart[term + 1]), int(df[term + 1])))
            for si, (s0, n) in enumerate(spans):
                w, fb, av = rng.uniform(0.5, 2), rng.uniform(0.3, 0.9), 30.0
                earlier = spans[:si]
                max_span = max([max_span] + [n_ for _, n_ in earlier])
                for off in range(0, n, lch):
                    wl.append((b, t, s0 + off, min(lch, n - off), w, fb, av))
                    earlier_of.append(earlier)
    W = max(128, -(-len(wl) // 128) * 128)
    wl_i = np.zeros((4, W), np.int32)
    wl_f = np.zeros((3, W), np.float32)
    wl_f[2] = 1.0
    for j, (b, t, s0, n, w, fb, av) in enumerate(wl):
        wl_i[:, j] = (b, t, s0, n)
        wl_f[:, j] = (w, fb, av)
    if not two_fields:
        return wl_i, wl_f, None, 0, 0
    wl_prev = np.zeros((2, W, 1), np.int32)
    for j, earlier in enumerate(earlier_of):
        for e, (s0, n) in enumerate(earlier):
            wl_prev[:, j, e] = (s0, n)
    steps = 4
    while (1 << steps) < max_span + 1:
        steps += 4
    return wl_i, wl_f, wl_prev, 1, steps


def _exact_worklist_scores(corpus, wl_i, wl_f, wl_prev, cand, T, fmask,
                           exact):
    """float64 oracle: direct per-candidate sums, union df."""
    p_doc, p_tf, p_etf, p_flen = _slab(corpus)
    tf_src = p_etf if exact else p_tf
    B, C = cand.shape
    acc = np.zeros((B, T, C))
    seen = [[set() for _ in range(T)] for _ in range(B)]
    pos_of = [{int(d): i for i, d in enumerate(cand[b]) if d < N_DOCS}
              for b in range(B)]
    for j in range(wl_i.shape[1]):
        b, t, s0, n = (int(x) for x in wl_i[:, j])
        w, fb, av = (float(x) for x in wl_f[:, j])
        for p in range(s0, s0 + n):
            tf, d = float(tf_src[p]), int(p_doc[p])
            if tf <= 0 or (fmask is not None and fmask[d] <= 0):
                continue
            seen[b][t].add(d)
            c = pos_of[b].get(d)
            if c is not None:
                acc[b, t, c] += w * tf / ((1 - fb) + fb * float(p_flen[p]) / av)
    df = np.array([[max(len(s), 1) for s in row] for row in seen], np.float64)
    idf = np.log1p((N_DOCS - df + 0.5) / (df + 0.5))
    sat = np.where(acc > 0, idf[:, :, None] * 2.2 * acc / (1.2 + acc), 0.0)
    return sat.sum(1), (acc > 0).sum(1)


# (two_fields, filter, exact)
WL_CASES = {
    "plain": (False, None, False),
    "fmask": (False, "half", False),
    "exact": (False, None, True),
    "nre": (True, None, False),
    "nre_fmask_exact": (True, "half", True),
    "filter_selects_nothing": (False, "none", False),
}


@pytest.mark.parametrize("case", list(WL_CASES))
def test_rescore_worklist_matches_jax(corpus, case):
    two_fields, filt, exact = WL_CASES[case]
    T = 3
    qs = _queries(30, 5, T)
    qs[0] = [0, 2, 4]                       # heavy terms: several chunks
    if two_fields:                          # term + 1 is field B's term
        qs = [[min(t, N_TERMS - 2) for t in q] for q in qs]
    wl_i, wl_f, wl_prev, nre, steps = _worklist(corpus, qs, T, two_fields)
    _, _, _, _, _, _, cand = _bs_inputs(corpus, qs, T)
    fmask = None
    if filt == "half":
        fmask = (np.random.default_rng(4).random(N_DOCS) < 0.5).astype(np.float32)
    elif filt == "none":
        fmask = np.zeros(N_DOCS, np.float32)
    p_doc, p_tf, p_etf, p_flen = _slab(corpus)
    tf_src = p_etf if exact else p_tf
    nd = np.full(len(qs), float(N_DOCS), np.float32)
    es, em = (np.asarray(a) for a in jpr._rescore_worklist(
        _j(p_doc), _j(tf_src), _j(p_flen), _j(wl_i), _j(wl_f), _j(nd),
        _j(cand), None if wl_prev is None else _j(wl_prev),
        None if fmask is None else _j(fmask),
        lch=LCH, C=cand.shape[1], T=T, nre=nre, bs_steps=steps))
    gs, gm = tpr.rescore_worklist(
        _t(p_doc), _t(tf_src), _t(p_flen), _t(wl_i), _t(wl_f), _t(nd),
        _t(cand), None if wl_prev is None else _t(wl_prev),
        None if fmask is None else _t(fmask),
        lch=LCH, T=T, nre=nre, bs_steps=steps)
    gs, gm = gs.numpy(), gm.numpy()
    xs, xm = _exact_worklist_scores(corpus, wl_i, wl_f, wl_prev, cand, T,
                                    fmask, exact)
    np.testing.assert_array_equal(gm, xm)
    np.testing.assert_allclose(gs, xs, rtol=RTOL, atol=1e-6)
    # JAX's prefix-sum difference over a dropped posting (ntf 0: outside
    # the filter, or exact tf 0) need not cancel to 0, so such a
    # candidate can come out matched once more, with a score of the
    # cancellation's size. Elsewhere matched is equal.
    odd = gm != em
    assert (em[odd] == gm[odd] + 1).all(), (gm[odd], em[odd])
    assert (np.abs(es - gs)[odd] < 1e-3).all(), (gs[odd], es[odd])
    np.testing.assert_allclose(gs[~odd], es[~odd], rtol=V3_RTOL, atol=1e-6)
    if filt == "none":
        assert not gm.any() and not gs.any()
    else:
        assert (gm > 0).sum() > 50


def test_rescore_worklist_repeated_candidates_take_the_same_sum(corpus):
    """A candidate id held in several slots (as JAX's prefix-sum
    differences give every such slot the doc's sum)."""
    qs = [[0, 1]]
    wl_i, wl_f, *_ = _worklist(corpus, qs, 2)
    _, _, _, _, _, _, cand = _bs_inputs(corpus, qs, 2)
    cand = np.sort(np.concatenate([cand[:, :100], cand[:, 50:150]], axis=1))
    nd = np.full(1, float(N_DOCS), np.float32)
    p_doc, p_tf, _, p_flen = _slab(corpus)
    es, em = (np.asarray(a) for a in jpr._rescore_worklist(
        _j(p_doc), _j(p_tf), _j(p_flen), _j(wl_i), _j(wl_f), _j(nd),
        _j(cand), lch=LCH, C=cand.shape[1], T=2))
    gs, gm = tpr.rescore_worklist(
        _t(p_doc), _t(p_tf), _t(p_flen), _t(wl_i), _t(wl_f), _t(nd),
        _t(cand), lch=LCH, T=2)
    np.testing.assert_array_equal(gm.numpy(), em)
    np.testing.assert_allclose(gs.numpy(), es, rtol=V3_RTOL, atol=1e-6)
    assert (em[0, 50:100] > 0).any()


# ---------------------------------------------------------------------------
# exact counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_pruned_exact_counts_match_jax(corpus, filtered, exact):
    T = 3
    qs = _queries(40, 6, T)
    qs[0] = [0, 1, 2]
    wl_i, *_ = _worklist(corpus, qs, T, two_fields=True)
    thr = np.array([0, 1, 2, 3, 0, 2], np.float32)
    fmask = (np.random.default_rng(5).random(N_DOCS) < 0.5).astype(np.float32)
    p_doc, p_tf, p_etf, _ = _slab(corpus)
    kw = dict(lch=LCH, cap=N_DOCS, T=T, exact=exact, has_filter=filtered)
    exp = np.asarray(jpr.pruned_exact_counts(
        _j(p_doc), _j(p_tf), _j(p_etf), _j(wl_i), _j(thr),
        _j(fmask if filtered else np.ones(1, np.float32)), **kw))
    got = tpr.pruned_exact_counts(
        _t(p_doc), _t(p_tf), _t(p_etf), _t(wl_i), _t(thr),
        _t(fmask) if filtered else None, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    assert exp[0] > 100


# ---------------------------------------------------------------------------
# the fused entry points
# ---------------------------------------------------------------------------

def test_pruned_fulltext_topk_bs_cand_given_matches_jax(corpus):
    """v4 with caller-given candidates and OMC: the tail (threshold, OMC,
    -inf fill, lax.top_k's tie order) on the same rescore."""
    qs = [[0, 3, 5], [1, 2], [7]]
    st, ln, w, fb, av, idf, cand = _bs_inputs(corpus, qs, 3)
    p_doc, p_tf, _, p_flen = _slab(corpus)
    thr = np.array([1, 2, 0], np.float32)
    omc = np.random.default_rng(6).uniform(0.5, 2, N_DOCS).astype(np.float32)
    rng_i, rng_f = np.stack([st, ln]), np.stack([w, fb, av])
    kw = dict(hp=8, cap=N_DOCS, k=16, bs_steps=12, has_omc=True,
              cand_given=True)
    ev, ei, ec = (np.asarray(a) for a in jpr.pruned_fulltext_topk_bs(
        _j(p_doc), _j(p_tf), _j(p_flen), _j(st), _j(ln), _j(rng_i),
        _j(rng_f), _j(idf), _j(thr), _j(omc), _j(cand), **kw))
    gv, gi, gc = tpr.pruned_fulltext_topk_bs(
        _t(p_doc), _t(p_tf), _t(p_flen), _t(st), _t(ln), _t(rng_i),
        _t(rng_f), _t(idf), _t(thr), _t(omc), _t(cand), **kw)
    np.testing.assert_array_equal(gc.numpy(), ec)
    np.testing.assert_allclose(gv.numpy(), ev, rtol=RTOL, atol=1e-6)
    fin = np.isfinite(ev)
    np.testing.assert_array_equal(gi.numpy()[fin], ei[fin])


# ---------------------------------------------------------------------------
# the launch shapes, the filter bitmap and the bounds of the rescore kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lch", [1, 128, 2045, 2046, 4096, 32768])
def test_worklist_tiles_cover_lch_from_any_offset(lch):
    """Enough tiles of TILE_POSTINGS for lch postings read from the
    16-byte boundary below the start, and no more."""
    tiles = tpr.worklist_tiles(lch)
    need = max((h + lch + 3) // 4 for h in range(4))   # vectors, worst offset
    assert tiles * (tpr.TILE_POSTINGS // 4) >= need
    assert (tiles - 1) * (tpr.TILE_POSTINGS // 4) < need


@pytest.mark.parametrize("lch", [128, 8192, 32768])
def test_worklist_blocks_walk_every_tile(lch):
    """Block g of an entry walks tiles g, g + G, ...: G blocks cover the
    most tiles an entry has, about TILES_PER_BLOCK each."""
    G, tiles = tpr.worklist_blocks(lch), tpr.worklist_tiles(lch)
    walked = sorted(t for g in range(G) for t in range(g, tiles, G))
    assert walked == list(range(tiles))
    assert (G - 1) * tpr.TILES_PER_BLOCK < tiles <= G * tpr.TILES_PER_BLOCK


@pytest.mark.parametrize("T, NR", [(1, 1), (3, 1), (3, 2), (5, 3), (16, 16),
                                   (20, 16), (256, 1)])
def test_bsearch_pairs_per_block(T, NR):
    """One (token, range) search a thread: the most pairs whose searches
    fit 256 threads, else one pair."""
    ppb = tpr.bsearch_pairs_per_block(T, NR)
    tn = T * NR
    if tn > tpr.KERNEL_THREADS:
        assert ppb == 1
    else:
        assert ppb * tn <= tpr.KERNEL_THREADS < (ppb + 1) * tn


@pytest.mark.parametrize("L", [1, 31, 32, 33, 1000, 10_485_760 // 64])
def test_pack_mask_bits_matches_numpy(L):
    """Bit d % 32 of word d // 32 is fmask[d] > 0: numpy's little-endian
    packbits read as int32 words."""
    rng = np.random.default_rng(L)
    fmask = np.where(rng.random(L) < 0.5, rng.uniform(0.1, 2, L), 0.0)
    fmask[rng.random(L) < 0.05] = -1.0                # not > 0: dropped
    fmask = fmask.astype(np.float32)
    bits = np.packbits(fmask > 0, bitorder="little")
    bits = np.concatenate([bits, np.zeros(-len(bits) % 4, np.uint8)])
    exp = bits.view("<u4").astype(np.int64)
    exp = np.where(exp >= 2**31, exp - 2**32, exp).astype(np.int32)
    got = tpr.pack_mask_bits(_t(fmask))
    assert got.dtype == torch.int32 and got.shape[0] == -(-L // 32)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_rescore_worklist_takes_the_bitmap_beside_the_mask(corpus):
    """On the CPU the plain version reads the f32 mask and the bitmap
    changes nothing; a bitmap of the wrong length, or without the mask,
    is refused."""
    qs = _queries(30, 4, 3)
    wl_i, wl_f, *_ = _worklist(corpus, qs, 3)
    _, _, _, _, _, _, cand = _bs_inputs(corpus, qs, 3)
    fmask = (np.random.default_rng(4).random(N_DOCS) < 0.5).astype(np.float32)
    p_doc, p_tf, _, p_flen = _slab(corpus)
    args = [_t(p_doc), _t(p_tf), _t(p_flen), _t(wl_i), _t(wl_f),
            _t(np.full(len(qs), float(N_DOCS), np.float32)), _t(cand), None,
            _t(fmask)]
    fbits = tpr.pack_mask_bits(_t(fmask))
    a = tpr.rescore_worklist(*args, lch=LCH, T=3)
    b = tpr.rescore_worklist(*args, lch=LCH, T=3, fbits=fbits)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tpr.rescore_worklist(*args, lch=LCH, T=3, fbits=fbits[:-1])
    with pytest.raises(ValueError):
        tpr.rescore_worklist(*args[:8], None, lch=LCH, T=3, fbits=fbits)


def _tiny_call():
    """8 postings of docs 1, 3, ..., 15 (tf 1, flen 10); one query of one
    token whose range is the slab; candidates 5 (a hit) and 6."""
    p_doc = torch.arange(1, 16, 2, dtype=torch.int32)
    ones = torch.ones(8)
    f = torch.ones((1, 1, 1))
    bs_args = (p_doc, ones, ones * 10, torch.zeros((1, 1, 1), dtype=torch.int32),
               torch.full((1, 1, 1), 8, dtype=torch.int32), f, f * 0.75,
               f * 10, torch.ones((1, 1)), torch.tensor([[5, 6]], dtype=torch.int32))
    wl_i = torch.tensor([[0, 0], [0, 0], [0, 0], [8, 0]], dtype=torch.int32)
    wl_f = torch.tensor([[1.0, 0.0], [0.75, 0.0], [10.0, 1.0]])
    wl_args = (p_doc, ones, ones * 10, wl_i, wl_f, torch.tensor([100.0]),
               bs_args[9])
    return bs_args, wl_args


def test_rescore_bounds_count_bytes_by_hand():
    """bsearch_bound: 2 searches x (4 rounds of 4 B + the final doc's 4 B)
    + 8 B of tf and flen for the one hit + candidates 8 + descriptors 20 +
    idf 4 + outputs 16 = 96 B, 8 ops a search. worklist_bound: 8 postings
    x 8 B + flen of the hit 4 + 2 entries x 28 + candidates 8 + sums 8 +
    df 4 + outputs 16 = 160 B, 6 ops per hit and log2(C) = 1 per posting;
    a filter adds the bitmap words the docs touch: docs 1-15 one word (4
    B), docs 10, 30, ..., 150 (no hit: 156 B) five. The sector counts of
    the redesign: bsearch 2 windows of one sector + 2 sectors of the hit
    + 48 B once = 176 B; worklist 2 x 1 sector of postings + 1 of flen +
    56 + 8 + 3 x 12 + 16 = 212 B, + 2 mask sectors (docs 1-15 as f32:
    bytes 4-60) or 1 bitmap sector."""
    from oramacore_tpu_torch.benches import pruned_bench as pb

    bs_args, wl_args = _tiny_call()
    assert pb.bsearch_bound(bs_args, dict(bs_steps=4)) == (96.0, 16.0)
    assert pb.bsearch_sectors(bs_args, dict(bs_steps=4)) == 176.0
    kw = dict(lch=8, T=1)
    assert pb.worklist_bound(wl_args, kw) == (160.0, 14.0)
    assert pb.worklist_sectors(wl_args, kw) == 212.0
    fm = torch.ones(16)
    assert pb.worklist_bound(wl_args + (None, fm), kw)[0] == 164.0
    spread = (wl_args[0] * 10,) + wl_args[1:]
    assert pb.worklist_bound(spread + (None, torch.ones(160)), kw)[0] == 176.0
    assert pb.worklist_sectors(wl_args + (None, fm), kw) == 276.0
    assert pb.worklist_sectors(wl_args + (None, fm), dict(
        kw, fbits=tpr.pack_mask_bits(fm))) == 244.0


@pytest.mark.parametrize("got, extra, edge, wrong", [
    ({1, 2, 3}, (), (), set()),
    ({1, 2, 4}, (), (), set()),             # docs 3 and 4 tie at the C-th
    ({1, 3}, (), (), {2}),                  # a nominated doc missed
    ({1, 2, 3, 5}, (), (), {5}),            # neither nominated nor extra
    ({1, 2, 3, 5}, (5,), (), set()),        # a probe hit
    ({1, 2, 3}, (5,), (), {5}),             # a probe hit missed
    ({1, 2, 3}, (5,), {5}, set()),          # ... at the probe's edge
    ({1, 2, 3, 7}, (), {7}, set()),
    ({1, 3}, (), {2}, {2}),                 # the edge excuses no nomination
])
def test_nomination_errors_with_extra_docs(got, extra, edge, wrong):
    """nomination_errors: the device set equals the top-C partial scores
    united with `extra`, outside ties at the C-th score and the `edge`
    docs; docs >= cap are sentinels."""
    from oramacore_tpu_torch.benches import pruned_bench as pb

    partial = {1: 5.0, 2: 4.0, 3: 3.0, 4: 3.0, 5: 1.0}
    errs = pb.nomination_errors(sorted(got) + [100, 100], partial, 3, 100,
                                extra=extra, edge=edge)
    assert {int(e.split()[1]) for e in errs} == wrong, errs
