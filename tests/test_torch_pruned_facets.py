"""The port's pruned facets against the JAX package's, on the CPU: phase A
(`pruned_match_reps`), phase B (`facet_hist` and `facet_hist_multi`,
their plain versions here, against `pruned_facet_hist` and
`pruned_facet_hist_multi`), the hybrid reps (`_vec_reps_core`,
`pruned_hybrid_match_reps`) and `facet_counts_pruned` /
`facet_match_count` through the executors.

The corpus is `test_torch_pruned_exec.py`'s (two fields, two committed
segments and a live layer, PREFIX_LEN shrunk in both packages), the
vectors a seeded IVF layout of the JAX VectorIndex carried into the
port's with `from_jax_state`. Multi-valued columns come from the JAX
package's own `filter_fields` columns and their `pair_table`.

Everything compares exactly: reps are sorted doc ids and 0/1 flags, and
counts are small integers (JAX's f32 counts are exact below 2^24, the
port's int32 ones everywhere)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oramacore_tpu.index.vector_index as jvi
import oramacore_tpu_torch.index.vector_index as tvi
from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu.index.filter_fields import NumberField, StringFilterField
from oramacore_tpu.ops import pruned as jpr
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.ops import facet_hist as fh
from oramacore_tpu_torch.ops import pruned as tpr
from oramacore_tpu_torch.ops.bm25 import round_up_pow2
from tests.test_torch_pruned_exec import (  # noqa: F401 (fixture)
    N_DOCS,
    PROPS,
    _plans,
    index,
)

LCH = 2048            # worklist chunk of the facet reps in this module
CAPB = round_up_pow2(N_DOCS, 128)
D = 16
RESCALE = (0.2, 1.0)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _executors():
    jx, tx = jexec.PrunedPlanMixin(), texec.PrunedPlanMixin("cpu")
    for ex in (jx, tx):
        ex.PRUNED_LCH = LCH
    return jx, tx


def _alive(seed=21, frac=0.95):
    return np.random.default_rng(seed).random(N_DOCS) < frac


def _fmask(mask):
    """The executors' f32[capb] mask of a bool[N_DOCS] one."""
    fm = np.zeros(CAPB, np.float32)
    fm[:N_DOCS] = mask
    return fm


QUERIES = [["w0", "w1", "w7"], ["w2", "stem3", "w9"], ["w12", "nosuchword"],
           ["w0", "w0", "w4"]]


@pytest.mark.parametrize("props", [("body",), tuple(PROPS)])
def test_facet_worklist_matches_jax(index, props):
    jp, tp = _plans(index, QUERIES, props)
    jx, tx = _executors()
    for lch in (LCH, 64):
        for jpl, tpl in zip(jp, tp):
            exp = jx._facet_worklist(jpl, lch)
            got = tx._facet_worklist(tpl, lch)
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)


REPS_CASES = {
    "thr0": dict(thr=0.0),
    "thr1": dict(thr=1.0),
    "thr2": dict(thr=2.0),
    "thr3": dict(thr=3.0),
    "exact": dict(thr=0.0, exact=True),
    "filtered": dict(thr=0.0, filtered=True),
    "filtered_thr2": dict(thr=2.0, filtered=True),
}


def _reps_both(index, plans, lch=LCH, thr=0.0, exact=False, filtered=False):
    """(JAX reps, port reps) of each plan pair."""
    jslab = jexec.PrunedPlanMixin()._get_device_slab(index.jax)
    tslab = texec.PrunedPlanMixin("cpu")._get_device_slab(index.torch)
    fm = _fmask(_alive())
    out = []
    for jpl, tpl in zip(*plans):
        wl = texec.PrunedPlanMixin("cpu")._facet_worklist(tpl, lch)
        exp = jpr.pruned_match_reps(
            jslab[0], jslab[1], jslab[2], _j(wl), jnp.float32(thr),
            _j(fm) if filtered else jnp.ones((1,), jnp.float32),
            lch=lch, cap=CAPB, exact=exact, has_filter=filtered)
        got = tpr.pruned_match_reps(
            tslab.doc, tslab.tf, tslab.exact_tf, _t(wl), thr,
            _t(fm) if filtered else None, lch=lch, cap=CAPB, exact=exact,
            has_filter=filtered)
        out.append((exp, got))
    return out


@pytest.mark.parametrize("case", list(REPS_CASES))
def test_pruned_match_reps_matches_jax(index, case):
    """Both fields: a token's two ranges hold one doc twice, which the
    (doc, token) runs must collapse."""
    plans = _plans(index, QUERIES, PROPS)
    total = 0
    for (ed, er), (gd, gr) in _reps_both(index, plans, **REPS_CASES[case]):
        assert gd.dtype == torch.int32 and gr.dtype == torch.float32
        assert gd.shape == ed.shape
        np.testing.assert_array_equal(gd.numpy(), np.asarray(ed))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(er))
        total += int(gr.sum())
    assert total > 0


def test_match_reps_count_distinct_tokens(index):
    """rep.sum() is the number of docs holding >= thr distinct tokens of
    the plan (numpy over the plan's ranges), a run ending at the array's
    last slot included."""
    plans = _plans(index, [["w0", "w1", "w7"]], PROPS)
    slab = index.torch.slab()
    tp = plans[1][0]
    per_doc = {}
    for t in range(tp.starts.shape[0]):
        docs = set()
        for r in range(tp.starts.shape[1]):
            s, n = int(tp.starts[t, r]), int(tp.lens[t, r])
            d = slab[0][s:s + n]
            docs |= set(d[slab[1][s:s + n] > 0].tolist())
        for d in docs:
            per_doc[d] = per_doc.get(d, 0) + 1
    for thr in (0.0, 2.0, 3.0):
        (_e, (gd, gr)), = _reps_both(index, plans, thr=thr)
        want = sum(1 for c in per_doc.values() if c >= max(thr, 1.0))
        assert int(gr.sum()) == want
    # every slot filled: the last run ends at the last slot
    tslab = texec.PrunedPlanMixin("cpu")._get_device_slab(index.torch)
    wl = np.array([[0], [0], [0], [64]], np.int32)
    gd, gr = tpr.pruned_match_reps(tslab.doc, tslab.tf, tslab.exact_tf,
                                   _t(wl), 0.0, lch=64, cap=CAPB, exact=False)
    d = tslab.doc[:64][tslab.tf[:64] > 0]
    assert int(gr.sum()) == len(torch.unique(d)) and gr[-1] == 1.0


# ---------------------------------------------------------------------------
# phase B
# ---------------------------------------------------------------------------

def _rep_inputs(rng, n=4096, n_docs=3000, cap=4096):
    """Sorted docs with a sentinel tail (doc == cap, rep 0), rep 0/1."""
    docs = np.sort(rng.integers(0, n_docs, n)).astype(np.int32)
    docs[-n // 4:] = cap
    rep = (rng.random(n) < 0.6).astype(np.float32)
    rep[-n // 4:] = 0.0
    docs[-n // 4 - 1] = n_docs - 1          # the last real doc, kept
    rep[-n // 4 - 1] = 1.0
    return docs, rep


def _bounds(rng, G, lo=0.0, hi=100.0):
    """G inclusive ranges [a, b] on a 0.5 grid (values hit their ends);
    neighbours overlap."""
    a = np.round(rng.uniform(lo, hi, G) * 2) / 2
    w = np.round(rng.uniform(0, (hi - lo) / 3, G) * 2) / 2
    return np.stack([a, a + w], axis=1).astype(np.float32)


def _num_values(rng, n):
    v = (np.round(rng.uniform(0, 100, n) * 2) / 2).astype(np.float32)
    v[rng.random(n) < 0.1] = np.nan
    return v


HIST_CASES = [(False, 1), (False, 64), (False, 1024), (True, 1), (True, 8),
              (True, 300)]


@pytest.mark.parametrize("numeric,G", HIST_CASES)
def test_pruned_facet_hist_matches_jax(numeric, G):
    """-1 and ids >= G count nowhere; NaN in no range; overlapping ranges
    each count."""
    rng = np.random.default_rng(G + 7 * numeric)
    docs, rep = _rep_inputs(rng)
    if numeric:
        col = _num_values(rng, 4096)
        bounds = _bounds(rng, G)
    else:
        col = rng.integers(-1, G + 3, 4096).astype(np.int32)
        bounds = np.zeros((G, 2), np.float32)
    exp = jpr.pruned_facet_hist(_j(docs), _j(rep), _j(col), _j(bounds), G=G,
                                numeric=numeric)
    got = fh.facet_hist(_t(docs), _t(rep), _t(col), _t(bounds), G=G,
                        numeric=numeric)
    assert got.dtype == torch.int32 and got.shape == (G,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.sum() > 0


def _multi_column(rng, numeric, M, n_docs, G):
    """A JAX filter column with 0..M values a doc (repeats included, which
    the pair table dedups); the last doc holds values."""
    col = NumberField() if numeric else StringFilterField()
    for d in range(n_docs):
        k = int(rng.integers(0, M + 1)) if d < n_docs - 1 else M
        if numeric:
            vals = list(_num_values(rng, k).astype(np.float64))
            if k > 1:
                vals[-1] = vals[0]                     # a repeat
        else:
            vals = [f"v{int(i)}" for i in rng.integers(0, G + 3, k)]
        col.insert(d, vals)
    col.commit()
    return col


@pytest.mark.parametrize("numeric", [False, True])
@pytest.mark.parametrize("M", [1, 8])
def test_pruned_facet_hist_multi_matches_jax(numeric, M):
    rng = np.random.default_rng(M + 3 * numeric)
    n_docs, cap, G = 3000, 4096, (8 if numeric else 16)
    col = _multi_column(rng, numeric, M, n_docs, G)
    pd, pv, m = col.pair_table(cap)
    tpd, tpv, tm = texec.pair_table(*col.slab(), cap)
    np.testing.assert_array_equal(tpd, pd)
    np.testing.assert_array_equal(tpv, pv)
    assert tm == m and 1 <= m <= M and pd[-1] == n_docs - 1
    docs, rep = _rep_inputs(rng, n_docs=n_docs, cap=cap)
    pdx = np.concatenate([pd, [2**30]]).astype(np.int32)
    pvx = np.concatenate([pv, [0]]).astype(np.float32 if numeric else np.int32)
    bounds = _bounds(rng, G) if numeric else np.zeros((G, 2), np.float32)
    exp = jpr.pruned_facet_hist_multi(_j(docs), _j(rep), _j(pdx), _j(pvx),
                                      _j(bounds), G=G, numeric=numeric, M=m)
    got = fh.facet_hist_multi(_t(docs), _t(rep), _t(pdx), _t(pvx),
                              _t(bounds), G=G, numeric=numeric, M=m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.sum() > 0


def test_facet_hist_refuses_what_shared_memory_cannot_hold():
    docs = torch.zeros(4, dtype=torch.int32)
    rep = torch.ones(4)
    G = fh.SMEM_LIMIT // 12 + 1
    with pytest.raises(ValueError, match="shared memory"):
        fh.facet_hist(docs, rep, torch.zeros(8), torch.zeros((G, 2)), G=G,
                      numeric=True)
    G = fh.SMEM_LIMIT // 4 + 1
    with pytest.raises(ValueError, match="shared memory"):
        fh.facet_hist(docs, rep, torch.zeros(8, dtype=torch.int32),
                      torch.zeros((G, 2)), G=G, numeric=False)
    with pytest.raises(TypeError):     # a numeric column of ids
        fh.facet_hist(docs, rep, torch.zeros(8, dtype=torch.int32),
                      torch.zeros((4, 2)), G=4, numeric=True)


# ---------------------------------------------------------------------------
# hybrid reps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vectors():
    """Vectors of the corpus's docs (d % 11 == 3 have none, d % 7 == 0
    two rows), laid out by the JAX VectorIndex's `_build_ivf` and carried
    into the port's."""
    rng = np.random.default_rng(3)
    jv = jvi.VectorIndex(jvi.VectorIndexConfig(dim=D))
    vecs = {}
    for d in range(N_DOCS):
        if d % 11 == 3:
            continue
        vecs[d] = rng.normal(size=(2 if d % 7 == 0 else 1, D)).astype(np.float32)
        jv.insert(d, list(vecs[d]))
    jv.commit()
    ji = jvi.VectorIndex(jvi.VectorIndexConfig(dim=D))
    ji._committed_matrix = jv._committed_matrix
    ji._committed_docs = jv._committed_docs
    ji._build_ivf()
    ti = tvi.VectorIndex.from_jax_state(
        ji._committed_matrix, ji._committed_docs, ji._ivf,
        tvi.VectorIndexConfig(dim=D), "cpu")
    return ji, ti, vecs


def _query_vec(vecs, seed):
    rng = np.random.default_rng(seed)
    d = int(rng.choice(sorted(vecs)))
    q = vecs[d][0] + 0.3 * rng.normal(size=D).astype(np.float32)
    return (q / np.linalg.norm(q)).astype(np.float32)[None, :]


def test_vec_reps_core_matches_jax(index):
    """Duplicates, sentinels, docs the full text counts, and docs whose
    full-text run failed its threshold (rep 0: the vector side counts
    them)."""
    plans = _plans(index, QUERIES[:1], PROPS)
    ((ed, er), (gd, gr)), = _reps_both(index, plans, thr=2.0)
    rng = np.random.default_rng(4)
    docs = gd.numpy()
    real = docs[docs < CAPB]
    failed = real[gr.numpy()[: len(real)] == 0]
    vd = np.concatenate([rng.choice(real, 40), rng.choice(failed, 20),
                         rng.integers(0, N_DOCS, 40),
                         np.full(28, CAPB)]).astype(np.int32)
    rng.shuffle(vd)
    exp = jpr._vec_reps_core(_j(vd), ed, er, CAPB)
    got = tpr._vec_reps_core(_t(vd), gd, gr, CAPB)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    assert 0 < got[1].sum() < len(vd)


@pytest.mark.parametrize("filtered,rescale", [(False, None), (True, RESCALE)])
def test_pruned_hybrid_match_reps_matches_jax(index, vectors, filtered,
                                              rescale):
    ji, ti, vecs = vectors
    plans = _plans(index, QUERIES[1:2], PROPS)
    ((ed, er), (gd, gr)), = _reps_both(index, plans, filtered=filtered)
    fm = _fmask(_alive())
    q = _query_vec(vecs, 5)
    jl, tl = ji.int8_device_rows(), ti.int8_device_rows()
    V = round_up_pow2(min(texec.HYBRID_INT8_CANDIDATES, ti.n_rows()), 8)
    kw = dict(V=V, nprobe=tl[-1], window=tl[-2], cap=CAPB, pad=LCH,
              has_filter=filtered, has_rescale=rescale is not None,
              rescale_lo=rescale[0] if rescale else 0.0,
              rescale_hi=rescale[1] if rescale else 1.0)
    exp = jpr.pruned_hybrid_match_reps(
        ed, er, *jl[:5], _j(q), jnp.float32(0.1),
        _j(fm) if filtered else jnp.ones((1,), jnp.float32), **kw)
    got = tpr.pruned_hybrid_match_reps(
        gd, gr, *tl[:5], _t(q), 0.1, _t(fm) if filtered else None, **kw)
    assert got[0].shape == (len(gd) + LCH,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    assert got[1][len(gd):].sum() > 0       # the probe added docs


# ---------------------------------------------------------------------------
# facet_counts_pruned / facet_match_count through the executors
# ---------------------------------------------------------------------------

def _specs():
    """One column of each kind over the corpus: {kind: (spec, key)}."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 12, N_DOCS).astype(np.int32)
    nums = _num_values(rng, N_DOCS)
    bounds = _bounds(rng, 8)
    mcat = _multi_column(rng, False, 4, N_DOCS, 10)
    mnum = _multi_column(rng, True, 3, N_DOCS, 8)
    pd, pv, m = mcat.pair_table(N_DOCS)
    npd, npv, nm = mnum.pair_table(N_DOCS)
    return {
        "cat": (("cat", ids, 10), ("facet", "cat", 1)),
        "num": (("num", nums, bounds), ("facet", "num", 1)),
        "mcat": (("mcat", pd, pv, 10, m), ("facet", "mcat", 1)),
        "mnum": (("mnum", npd, npv, bounds, nm), ("facet", "mnum", 1)),
    }


FACET_CASES = {
    "text": {},
    "thresholded": dict(thr=2.0),
    "exact": dict(exact=True),
    "masked": dict(mask=True),
    "hybrid": dict(vec=True),
    "hybrid_masked_rescaled": dict(vec=True, mask=True, rescale=RESCALE),
    "vec_only": dict(vec=True, vec_only=True),
}


@pytest.mark.parametrize("case", list(FACET_CASES))
def test_facet_counts_pruned_matches_jax(index, vectors, case):
    ji, ti, vecs = vectors
    opts = dict(FACET_CASES[case])
    jp, tp = _plans(index, [["w0", "w1", "w7"]], PROPS)
    jx, tx = _executors()
    kw = {k: opts[k] for k in ("thr", "exact") if k in opts}
    if opts.get("mask"):
        kw.update(mask=_alive(), mask_key=("alive", 1))
    jkw, tkw = dict(kw), dict(kw)
    if opts.get("vec"):
        q = _query_vec(vecs, 6)
        jkw["vec"] = (ji, q, 0.1, opts.get("rescale"))
        tkw["vec"] = (ti, q, 0.1, opts.get("rescale"))
        jkw["vec_only"] = tkw["vec_only"] = opts.get("vec_only", False)
    for kind, (spec, key) in _specs().items():
        exp = jx.facet_counts_pruned(index.jax, jp[0], N_DOCS, spec, key, **jkw)
        got = tx.facet_counts_pruned(index.torch, tp[0], N_DOCS, spec, key,
                                     **tkw)
        assert got.dtype == np.int32, kind
        np.testing.assert_array_equal(got, np.asarray(exp), err_msg=kind)
        assert got.sum() > 0, kind
    count = tx.facet_match_count(tp[0])
    assert count == jx.facet_match_count(jp[0]) and count > 0


def test_facet_reps_cache_holds_one_plan(index, monkeypatch):
    """A second field of the same search reuses the reps; another plan
    (even an equal one) or another threshold computes them again, and
    facet_match_count answers only for the plan in the slot."""
    calls = []
    real = texec.pruned_match_reps

    def spy(*a, **k):
        calls.append(k.get("exact"))
        return real(*a, **k)

    monkeypatch.setattr(texec, "pruned_match_reps", spy)
    specs = _specs()
    _, tp = _plans(index, [["w0", "w1", "w7"]] * 2, PROPS)
    _, tx = _executors()
    args = (index.torch, tp[0], N_DOCS)
    tx.facet_counts_pruned(*args, *specs["cat"])
    tx.facet_counts_pruned(*args, *specs["mnum"])
    assert len(calls) == 1
    n = tx.facet_match_count(tp[0])
    assert n > 0 and tx.facet_match_count(tp[1]) is None
    tx.facet_counts_pruned(index.torch, tp[1], N_DOCS, *specs["num"])
    assert len(calls) == 2 and tx.facet_match_count(tp[0]) is None
    assert tx.facet_match_count(tp[1]) == n
    tx.facet_counts_pruned(index.torch, tp[1], N_DOCS, *specs["num"], thr=3.0)
    assert len(calls) == 3 and tx.facet_match_count(tp[1]) < n


def test_facet_match_count_sums_in_int32():
    """Past 2^24 matched docs the count stays exact (an f32 accumulator
    of ones stops at 2^24)."""
    _, tx = _executors()
    plan = object()
    n = (1 << 24) + 3
    tx._facet_reps_slot = (None, plan, None, torch.ones(n))
    assert tx.facet_match_count(plan) == n
