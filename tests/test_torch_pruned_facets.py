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


def _with_sentinel(pd, pv, numeric):
    """The pair table as the executor uploads it: a 2**30 sentinel row."""
    return (np.concatenate([pd, [2**30]]).astype(np.int32),
            np.concatenate([pv, [0]]).astype(np.float32 if numeric
                                              else np.int32))


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
    pdx, pvx = _with_sentinel(pd, pv, numeric)
    bounds = _bounds(rng, G) if numeric else np.zeros((G, 2), np.float32)
    exp = jpr.pruned_facet_hist_multi(_j(docs), _j(rep), _j(pdx), _j(pvx),
                                      _j(bounds), G=G, numeric=numeric, M=m)
    got = fh.facet_hist_multi(_t(docs), _t(rep), _t(pdx), _t(pvx),
                              fh.row_ptr_table(_t(pd), cap), _t(bounds), G=G,
                              numeric=numeric, M=m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.sum() > 0


def test_row_ptr_table_is_lower_bound_of_every_doc():
    """row_ptr[d] = searchsorted(pair_docs, d) for every d in [0, L]: docs
    without rows, runs of several rows, rows past L and the sentinel row,
    and an empty table."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 4, 700)
    k[:3] = 0                                     # no rows at the start
    pd = np.repeat(np.arange(700, dtype=np.int32), k)
    for table, L in ((pd, 700), (pd, 650), (pd, 900),
                     (np.r_[pd, 2**30].astype(np.int32), 700),
                     (np.zeros(0, np.int32), 5), (pd, 0)):
        rp = fh.row_ptr_table(_t(table), L)
        assert rp.dtype == torch.int32 and rp.shape == (L + 1,)
        np.testing.assert_array_equal(
            rp.numpy(), np.searchsorted(table, np.arange(L + 1)))


def _hybrid_reps(rng, n_docs, cap, n=4096, pad=512):
    """The hybrid's reps: phase A's ascending run with its sentinel tail,
    a second ascending run (the probe's docs) and sentinel padding."""
    docs, rep = _rep_inputs(rng, n=n, n_docs=n_docs, cap=cap)
    vd = np.sort(rng.choice(n_docs, 600, replace=False)).astype(np.int32)
    vrep = (rng.random(600) < 0.7).astype(np.float32)
    return (np.concatenate([docs, vd, np.full(pad, cap, np.int32)]),
            np.concatenate([rep, vrep, np.zeros(pad, np.float32)]))


@pytest.mark.parametrize("order", ["shuffled", "hybrid"])
@pytest.mark.parametrize("rows", ["1", "2", "max"])
@pytest.mark.parametrize("numeric", [False, True])
def test_facet_hist_multi_row_ptr_matches_jax(numeric, rows, order):
    """M below a doc's row count truncates at M rows, as JAX's probes do;
    the order of the reps does not matter."""
    rng = np.random.default_rng(11 + 5 * numeric + len(rows) + len(order))
    n_docs, cap, G = 3000, 4096, (8 if numeric else 16)
    col = _multi_column(rng, numeric, 6, n_docs, G)
    pd, pv, m = col.pair_table(cap)
    M = m if rows == "max" else int(rows)
    assert m > 2
    if order == "shuffled":
        docs, rep = _rep_inputs(rng, n_docs=n_docs, cap=cap)
        perm = rng.permutation(len(docs))
        docs, rep = docs[perm], rep[perm]
    else:
        docs, rep = _hybrid_reps(rng, n_docs, cap)
    pdx, pvx = _with_sentinel(pd, pv, numeric)
    bounds = _bounds(rng, G) if numeric else np.zeros((G, 2), np.float32)
    exp = jpr.pruned_facet_hist_multi(_j(docs), _j(rep), _j(pdx), _j(pvx),
                                      _j(bounds), G=G, numeric=numeric, M=M)
    got = fh.facet_hist_multi(_t(docs), _t(rep), _t(pdx), _t(pvx),
                              fh.row_ptr_table(_t(pd), cap), _t(bounds), G=G,
                              numeric=numeric, M=M)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.sum() > 0


@pytest.mark.parametrize("numeric", [False, True])
def test_facet_hist_multi_counts_nothing_outside_row_ptr(numeric):
    """Kept docs outside [0, L) count nothing: negative docs, docs at or
    past L, and the table's 2**30 sentinel doc, which JAX's probes match
    against the sentinel row (value 0)."""
    pd = np.array([0, 0, 3, 5, 5, 5], np.int32)
    pv = (np.array([0, 1, 2, 0, 3, 4], np.float32) if numeric
          else np.array([0, 1, 2, 0, 3, 4], np.int32))
    pdx, pvx = _with_sentinel(pd, pv, numeric)
    G = 5
    bounds = (np.array([[0, 0], [0, 2], [1, 4], [9, 9], [-1, 10]], np.float32)
              if numeric else np.zeros((G, 2), np.float32))
    rp = fh.row_ptr_table(_t(pd), 8)
    outside = np.array([-1, 8, 9, 2**30, 2**30], np.int32)
    inside = np.array([5, 0, 3, 1], np.int32)
    for docs, want in ((outside, 0), (np.r_[inside, outside], None)):
        rep = np.ones(len(docs), np.float32)
        got = fh.facet_hist_multi(_t(docs), _t(rep), _t(pdx), _t(pvx), rp,
                                  _t(bounds), G=G, numeric=numeric, M=3)
        if want is not None:
            assert int(got.sum()) == want
        else:
            exp = jpr.pruned_facet_hist_multi(
                _j(inside), _j(np.ones(4, np.float32)), _j(pdx), _j(pvx),
                _j(bounds), G=G, numeric=numeric, M=3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    sentinel = np.array([2**30], np.int32)
    exp = jpr.pruned_facet_hist_multi(
        _j(sentinel), _j(np.ones(1, np.float32)), _j(pdx), _j(pvx),
        _j(bounds), G=G, numeric=numeric, M=3)
    assert float(np.asarray(exp).sum()) > 0   # JAX counts the sentinel row


def test_facet_bench_bound_and_sectors_on_toy_inputs():
    """facet_bound and design_sectors, counted by hand: entries 8 B each,
    bounds and counts 12 B a bucket, kept values by word and by 32-byte
    sector (8 words); multi-valued rows truncated at M, docs outside
    [0, L) without rows, row_ptr's sectors of d and d + 1."""
    from oramacore_tpu_torch.benches import facet_bench as fb

    G = 4
    base = 8 * 5 + 12 * G
    docs = torch.tensor([0, 7, 17, 9, 255], dtype=torch.int32)
    rep = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    args = (docs, rep, torch.zeros(300, dtype=torch.int32), torch.zeros((G, 2)))
    kw = dict(G=G, numeric=False)
    # kept 0, 7, 9, 255: 4 words in sectors 0, 0, 1, 31
    assert fb.facet_bound("cat", args, kw) == (base + 16, base + 3 * 32)
    assert fb.design_sectors("cat", args, kw) == base + 3 * 32
    pd = torch.tensor([0, 0, 0, 3, 8, 8, 9, 2**30], dtype=torch.int32)
    rp = fh.row_ptr_table(pd, 10)
    docs = torch.tensor([0, 3, 9, 12, 5], dtype=torch.int32)
    rep = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    args = (docs, rep, pd, torch.zeros(8, dtype=torch.int32), rp,
            torch.zeros((G, 2)))
    kw = dict(G=G, M=2, numeric=False)
    # rows 0, 1 (doc 0, cut at M = 2), 3 (doc 3), 6 (doc 9); doc 12 is
    # past L: one value sector; row_ptr at 0, 1, 3, 4, 9, 10: sectors 0, 1
    assert fb.facet_bound("mcat", args, kw) == (base + 4 * 8, base + 2 * 32)
    assert fb.design_sectors("mcat", args, kw) == base + 3 * 32


def test_facet_bench_limit_cases():
    """`stream` gathers nothing (one column word; no doc with rows) and
    `gather` runs the kept reps alone, to the same counts."""
    from oramacore_tpu_torch.benches import facet_bench as fb

    rng = np.random.default_rng(8)
    docs, rep = _rep_inputs(rng)
    col = rng.integers(0, 16, 4096).astype(np.int32)
    col[0] = 3
    args = (_t(docs), _t(rep), _t(col), _t(np.zeros((16, 2), np.float32)))
    kw = dict(G=16, numeric=False)
    cases = fb.limit_cases("cat", args, kw)
    stream = fh.facet_hist(*cases["stream"][0], **kw)
    assert int(stream[3]) == int(stream.sum()) == int((rep != 0).sum())
    assert torch.equal(fh.facet_hist(*cases["gather"][0], **kw),
                       fh.facet_hist(*args, **kw))
    col = _multi_column(rng, False, 4, 3000, 16)
    pd, pv, m = col.pair_table(4096)
    pdx, pvx = _with_sentinel(pd, pv, False)
    args = (_t(docs), _t(rep), _t(pdx), _t(pvx),
            fh.row_ptr_table(_t(pd), 4096), _t(np.zeros((16, 2), np.float32)))
    kw = dict(G=16, M=m, numeric=False)
    cases = fb.limit_cases("mcat", args, kw)
    assert int(fh.facet_hist_multi(*cases["stream"][0], **kw).sum()) == 0
    full = fh.facet_hist_multi(*args, **kw)
    assert full.sum() > 0
    assert torch.equal(fh.facet_hist_multi(*cases["gather"][0], **kw), full)


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
    # facet_hist_multi's rings share the block: fewer buckets fit
    pd = torch.tensor([0, 2**30], dtype=torch.int32)
    rp = torch.tensor([0, 1], dtype=torch.int32)
    for numeric in (False, True):
        G = fh.max_buckets(numeric, multi=True)
        assert fh.smem_bytes(G, numeric, multi=True) <= fh.SMEM_LIMIT
        assert fh.smem_bytes(G + 1, numeric, multi=True) > fh.SMEM_LIMIT
        pv = torch.zeros(2, dtype=torch.float32 if numeric else torch.int32)
        fh.facet_hist_multi(docs, rep, pd, pv, rp, torch.zeros((G, 2)), G=G,
                            M=1, numeric=numeric)
        with pytest.raises(ValueError, match="shared memory"):
            fh.facet_hist_multi(docs, rep, pd, pv, rp,
                                torch.zeros((G + 1, 2)), G=G + 1, M=1,
                                numeric=numeric)


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


def test_facet_columns_upload_once_per_key(index, monkeypatch):
    """A keyed column's device arrays (the pair table, its row_ptr made
    on the device, the bounds) are made by its first call only: the same
    fields of the same search again upload nothing and count the same,
    equal to the JAX package. Without a key every call uploads them."""
    specs = _specs()
    jp, tp = _plans(index, [["w0", "w1", "w7"]], PROPS)
    jx, tx = _executors()
    uploads = []
    real = tx._to_dev

    def spy(a):
        uploads.append(np.shape(a))
        return real(a)

    monkeypatch.setattr(tx, "_to_dev", spy)
    rounds = []
    for _ in range(2):
        rounds.append({k: tx.facet_counts_pruned(index.torch, tp[0], N_DOCS,
                                                 *specs[k]) for k in specs})
        rounds[-1]["uploads"] = len(uploads)
    assert rounds[0]["uploads"] > 0 and rounds[1]["uploads"] == rounds[0]["uploads"]
    for k, (spec, key) in specs.items():
        exp = jx.facet_counts_pruned(index.jax, jp[0], N_DOCS, spec, key)
        np.testing.assert_array_equal(rounds[0][k], np.asarray(exp), err_msg=k)
        np.testing.assert_array_equal(rounds[1][k], rounds[0][k], err_msg=k)
    (pd_dev, pv_dev, rp_dev), _, b_dev = tx._fmask_dev.get(
        (specs["mcat"][1], CAPB))
    assert rp_dev.shape == (N_DOCS + 1,) and b_dev.shape == (10, 2)
    np.testing.assert_array_equal(
        rp_dev.numpy(), np.searchsorted(pd_dev.numpy(), np.arange(N_DOCS + 1)))
    (col_dev,), _, b_dev = tx._fmask_dev.get((specs["num"][1], CAPB))
    assert col_dev.shape == (CAPB,) and b_dev.shape == (8, 2)
    before = len(uploads)
    tx.facet_counts_pruned(index.torch, tp[0], N_DOCS, specs["mnum"][0], None)
    assert len(uploads) - before == 3      # pairs, values, bounds


@pytest.mark.parametrize("kind", ["num", "mnum"])
def test_facet_ranges_change_under_one_column_key(index, kind, monkeypatch):
    """Ranges come with each search, the column with its key: a number
    field counted again under the same key with other ranges (as many, and
    fewer) counts those ranges, equal to the JAX package, and uploads only
    the new ranges; the first ranges again count as they did."""
    spec, key = _specs()[kind]
    rng = np.random.default_rng(17)
    at = 2 if kind == "num" else 3
    range_sets = [spec[at], _bounds(rng, 8), _bounds(rng, 3), spec[at]]
    jp, tp = _plans(index, [["w0", "w1", "w7"]], PROPS)
    jx, tx = _executors()
    uploads = []
    real = tx._to_dev

    def spy(a):
        uploads.append(np.shape(a))
        return real(a)

    monkeypatch.setattr(tx, "_to_dev", spy)
    got = []
    for bounds in range_sets:
        s = spec[:at] + (bounds,) + spec[at + 1:]
        exp = jx.facet_counts_pruned(index.jax, jp[0], N_DOCS, s, key)
        before = len(uploads)
        got.append(tx.facet_counts_pruned(index.torch, tp[0], N_DOCS, s, key))
        np.testing.assert_array_equal(got[-1], np.asarray(exp))
        assert got[-1].shape == (len(bounds),) and got[-1].sum() > 0
        if len(got) > 1:
            assert uploads[before:] == [np.shape(bounds)]
    assert not np.array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[3], got[0])


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
