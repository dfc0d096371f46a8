"""The port's pruned tier against the JAX package's, end to end on the
CPU: one seeded two-field corpus (two committed segments and a live
layer) indexed into a StringIndex of each package, with PREFIX_LEN
shrunk in both string_index modules so heavy terms get impact-prefix side
blocks. Plans (`with_prefix=True`), the mixin's host arrays and bucket
tables must be equal; `search_topk_pruned` is compared route by route.

Tolerances. The v4 routes (binary-search rescore) compute each
candidate's sum from the same gathered postings in both packages: scores
within rtol 1e-5, ids equal outside near-ties, counts exact. The v3
routes (worklist rescore) differ by the JAX function's prefix-sum
differences: JAX takes each candidate's sum as pref[ub] - pref[lb] over
a chunk's f32 cumsum, which loses low bits to cancellation, while the
port adds the posting's ntf directly. There the port's returned scores
must equal the float64 reference scorer within rtol 1e-5, and JAX's
within V3_RTOL of the port's (ids equal outside near-ties at V3_RTOL);
matched-token counts and counts stay exact."""

import numpy as np
import pytest
import torch

import oramacore_tpu.index.string_index as jsi
import oramacore_tpu_torch.index.string_index as tsi
from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.index.plan import plan_query
from tests.test_torch_search_exec import Indexes

PREFIX = 256           # PREFIX_LEN in both packages for this module
N_SEG1, N_SEG2, N_LIVE = 1800, 1200, 150
N_DOCS = N_SEG1 + N_SEG2 + N_LIVE
VOCAB = [f"w{i}" for i in range(60)]
PROPS = ["title", "body"]
TOL_WORDS = ["alpha", "alphb", "alphas"]
# queries of the tolerance route: a fuzzy token expands to few terms
TOL_QUERIES = [["alpha"], ["alphb", "alphas"], ["alpha", "alpha"], ["alphas"]]
RTOL = 1e-5
# JAX's worklist rescore against exact sums: measured up to ~8e-4
# relative on CPU at 3k docs with 4096-posting chunks (prefix-sum
# cancellation); 2e-3 bounds it
V3_RTOL = 2e-3


def _words(rng, n):
    p = 1.0 / (np.arange(len(VOCAB)) + 3.0)
    return list(rng.choice(VOCAB, n, p=p / p.sum()))


def _index_doc(idx, rng, d):
    title = _words(rng, int(rng.integers(2, 6)))
    if rng.random() < 0.3:  # a small family of words one edit apart
        title.append(str(rng.choice(TOL_WORDS)))
    idx.index_text(d, "title", [(w, []) for w in title])
    body = _words(rng, int(rng.integers(4, 13)))
    idx.index_text(d, "body", [(w, ["stem" + w[1:]]) for w in body])


def _build(module):
    rng = np.random.default_rng(0)
    idx = module.StringIndex()
    for d in range(N_SEG1):
        _index_doc(idx, rng, d)
    idx.commit()
    for d in range(N_SEG1, N_SEG1 + N_SEG2):
        _index_doc(idx, rng, d)
    idx.commit()
    for d in range(N_SEG1 + N_SEG2, N_DOCS):
        _index_doc(idx, rng, d)
    idx.slab_split()
    assert len(idx._committed["body"]) == 2
    assert ("body", "w0") in idx._slab_prefix_ranges
    assert idx._slab_live_arrays is not None
    return idx


@pytest.fixture(scope="module")
def index():
    """PREFIX_LEN stays shrunk while the module's tests plan and search
    (the planner reads it too)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORAMACORE_NATIVE_LIVE", "0")
        mp.setattr(jsi, "PREFIX_LEN", PREFIX)
        mp.setattr(tsi, "PREFIX_LEN", PREFIX)
        yield Indexes(_build(jsi), _build(tsi))


def _queries(seed, B, pool=None):
    rng = np.random.default_rng(seed)
    pool = pool or VOCAB[:25] + ["stem1", "stem4", "nosuchword"]
    qs = [list(rng.choice(pool, int(rng.integers(1, 4)))) for _ in range(B)]
    qs[0] = ["w0", "w1", "w7"]          # heavy terms: prefix blocks
    if B > 1:
        qs[1] = ["w2", "w2", "w9"]      # a repeated token counts twice
    return qs


def _plans(index, qs, props=("body",), **kw):
    props = list(props)
    return ([index.jax.plan_query(q, props, {"title": 2.0}, with_prefix=True,
                                  **kw) for q in qs],
            [plan_query(index.torch, q, props, {"title": 2.0},
                        with_prefix=True, **kw) for q in qs])


# ---------------------------------------------------------------------------
# host side: plans, host arrays, bucket tables
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(tokens=["w0", "w1", "w7"], properties=["body"], boost={}),
    dict(tokens=["w0", "stem3", "w30"], properties=PROPS,
         boost={"title": 2.0, "body": 0.5}),
    dict(tokens=["w2", "nosuchword"], properties=PROPS, boost={},
         field_params={"title": (1.3, 0.75), "body": (0.7, 0.5)},
         token_weights=[0.5, 2.0]),
    dict(tokens=["w12", "w1"], properties=PROPS, boost={}, tolerance=1),
    dict(tokens=["w3"], properties=["title"], boost={}, impact_cap=100),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_with_prefix_plan_matches_jax(index, case):
    kw = PLAN_CASES[case]
    exp = index.jax.plan_query(with_prefix=True, **kw)
    got = index.torch.plan_query(with_prefix=True, **kw)
    assert type(got) is tsi.QueryPlan
    for name in ("starts", "lens", "weights", "field_b", "avg_flen",
                 "pre_starts", "pre_lens", "pre_weights", "pre_field_b",
                 "pre_avg", "range_field", "range_span"):
        e, g = getattr(exp, name), getattr(got, name)
        assert g.dtype == e.dtype, name
        np.testing.assert_array_equal(g, e, err_msg=name)
    assert got.spans == exp.spans
    assert (got.n_tokens, got.max_range_len) == (exp.n_tokens, exp.max_range_len)
    assert got.pre_lens.max() <= max(PREFIX, 1) or kw.get("tolerance")
    # the dense branch leaves the pruned fields unset
    dense = index.torch.plan_query(**kw)
    assert dense.pre_starts is None and dense.spans is None


@pytest.mark.parametrize("props", [("body",), tuple(PROPS)])
@pytest.mark.parametrize("tolerance", [None, 1])
def test_pruned_host_inputs_match_jax(index, props, tolerance):
    qs = _queries(1, 6)
    jp, tp = _plans(index, qs, props, tolerance=tolerance)
    thr = [0, 1, 0, 2, 0, 0]
    exp = jexec.PrunedPlanMixin._pruned_host_inputs(jp, [N_DOCS] * 6, thr)
    got = texec.PrunedPlanMixin._pruned_host_inputs(tp, [N_DOCS] * 6, thr)
    assert len(got) == len(exp) == 13
    for i, (g, e) in enumerate(zip(got, exp)):
        if isinstance(e, np.ndarray):
            assert g.dtype == e.dtype, i
            np.testing.assert_array_equal(g, e, err_msg=str(i))
        else:
            assert g == e, i
    nre = got[11]
    assert (nre > 0) == (len(props) > 1 or tolerance is not None)
    e_bs, g_bs = (cls._pruned_bs_inputs(p) for cls, p in
                  ((jexec.PrunedPlanMixin, jp), (texec.PrunedPlanMixin, tp)))
    for g, e in zip(g_bs, e_bs):
        np.testing.assert_array_equal(g, e)


def test_pruned_bs_boff_tables_match_jax(index):
    qs = _queries(2, 8)
    jp, tp = _plans(index, qs)
    capb = texec.round_up_pow2(N_DOCS, 128)
    jx, tx = jexec.PrunedPlanMixin(), texec.PrunedPlanMixin("cpu")
    for step in range(2):  # the second call reuses and extends the cache
        qs2 = qs[step * 4:(step + 1) * 4]
        jp2, tp2 = _plans(index, qs2)
        rng_i, _, steps = texec.PrunedPlanMixin._pruned_bs_inputs(tp2)
        j_rng_i, _, j_steps = jexec.PrunedPlanMixin._pruned_bs_inputs(jp2)
        np.testing.assert_array_equal(rng_i, j_rng_i)
        e = jx._pruned_bs_boff(index.jax, j_rng_i, capb, j_steps)
        g = tx._pruned_bs_boff(index.torch, rng_i, capb, steps)
        assert isinstance(g[0], torch.Tensor) and g[0].dtype == torch.int32
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(e[0]))
        np.testing.assert_array_equal(g[1], e[1])
        np.testing.assert_array_equal(g[2], e[2])
        assert g[3] == e[3]
    assert len(tx._boff_flat["spans"]) > 4


def test_pruned_bs_chunk_matches_jax(index):
    jp, tp = _plans(index, _queries(3, 4))
    for S in (1, 2, 64):
        jx, tx = jexec.PrunedPlanMixin(), texec.PrunedPlanMixin("cpu")
        for ex in (jx, tx):
            ex.PRUNED_BS_BATCH = S
            ex.PRUNED_BS_SORT_BUDGET = 4 * PREFIX * 3 * 4
        assert tx._pruned_bs_chunk(tp) == jx._pruned_bs_chunk(jp)


def test_estimate_match_count_is_the_jax_one():
    from oramacore_tpu.ops.pruned import estimate_match_count as jest
    from oramacore_tpu_torch.ops.pruned import estimate_match_count as test

    for nd, dfs in ((1000, [10, 500]), (1e7, [3e5, 7e4, 3500]), (0, [5]),
                    (100, [200])):
        assert test(nd, dfs) == jest(nd, dfs)


# ---------------------------------------------------------------------------
# search_topk_pruned, route by route
# ---------------------------------------------------------------------------

def _assert_topk_close(vals, ids, evals, eids, rtol):
    """Finite values within rtol (-inf where the other has -inf); ids
    equal except at a near-tie (within rtol of a neighbour's value, or
    the last position)."""
    vals, evals = np.asarray(vals), np.asarray(evals)
    ids, eids = np.asarray(ids), np.asarray(eids)
    fin = np.isfinite(evals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], evals[fin], rtol=rtol, atol=1e-6)
    k = vals.shape[1]
    for b in range(vals.shape[0]):
        for i in np.nonzero((ids[b] != eids[b]) & fin[b])[0]:
            tied = i == k - 1 or any(
                abs(evals[b, i] - evals[b, j]) <= rtol * abs(evals[b, i])
                for j in (i - 1, i + 1) if 0 <= j < k and fin[b, j])
            assert tied, (b, i, ids[b], eids[b], evals[b])


def _executors(**knobs):
    jx, tx = jexec.PrunedPlanMixin(), texec.PrunedPlanMixin("cpu")
    for ex in (jx, tx):
        for name, v in knobs.items():
            setattr(ex, name, v)
    return jx, tx


def _mask(seed, frac):
    return np.random.default_rng(seed).random(N_DOCS) < frac


def _no_boff(self, index, rng_i, capb, bs_steps):
    return None, None, None, bs_steps


# route -> (executor knobs, search kwargs, properties, plan kwargs, B,
#           expected rescore: "bs" or "wl")
ROUTES = {
    "v4": ({}, {}, ("body",), {}, 6, "bs"),
    "v4_no_boff": ({}, {}, ("body",), {}, 6, "bs"),
    "v4_chunked": (dict(PRUNED_BS_BATCH=2, PRUNED_BS_SORT_BUDGET=1), {},
                   ("body",), {}, 5, "bs"),
    "v4_sliced": (dict(PRUNED_BS_ACCUM=False, PRUNED_BS_HP=64), {},
                  ("body",), {}, 4, "bs"),
    "v4_omc_thr": ({}, dict(thresholds=[0, 2, 1, 0]), ("body",), {}, 4, "bs"),
    "v3": (dict(PRUNED_BS=False), {}, ("body",), {}, 6, "wl"),
    "v3_filtered": ({}, dict(mask="large"), ("body",), {}, 6, "wl"),
    "v3_exact": ({}, dict(exact=True), ("body",), {}, 6, "wl"),
    "v3_multi_field": ({}, {}, tuple(PROPS), {}, 6, "wl"),
    "v3_tolerance": ({}, {}, tuple(PROPS), dict(tolerance=1), 4, "wl"),
    "v3_omc_thr": ({}, dict(thresholds=[1, 0, 2, 0]), tuple(PROPS), {}, 4,
                   "wl"),
    "cand_given": ({}, dict(mask="small"), tuple(PROPS), {}, 5, "wl"),
    "exact_counts_sliced": (dict(PRUNED_COUNTS_SLICE=2),
                            dict(exact_counts=True), tuple(PROPS), {}, 5,
                            "wl"),
    "exact_counts_v4": ({}, dict(exact_counts=True), ("body",), {}, 3, "bs"),
    "exact_counts_filtered": ({}, dict(exact_counts=True, mask="large"),
                              ("body",), {}, 3, "wl"),
}


def _run_route(index, route, monkeypatch):
    from oramacore_tpu_torch.ops import pruned as tpr

    knobs, kw, props, plan_kw, B, rescore = ROUTES[route]
    kw = dict(kw)
    if route == "v4_no_boff":
        monkeypatch.setattr(jexec.PrunedPlanMixin, "_pruned_bs_boff", _no_boff)
        monkeypatch.setattr(texec.PrunedPlanMixin, "_pruned_bs_boff", _no_boff)
    if kw.get("mask") == "large":
        kw["mask"], kw["mask_key"] = _mask(4, 0.5), ("m", 1)
    elif kw.get("mask") == "small":
        m = np.zeros(N_DOCS, bool)
        m[np.random.default_rng(5).choice(N_DOCS, 300, replace=False)] = True
        kw["mask"], kw["mask_key"] = m, ("m", 2)
    if "omc" in route:
        kw["omc"] = np.random.default_rng(6).uniform(0.5, 2, N_DOCS).astype(np.float32)
        kw["omc_key"] = ("omc", 1)
    qs = TOL_QUERIES if "tolerance" in plan_kw else _queries(10 + len(route), B)
    jp, tp = _plans(index, qs, props, **plan_kw)
    jx, tx = _executors(**knobs)
    calls = {"bs": 0, "wl": 0}
    real_bs, real_wl = tpr.rescore_bsearch, tpr.rescore_worklist

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tpr, "rescore_bsearch", spy("bs", real_bs))
    monkeypatch.setattr(tpr, "rescore_worklist", spy("wl", real_wl))
    args = ([float(N_DOCS)] * B, N_DOCS, 10)
    exp = jx.search_topk_pruned(index.jax, jp, *args, **kw)
    got = tx.search_topk_pruned(index.torch, tp, *args, **kw)
    assert calls[rescore] > 0 and calls["bs" if rescore == "wl" else "wl"] == 0
    return qs, props, plan_kw, kw, exp, got


@pytest.mark.parametrize("route", list(ROUTES))
def test_search_topk_pruned_matches_jax(index, route, monkeypatch):
    qs, props, plan_kw, kw, exp, got = _run_route(index, route, monkeypatch)
    (ev, ei, ec), (tv, ti, tc) = exp, got
    B = len(qs)
    assert tv.shape == (B, 10) and ti.shape == (B, 10) and tc.shape == (B,)
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    assert np.isfinite(tv[:, 0]).sum() >= B - 1
    rescore = ROUTES[route][5]
    _assert_topk_close(tv, ti, ev, ei, RTOL if rescore == "bs" else V3_RTOL)
    np.testing.assert_array_equal(tc, ec)
    # every returned score is the doc's exact score (float64 reference)
    if "thresholds" in kw or "omc" in kw:
        return
    for b, q in enumerate(qs):
        ref = texec.host_bm25_reference(
            index.torch, q, list(props), {"title": 2.0}, float(N_DOCS),
            exact=kw.get("exact", False), tolerance=plan_kw.get("tolerance"),
            doc_mask=kw.get("mask"))
        fin = np.isfinite(tv[b])
        np.testing.assert_allclose(
            tv[b][fin], [ref[int(d)] for d in ti[b][fin]], rtol=RTOL)
        if route in ("cand_given",) or "exact_counts" in route:
            assert tc[b] == len(ref), (b, tc[b], len(ref))
        if route == "cand_given":  # the filtered set is the candidate list
            top = sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
            np.testing.assert_allclose(tv[b][fin], [s for _, s in top],
                                       rtol=RTOL)


def test_exact_counts_with_thresholds_match_jax(index):
    qs = _queries(30, 6)
    jp, tp = _plans(index, qs, tuple(PROPS))
    thr = [0, 2, 1, 3, 0, 2]
    jx, tx = _executors(PRUNED_COUNTS_SLICE=4)
    args = ([float(N_DOCS)] * 6, N_DOCS, 10)
    _, _, ec = jx.search_topk_pruned(index.jax, jp, *args, thresholds=thr,
                                     exact_counts=True)
    _, _, tc = tx.search_topk_pruned(index.torch, tp, *args, thresholds=thr,
                                     exact_counts=True)
    np.testing.assert_array_equal(tc, ec)
    assert tc.min() >= 0 and tc.max() > 0


def test_candidate_budget_over_the_corpus_is_exact(index):
    """C >= corpus: every matching doc is a candidate, so the v4 pages
    equal the dense reference's top-10 and the lower-bound counts are
    exact."""
    qs = _queries(40, 4)
    _, tp = _plans(index, qs)
    tx = texec.PrunedPlanMixin("cpu")
    tx.PRUNED_BS_C = tx.PRUNED_CANDIDATES = 4096
    vals, ids, _ = tx.search_topk_pruned(index.torch, tp, [float(N_DOCS)] * 4,
                                         N_DOCS, 10)
    for b, q in enumerate(qs):
        ref = texec.host_bm25_reference(index.torch, q, ["body"],
                                        {"title": 2.0}, float(N_DOCS))
        top = sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
        np.testing.assert_allclose(vals[b][:len(top)], [s for _, s in top],
                                   rtol=RTOL)


def test_hybrid_executor_derives_from_the_pruned_mixin():
    assert issubclass(texec.HybridSearchTopK, texec.PrunedPlanMixin)
    assert issubclass(texec.PrunedPlanMixin, texec.StringSearchTopK)
