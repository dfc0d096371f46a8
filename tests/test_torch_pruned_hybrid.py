"""The port's pruned hybrid over the int8 IVF layout
(`HybridSearchTopK.search_topk_hybrid_int8_pruned`, which runs
`pruned_hybrid_topk_int8` and `pruned_hybrid_topk_int8_bs`) against the
JAX package's, route by route, on the CPU.

The corpus is `test_torch_pruned_exec.py`'s, the vectors the IVF layout
of `test_torch_pruned_facets.py` (some docs with two rows, whose probe hit
can beat the doc2row representative: the fold's scatter-max). Ids agree
outside near-ties, counts exactly. Scores: within 1e-4 on the v4 routes
(binary-search rescore; the vector side's f32 sums run in another order);
within 2e-3 on the v3 routes, where JAX's worklist rescore takes prefix-sum
differences (ROADMAP §3, accepted divergence).

Thresholded queries take their count from the verified candidates alone.
Nomination ranks docs by partial scores that tie exactly at the C-th
place on this corpus (small integer tf), and the two packages break such
ties in their own sum order (ROADMAP §3), so the thresholded routes run
with a candidate budget that covers the corpus."""

import numpy as np
import pytest

from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.ops import pruned as tpr
from tests.test_torch_pruned_exec import (  # noqa: F401 (fixture)
    N_DOCS,
    PROPS,
    V3_RTOL,
    _assert_topk_close,
    _mask,
    _plans,
    _queries,
    index,
)
from tests.test_torch_pruned_facets import CAPB, vectors  # noqa: F401

BS_RTOL = 1e-4
RESCALE = (0.1, 1.0)

# route -> (executor knobs, search kwargs, properties, B, rescore)
ROUTES = {
    "v4": ({}, {}, ("body",), 6, "bs"),
    "v4_chunked": (dict(PRUNED_BS_BATCH=2, PRUNED_BS_SORT_BUDGET=1), {},
                   ("body",), 5, "bs"),
    "v4_sliced": (dict(PRUNED_BS_ACCUM=False, PRUNED_BS_HP=64), {},
                  ("body",), 4, "bs"),
    "v4_thr_omc_rescale": (dict(PRUNED_BS_C=4096),
                           dict(thresholds=[0, 2, 1, 0], omc=True,
                                rescale=RESCALE), ("body",), 4, "bs"),
    "v4_candidates_64": ({}, dict(candidates=64), ("body",), 4, "bs"),
    "v3": (dict(PRUNED_BS=False), {}, ("body",), 6, "wl"),
    "v3_filtered": ({}, dict(mask="large"), ("body",), 6, "wl"),
    "v3_exact": ({}, dict(exact=True), ("body",), 6, "wl"),
    "v3_multi_field": ({}, {}, tuple(PROPS), 6, "wl"),
    "v3_thr_omc": (dict(PRUNED_CANDIDATES=4096),
                   dict(thresholds=[1, 0, 2, 0], omc=True), tuple(PROPS), 4,
                   "wl"),
    "cand_given": ({}, dict(mask="small"), tuple(PROPS), 5, "wl"),
}


def _query_vectors(vecs, seed, B):
    rng = np.random.default_rng(seed)
    docs = rng.choice(sorted(vecs), B)
    q = np.stack([vecs[d][-1] for d in docs])
    q = q + 0.3 * rng.normal(size=q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32), rng.choice([0.0, 0.1, 0.3], B).tolist()


def _run(index, vectors, route, monkeypatch):
    knobs, kw, props, B, rescore = ROUTES[route]
    kw = dict(kw)
    ji, ti, vecs = vectors
    if kw.get("mask") == "large":
        kw["mask"], kw["mask_key"] = _mask(4, 0.5), ("m", 1)
    elif kw.get("mask") == "small":
        m = np.zeros(N_DOCS, bool)
        m[np.random.default_rng(5).choice(N_DOCS, 300, replace=False)] = True
        kw["mask"], kw["mask_key"] = m, ("m", 2)
    if kw.pop("omc", False):
        kw["omc"] = np.random.default_rng(6).uniform(0.5, 2, N_DOCS).astype(
            np.float32)
        kw["omc_key"] = ("omc", 1)
    qs = _queries(20 + len(route), B)
    qs[-1] = ["nosuchword"]            # a vector-only query
    jp, tp = _plans(index, qs, props)
    q, sims = _query_vectors(vecs, len(route), B)
    jx, tx = jexec.HybridSearchTopK(), texec.HybridSearchTopK("cpu")
    for ex in (jx, tx):
        for name, v in knobs.items():
            setattr(ex, name, v)
    calls = {"bs": 0, "wl": 0}
    real = {"bs": tpr.rescore_bsearch, "wl": tpr.rescore_worklist}

    def spy(name):
        def wrapped(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return wrapped

    monkeypatch.setattr(tpr, "rescore_bsearch", spy("bs"))
    monkeypatch.setattr(tpr, "rescore_worklist", spy("wl"))
    args = ([float(N_DOCS)] * B, N_DOCS, 10)
    exp = jx.search_topk_hybrid_int8_pruned(
        index.jax, jp, *args, ji.int8_device_rows(), ji.int8_doc2row(CAPB),
        q, sims, **kw)
    got = tx.search_topk_hybrid_int8_pruned(
        index.torch, tp, *args, ti.int8_device_rows(), ti.int8_doc2row(CAPB),
        q, sims, **kw)
    assert calls[rescore] > 0
    assert calls["bs" if rescore == "wl" else "wl"] == 0
    return exp, got


@pytest.mark.parametrize("route", list(ROUTES))
def test_search_topk_hybrid_int8_pruned_matches_jax(index, vectors, route,
                                                     monkeypatch):
    (ev, ei, ec), (tv, ti, tc) = _run(index, vectors, route, monkeypatch)
    B = ROUTES[route][3]
    assert tv.shape == (B, 10) and ti.shape == (B, 10) and tc.shape == (B,)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    _assert_topk_close(tv, ti, ev, ei,
                       BS_RTOL if ROUTES[route][4] == "bs" else V3_RTOL)
    np.testing.assert_array_equal(tc, ec)
    assert np.isfinite(tv[:, 0]).sum() >= B - 1
    assert np.isfinite(tv[-1, 0])      # the vector-only query matched


def test_v4_chunks_equal_one_dispatch(index, vectors):
    """A v4 batch dispatched in chunks of 2 returns what one dispatch
    returns."""
    _, ti, vecs = vectors
    qs = _queries(31, 5)
    _, tp = _plans(index, qs)
    q, sims = _query_vectors(vecs, 31, 5)
    out = []
    for knobs in ({}, dict(PRUNED_BS_BATCH=2, PRUNED_BS_SORT_BUDGET=1)):
        tx = texec.HybridSearchTopK("cpu")
        for name, v in knobs.items():
            setattr(tx, name, v)
        out.append(tx.search_topk_hybrid_int8_pruned(
            index.torch, tp, [float(N_DOCS)] * 5, N_DOCS, 10,
            ti.int8_device_rows(), ti.int8_doc2row(CAPB), q, sims))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_candidate_vec_is_the_int8_row_dot(vectors):
    """Each candidate's vector score is scale * dot(int8 row, bf16(q)),
    0 for docs without a row and for empty slots."""
    import torch

    from oramacore_tpu_torch.ops.vector import _bf16

    _, ti, vecs = vectors
    mat, scales = ti.int8_device_rows()[:2]
    d2r = ti.int8_doc2row(CAPB)
    q, _ = _query_vectors(vecs, 1, 2)
    cand = torch.tensor([[0, 3, 7, 14, CAPB], [1, 2, 5, 6, CAPB]],
                        dtype=torch.int32)
    got = tpr._candidate_vec(cand, d2r, mat, scales, torch.from_numpy(q), CAPB)
    qb = _bf16(torch.from_numpy(q)).double()
    for b in range(2):
        for c in range(5):
            d = int(cand[b, c])
            r = int(d2r[min(d, CAPB)])
            want = 0.0 if r < 0 or d >= CAPB else float(
                (mat[r].double() @ qb[b]) * scales[r].double())
            assert abs(float(got[b, c]) - want) <= 1e-6 * max(1.0, abs(want))
    assert got[0, 1] == 0.0 and got[0, 4] == 0.0   # doc 3 has no vector
