"""The port's fused sort-by and group-by searches against the JAX
package's, on the same numpy inputs (CPU; the kernel wrappers run their
plain versions here).

Tolerances: scores rtol 1e-5 (per-doc sums run in another order than the
JAX package's one-hot matmul / scatter); page docs, valid flags and match
counts exact, except the executor-level group pages, which compare ids
outside near-ties as the top-k tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu.ops import bm25 as jbm25
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.index.plan import plan_query
from oramacore_tpu_torch.ops import bm25 as tbm25
from oramacore_tpu_torch.ops.vector import top_k_by_key
from tests.test_torch_bm25 import _t, assert_topk_agrees, make_case
from tests.test_torch_search_exec import N_DOCS, PROPS, _masks, _queries, index  # noqa: F401

RTOL = 1e-5


def _sort_column(rng, n):
    """Repeated integer values in [-2, 2], mostly +0.0 or -0.0, and 10%
    NaN (no field)."""
    v = rng.integers(-2, 3, n).astype(np.float32)
    zero = rng.random(n) < 0.6
    v[zero] = np.where(rng.random(n) < 0.5, 0.0, -0.0)[zero]
    v[rng.random(n) < 0.10] = np.nan
    return v


def _packed_args(c, has_mask, has_omc, use_thr):
    B = c["starts"].shape[0]
    idesc = np.stack([c["starts"], c["lens"]])
    fdesc = np.stack([c["weights"], c["field_b"], c["avg"]])
    scalars = np.stack([c["n_docs"],
                        c["thr"] if use_thr else np.zeros(B, np.float32)])
    mask = c["mask"] if has_mask else np.zeros((1, 1), bool)
    omc = c["omc"] if has_omc else np.ones(1, np.float32)
    jargs = [jnp.asarray(a) for a in (*c["slab"], idesc, fdesc, scalars,
                                      mask, omc)]
    targs = [_t(a) for a in (*c["slab"], idesc, fdesc, scalars)] + [
        _t(mask) if has_mask else None, _t(omc) if has_omc else None,
    ]
    return jargs, targs


def test_top_k_by_key_is_lax_top_k():
    """IEEE total order (+0.0 above -0.0) and lower index first on ties,
    including the -3e38 sentinel and infinities."""
    import jax

    rng = np.random.default_rng(0)
    x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, tbm25.NEG_F32, np.inf,
                             -np.inf], np.float32), (3, 3000))
    x[2] = 0.0
    for k in (1, 16, 700):
        ev, ei = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k_by_key(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ei))
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(ev).view(np.int32))


@pytest.mark.parametrize(
    "desc,has_mask,has_omc,use_thr,k",
    [
        (True, False, False, False, 512),
        (False, False, False, False, 512),
        (True, True, True, True, 64),
        (False, True, False, True, 1024),  # pages longer than the matches
        (False, False, True, False, 16),
    ],
)
def test_bm25_search_sorted_packed_matches_jax(desc, has_mask, has_omc,
                                               use_thr, k):
    c = make_case(11)
    svals = _sort_column(np.random.default_rng(12), c["cap"])
    jargs, targs = _packed_args(c, has_mask, has_omc, use_thr)
    kw = dict(lr=c["lr"], exact=False, cap=c["cap"], k=k, has_mask=has_mask,
              has_omc=has_omc, desc=desc)
    exp = jbm25.bm25_search_sorted_packed(*jargs, jnp.asarray(svals), **kw)
    got = tbm25.bm25_search_sorted_packed(*targs, _t(svals), **kw)
    exp = [np.asarray(a) for a in exp]
    got = [a.numpy() for a in got]
    docs1, vals1, sc1, docs2, ok2, sc2, counts = got
    assert docs1.dtype == docs2.dtype == np.int32 and ok2.dtype == bool
    for i in (0, 3, 4, 6):  # docs1, docs2, valid2, counts
        np.testing.assert_array_equal(got[i], exp[i])
    np.testing.assert_array_equal(vals1.view(np.int32), exp[1].view(np.int32))
    np.testing.assert_allclose(sc1, exp[2], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sc2, exp[5], rtol=RTOL, atol=1e-6)
    # the case exercises ties, signed zeros, fieldless docs and padding
    real = vals1 > tbm25.NEG_F32 / 2
    assert real.sum() > 0 and ok2.sum() > 0 and counts.min() > 0
    assert len(np.unique(vals1[real])) < real.sum()
    if k == 512:  # +0.0 and -0.0 keys both inside the page
        zeros = vals1[real & (vals1 == 0)]
        assert np.signbit(zeros).any() and not np.signbit(zeros).all()


def _tied_case(seed, cap=2048, B=4, per_range=600):
    """Two tokens, one range each, every doc at most once per range, tf in
    {1, 2} and flen in {10, 20}: scores take a few values, so ties are
    exact in both packages and the doc-ascending rule decides them."""
    rng = np.random.default_rng(seed)
    n_ranges = 2 * B
    doc = np.concatenate([rng.permutation(cap)[:per_range]
                          for _ in range(n_ranges)]).astype(np.int32)
    n = doc.shape[0]
    tf = rng.integers(1, 3, n).astype(np.float32)
    flen = rng.choice(np.array([10.0, 20.0], np.float32), n)
    lr = 1024  # trailing zero pad of lr: no window reads past the end
    slab = tuple(np.concatenate([a, np.zeros(lr, a.dtype)])
                 for a in (doc, tf, tf, flen))
    starts = (np.arange(n_ranges) * per_range).reshape(B, 2, 1).astype(np.int32)
    lens = np.full((B, 2, 1), per_range, np.int32)
    lens[-1] = 40  # a query with few matches: part-empty group pages
    c = dict(
        slab=slab, lr=lr, cap=cap, starts=starts, lens=lens,
        weights=np.ones((B, 2, 1), np.float32),
        field_b=np.full((B, 2, 1), 0.75, np.float32),
        avg=np.full((B, 2, 1), 15.0, np.float32),
        n_docs=np.full(B, float(cap), np.float32),
        mask=rng.random((B, cap)) < 0.8,
        omc=rng.choice(np.array([0.5, 1.0, 2.0], np.float32), cap),
        thr=np.array([0, 1, 2, 0], np.float32)[:B],
    )
    return c


@pytest.mark.parametrize(
    "G,has_mask,has_omc,use_thr",
    [
        (8, False, False, False),    # the JAX scan branch (G <= 16)
        (8, True, True, True),
        (64, False, False, False),   # the JAX 3-key sort branch
        (64, True, True, True),
    ],
)
def test_bm25_search_grouped_packed_matches_jax(G, has_mask, has_omc,
                                                use_thr):
    c = _tied_case(20 + G)
    R, k = 8, 16
    gid = np.random.default_rng(G).integers(-1, G, c["cap"]).astype(np.int32)
    jargs, targs = _packed_args(c, has_mask, has_omc, use_thr)
    kw = dict(lr=c["lr"], exact=False, cap=c["cap"], k=k, R=R, G=G,
              has_mask=has_mask, has_omc=has_omc)
    exp = [np.asarray(a) for a in jbm25.bm25_search_grouped_packed(
        *jargs, jnp.asarray(gid), **kw)]
    got = [a.numpy() for a in tbm25.bm25_search_grouped_packed(
        *targs, _t(gid), **kw)]
    vals, idx, counts, gvals, gdocs = got
    assert gvals.shape == gdocs.shape == (4, G, R)
    assert idx.dtype == gdocs.dtype == np.int32
    assert_topk_agrees(vals, idx, exp[0], exp[1])
    np.testing.assert_array_equal(counts, exp[2])
    fin = np.isfinite(exp[3])
    np.testing.assert_array_equal(np.isfinite(gvals), fin)
    assert (gvals[~fin] == -np.inf).all()
    np.testing.assert_allclose(gvals[fin], exp[3][fin], rtol=RTOL)
    np.testing.assert_array_equal(gdocs[fin], exp[4][fin])
    # ties inside a page exist, and some pages are cut at R
    page_ties = (np.diff(np.where(fin, gvals, 0), axis=2) == 0) & fin[..., 1:]
    assert page_ties.any() and fin[..., -1].any() and not fin.all()
    # no doc without a group, and every doc in its own group's page
    assert (gid[gdocs[fin]] >= 0).all()
    assert (gid[gdocs] == np.arange(G)[None, :, None])[fin].all()


# ---------------------------------------------------------------------------
# executors, on the seeded index of tests/test_torch_search_exec.py
# ---------------------------------------------------------------------------

def _sort_inputs(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 10, N_DOCS).astype(np.float64)
    present = rng.random(N_DOCS) > 0.1
    return vals, present


def _sorted_plans(index, qs):
    """Each package's plans on its own index: (JAX plans, port plans)."""
    return (
        [index.jax.plan_query(q, PROPS, {"title": 2.0}, use_champions=False)
         for q in qs],
        [plan_query(index.torch, q, PROPS, {"title": 2.0}, use_champions=False)
         for q in qs],
    )


@pytest.mark.parametrize(
    "cls,desc,filtered",
    [
        ("StringSearchTopK", True, False),
        ("StringSearchTopK", False, True),
        ("SharedBatchExecutor", True, True),
        ("SharedBatchExecutor", False, False),
    ],
)
def test_search_topk_sorted_matches_jax(index, cls, desc, filtered):  # noqa: F811
    B, k = 6, 64
    qs = _queries(30, B)
    jplans, tplans = _sorted_plans(index, qs)
    vals, present = _sort_inputs(31)
    kw = dict(
        sort_vals=vals, sort_present=present,
        svals_key=("svals", 1, "price", 1), desc=desc,
        doc_masks=_masks(32, B) if filtered else None,
        thresholds=[0, 0, 1, 0, 2, 0],
        omc=np.random.default_rng(33).uniform(0.5, 2, N_DOCS).astype(np.float32),
        omc_key=("omc", 1),
    )
    args = ([float(N_DOCS)] * B, N_DOCS, k)
    exp_ranked, exp_counts = getattr(jexec, cls)().search_topk_sorted(
        index.jax, jplans, *args, **kw)
    ex = getattr(texec, cls)("cpu")
    ranked, counts = ex.search_topk_sorted(index.torch, tplans, *args, **kw)
    np.testing.assert_array_equal(counts, exp_counts)
    assert counts.dtype == np.int32 and (counts > 0).sum() >= B - 2
    for got, exp in zip(ranked, exp_ranked):
        assert [d for d, _ in got] == [d for d, _ in exp]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in exp],
                                   rtol=RTOL)
    # the column was cached under its version key, and a new version
    # replaces the old one
    capb = tbm25.round_up_pow2(N_DOCS, 128)
    key = (kw["svals_key"], capb)
    assert ex._fmask_dev.get(key) is not texec._MISS
    ex._get_device_svals(vals, present, ("svals", 1, "price", 2), capb)
    assert ex._fmask_dev.get(key) is texec._MISS


def test_search_topk_sorted_orders_like_the_host(index):  # noqa: F811
    """The per-query page against a host ordering of the numpy reference
    scores: (value, doc) for docs with the field, then fieldless by doc."""
    q = ["w3", "w7"]
    vals, present = _sort_inputs(40)
    ranked, counts = texec.StringSearchTopK("cpu").search_topk_sorted(
        index.torch, _sorted_plans(index, [q])[1], [float(N_DOCS)], N_DOCS,
        8192, sort_vals=vals, sort_present=present, svals_key=None, desc=True,
    )
    ref = texec.host_bm25_reference(index.torch, q, PROPS, {"title": 2.0},
                                    float(N_DOCS))
    with_f = sorted((d for d in ref if present[d]), key=lambda d: (-vals[d], d))
    without = sorted(d for d in ref if not present[d])
    assert counts[0] == len(ref) < 8192
    assert [d for d, _ in ranked[0]] == with_f + without
    np.testing.assert_allclose([s for _, s in ranked[0]],
                               [ref[d] for d in with_f + without], rtol=RTOL)


def _pad_pages(pages, R):
    ids = np.full((len(pages), R), -1, np.int64)
    vals = np.full((len(pages), R), -np.inf)
    for g, page in enumerate(pages):
        for r, (d, v) in enumerate(page):
            ids[g, r], vals[g, r] = d, v
    return vals, ids


@pytest.mark.parametrize("n_groups,filtered", [(5, False), (5, True),
                                               (40, False), (40, True)])
def test_search_topk_grouped_matches_jax(index, n_groups, filtered):  # noqa: F811
    """n_groups 5 rounds up to G=8 (the JAX scan branch), 40 to G=64 (the
    JAX sort branch)."""
    B, k, max_results = 6, 10, 6
    qs = _queries(50 + n_groups, B)
    jplans, tplans = _sorted_plans(index, qs)
    gid = np.random.default_rng(51).integers(-1, n_groups, N_DOCS).astype(np.int32)
    kw = dict(
        gid_col=gid, gid_key=("gid", 1, "cat", 1), n_groups=n_groups,
        max_results=max_results,
        doc_masks=_masks(52, B) if filtered else None,
        thresholds=[0, 0, 1, 0, 2, 0],
        omc=np.random.default_rng(53).uniform(0.5, 2, N_DOCS).astype(np.float32),
        omc_key=("omc", 1),
    )
    args = ([float(N_DOCS)] * B, N_DOCS, k)
    ev, ei, ec, epages = jexec.StringSearchTopK().search_topk_grouped(
        index.jax, jplans, *args, **kw)
    tv, ti, tc, tpages = texec.StringSearchTopK("cpu").search_topk_grouped(
        index.torch, tplans, *args, **kw)
    assert_topk_agrees(tv, ti, ev, ei)
    np.testing.assert_array_equal(tc, ec)
    assert len(tpages) == B and all(len(p) == n_groups for p in tpages)
    n_entries = 0
    for got, exp in zip(tpages, epages):
        gv, gi = _pad_pages(got, max_results)
        xv, xi = _pad_pages(exp, max_results)
        assert_topk_agrees(gv, gi, xv, xi)
        n_entries += sum(len(p) for p in got)
        for g, page in enumerate(got):
            assert all(gid[d] == g for d, _ in page)
    assert n_entries > B * n_groups // 2
