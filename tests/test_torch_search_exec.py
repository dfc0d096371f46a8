"""The port's executors and planner against the JAX package's, end to end
on one seeded corpus indexed through index_text + commit into a StringIndex
of each package (the JAX one, and the port's own copy), with a champion
row and an uncommitted live layer (CPU; plain kernel versions)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import oramacore_tpu.index.string_index as jsi
import oramacore_tpu_torch.index.string_index as tsi
from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.index.plan import plan_query
from tests.test_torch_bm25 import assert_topk_agrees

CHAMPION_MIN = tsi.CHAMPION_MIN
assert CHAMPION_MIN == jsi.CHAMPION_MIN

N_COMMITTED = CHAMPION_MIN + 600
N_LIVE = 300
N_DOCS = N_COMMITTED + N_LIVE
VOCAB = [f"w{i}" for i in range(150)]
PROPS = ["title", "body"]


def _index_doc(idx, rng, d, heavy):
    words = list(rng.choice(VOCAB, int(rng.integers(2, 6))))
    title = words + (["heavy"] if heavy else []) + ["common"]
    idx.index_text(d, "title", [(w, []) for w in title])
    body = list(rng.choice(VOCAB, int(rng.integers(3, 9))))
    idx.index_text(d, "body", [(w, ["stem" + w[1:]]) for w in body])


class Indexes(NamedTuple):
    """One corpus in each package's StringIndex: `jax` for the JAX
    executors and planner, `torch` for the port's."""

    jax: object
    torch: object


def build_indexes(build) -> Indexes:
    """`build(module)` fills a fresh index of string_index module `module`
    from a seeded generator. Both take their Python live layer
    (ORAMACORE_NATIVE_LIVE=0), so both slabs come out in one order."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORAMACORE_NATIVE_LIVE", "0")
        return Indexes(build(jsi), build(tsi))


def _build(module):
    rng = np.random.default_rng(0)
    idx = module.StringIndex()
    for d in range(N_COMMITTED):
        _index_doc(idx, rng, d, heavy=True)
    idx.commit()
    for d in range(N_COMMITTED, N_DOCS):
        _index_doc(idx, rng, d, heavy=False)
    idx.slab_split()
    assert ("title", "heavy") in idx._champ_map
    assert ("title", "common") in idx._champ_map
    assert idx._slab_live_arrays is not None
    return idx


@pytest.fixture(scope="module")
def index():
    """'heavy' is a committed-only champion term (routes to the champion
    class); 'common' is one too but also has live postings, so it falls
    back to ranged scanning."""
    return build_indexes(_build)


def _queries(seed, B):
    rng = np.random.default_rng(seed)
    pool = VOCAB[:40] + ["heavy", "common", "stem3", "nosuchword"]
    qs = [list(rng.choice(pool, int(rng.integers(1, 4)))) for _ in range(B)]
    qs[0] = ["heavy", "w1"]
    qs[1] = ["common", "common", "w2"]  # a repeated token counts twice
    return qs


def _masks(seed, B):
    rng = np.random.default_rng(seed)
    return [None if b % 3 == 0 else rng.random(N_DOCS) < 0.5 for b in range(B)]


@pytest.mark.parametrize("filtered", [False, True])
def test_search_topk_shared_matches_jax(index, filtered):
    B = 12
    qs = _queries(1, B)
    kw = dict(
        thresholds=[0.0] * (B - 2) + [1.0, 2.0],
        doc_masks=_masks(2, B) if filtered else None,
        field_params={"body": (1.5, 0.6)},
        omc=np.random.default_rng(3).uniform(0.5, 2, N_DOCS).astype(np.float32),
        omc_key=("omc", 1),
    )
    args = (qs, PROPS, {"title": 2.0}, float(N_DOCS), N_DOCS, 10)
    ev, ei, ec = jexec.SharedBatchExecutor().search_topk_shared(
        index.jax, *args, **kw)
    tv, ti, tc = texec.SharedBatchExecutor("cpu").search_topk_shared(
        index.torch, *args, **kw)
    assert tv.shape == (B, 10) and ti.dtype == np.int32
    assert_topk_agrees(tv, ti, ev, ei)
    np.testing.assert_array_equal(tc, ec)
    assert (tc > 0).sum() >= B - 2


def _plans(index, qs, **kw):
    """Each package's plans on its own index: (JAX plans, port plans)."""
    return ([index.jax.plan_query(q, PROPS, {"title": 2.0}, **kw) for q in qs],
            [plan_query(index.torch, q, PROPS, {"title": 2.0}, **kw)
             for q in qs])


@pytest.mark.parametrize("filtered", [False, True])
def test_search_topk_matches_jax(index, filtered):
    B = 6
    qs = _queries(4, B)
    jplans, tplans = _plans(index, qs, use_champions=True)
    assert any(p.champ_idx is not None for p in tplans)
    kw = dict(
        doc_masks=_masks(5, B) if filtered else None,
        thresholds=[0, 0, 1, 0, 2, 0],
        omc=np.random.default_rng(6).uniform(0.5, 2, N_DOCS).astype(np.float32),
        omc_key=("omc", 1),
        with_bitmap=True,
    )
    args = ([float(N_DOCS)] * B, N_DOCS, 10)
    exp = jexec.StringSearchTopK().search_topk(index.jax, jplans, *args, **kw)
    got = texec.StringSearchTopK("cpu").search_topk(index.torch, tplans, *args,
                                                    **kw)
    assert_topk_agrees(got[0], got[1], exp[0], exp[1])
    np.testing.assert_array_equal(got[2], exp[2])
    assert got[3].shape == (B, N_DOCS)
    np.testing.assert_array_equal(got[3], exp[3])


def test_score_matches_jax(index):
    B = 4
    qs = _queries(7, B)
    jplans, tplans = _plans(index, qs)
    masks = _masks(8, B)
    args = ([float(N_DOCS)] * B, N_DOCS)
    es, em = jexec.StringSearchExecutor().score(index.jax, jplans, *args,
                                                doc_masks=masks)
    ts, tm = texec.StringSearchExecutor("cpu").score(index.torch, tplans, *args,
                                                     doc_masks=masks)
    assert ts.shape == (B, N_DOCS)
    np.testing.assert_array_equal(tm, em)
    np.testing.assert_allclose(ts, es, rtol=1e-5, atol=1e-6)


def test_shared_and_per_query_agree_with_host_reference(index):
    """The slice's two entries against the numpy reference scorer."""
    qs = [["w3", "w7"], ["heavy", "w5"], ["w11", "stem4"]]
    idx = index.torch
    sv, si, _ = texec.SharedBatchExecutor("cpu").search_topk_shared(
        idx, qs, PROPS, {}, float(N_DOCS), N_DOCS, 5
    )
    pv, pi, _ = texec.StringSearchTopK("cpu").search_topk(
        idx, [plan_query(idx, q, PROPS, {}, use_champions=True) for q in qs],
        [float(N_DOCS)] * len(qs), N_DOCS, 5,
    )
    assert_topk_agrees(sv, si, pv, pi)
    for b, q in enumerate(qs):
        ref = texec.host_bm25_reference(idx, q, PROPS, {}, float(N_DOCS))
        top = sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:5]
        np.testing.assert_allclose(sv[b], [s for _, s in top], rtol=1e-5)
        for d, v in zip(si[b], sv[b]):
            np.testing.assert_allclose(ref[int(d)], v, rtol=1e-5)


def test_host_bm25_reference_is_the_jax_packages(index):
    args = (["w1", "heavy"], PROPS, {"body": 0.5}, float(N_DOCS))
    kw = dict(threshold=1.0, doc_mask=_masks(9, 2)[1])
    assert texec.host_bm25_reference(index.torch, *args, **kw) == \
        jexec.host_bm25_reference(index.jax, *args, **kw)


QUERY_CASES = [
    dict(tokens=["w1", "w2", "heavy"], properties=PROPS,
         boost={"title": 2.0, "body": 0.5}),
    dict(tokens=["common", "stem4", "nosuchword"], properties=PROPS,
         boost={}, field_params={"title": (1.3, 0.75), "body": (0.7, 0.5)}),
    dict(tokens=["w5", "heavy"], properties=["title"], boost={},
         token_weights=[0.5, 2.0], impact_cap=100),
    dict(tokens=["w12"], properties=PROPS, boost={}, tolerance=1),
]


@pytest.mark.parametrize("use_champions", [False, True])
@pytest.mark.parametrize("case", range(len(QUERY_CASES)))
def test_plan_query_matches_string_index(index, case, use_champions):
    kw = QUERY_CASES[case]
    exp = index.jax.plan_query(use_champions=use_champions, **kw)
    got = plan_query(index.torch, use_champions=use_champions, **kw)
    assert type(got) is tsi.QueryPlan
    for name in ("starts", "lens", "weights", "field_b", "avg_flen",
                 "champ_idx", "champ_w"):
        e, g = getattr(exp, name), getattr(got, name)
        if e is None:
            assert g is None, name
        else:
            assert g.dtype == e.dtype, name
            np.testing.assert_array_equal(g, e, err_msg=name)
    assert (got.n_tokens, got.max_range_len) == (exp.n_tokens, exp.max_range_len)
    assert got.pre_starts is None and got.spans is None


def test_slab_cache_keys_on_uid_and_generation():
    rng = np.random.default_rng(10)
    idx = tsi.StringIndex()
    for d in range(50):
        _index_doc(idx, rng, d, heavy=False)
    idx.commit()
    ex = texec.StringSearchTopK("cpu")
    slab = ex._get_device_slab(idx)
    assert ex._get_device_slab(idx) is slab
    gen = idx.generation
    _index_doc(idx, rng, 50, heavy=False)  # live write: new generation
    slab2 = ex._get_device_slab(idx)
    assert idx.generation == gen + 1
    assert slab2 is not slab
    assert slab2.doc.shape[0] > slab.doc.shape[0]
    # the committed prefix was kept, not re-uploaded
    n_comm = idx.slab_split()[0][0].shape[0]
    assert torch.equal(slab2.doc[:n_comm], slab.doc[:n_comm])
    # another index with the same generation never hits this entry
    other = tsi.StringIndex()
    for d in range(5):
        _index_doc(other, rng, d, heavy=False)
    other.slab_split()
    assert ex._get_device_slab(other).doc.shape[0] != slab2.doc.shape[0]


def test_hybrid_tails_are_not_ported(index):
    """Both hybrid tails of search_topk_shared run (tests/test_torch_hybrid.py
    holds them against the JAX package): a query with no text match and
    doc 7's vector finds doc 7 first, at the fused maximum 1.0."""
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    vecs = np.random.default_rng(11).normal(size=(1000, 32)).astype(np.float32)
    vidx = VectorIndex(VectorIndexConfig(dim=32), "cpu")
    for d in range(1000):
        vidx.insert(d, [vecs[d]])
    vidx.commit()
    tails = {"vec_rows": vidx.flat_device_rows()}
    vidx._build_ivf()
    tails["vec_rows_int8"] = vidx.int8_device_rows()
    for name, rows in tails.items():
        v, i, c = texec.SharedBatchExecutor("cpu").search_topk_shared(
            index.torch, [["nosuchword"]], PROPS, {}, float(N_DOCS), N_DOCS, 5,
            queries=vecs[7:8] / np.linalg.norm(vecs[7]), similarities=[0.1],
            **{name: rows},
        )
        assert i[0, 0] == 7 and v[0, 0] == 1.0 and c[0] > 1, name
