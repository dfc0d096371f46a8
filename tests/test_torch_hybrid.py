"""oramacore_tpu_torch.ops.hybrid and the hybrid executors against the JAX
package's on the same numpy inputs (CPU; the port's kernels run their
plain versions here).

Tolerances: scores atol 1e-5 (bf16-rounded operands multiply exactly on
both sides; f32 sums run in other orders); match counts and packed match
bits exact; top-k ids equal outside near-ties (`assert_topk_agrees`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oramacore_tpu.index.string_index as jsi
import oramacore_tpu.index.vector_index as jvi
import oramacore_tpu_torch.index.string_index as tsi
import oramacore_tpu_torch.index.vector_index as tvi
from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu.ops import hybrid as jhybrid
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.index.plan import plan_query
from oramacore_tpu_torch.ops import hybrid as thybrid
from oramacore_tpu_torch.ops import vector as tvector
from tests.test_torch_bm25 import assert_topk_agrees, make_case

ATOL = 1e-5
D = 32
RESCALE = (0.7, 1.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _rkw(rescale):
    return dict(has_rescale=rescale is not None,
                rescale_lo=rescale[0] if rescale else 0.0,
                rescale_hi=rescale[1] if rescale else 1.0)


def make_vectors(seed, B, cap, n_rows=6000):
    """Rows of docs in [0, cap + 10) (a few past cap; some docs with
    several rows, some with none), ~3% invalid; queries near some rows,
    with per-query similarity thresholds."""
    rng = np.random.default_rng(seed)
    rows = tvector.l2_normalize(rng.normal(size=(n_rows, D)).astype(np.float32))
    doc = rng.integers(0, cap + 10, n_rows).astype(np.int32)
    valid = rng.random(n_rows) < 0.97
    near = rows[rng.integers(0, n_rows, B)]
    q = tvector.l2_normalize(near + 0.05 * rng.normal(size=(B, D)).astype(np.float32))
    sim = rng.choice([0.0, 0.1, 0.3, 0.75], B).astype(np.float32)
    return rows, doc, valid, q, sim


def ivf_layout(rows, seed, window=512, U=16):
    """A packed int8 layout of `rows` with U probe units (the last clamped)."""
    rng = np.random.default_rng(seed)
    q8, sc = (t.numpy() for t in tvector.quantize_rows_int8(_t(rows)))
    n = len(rows)
    starts = np.sort(rng.choice(n - 1, U, replace=False)).astype(np.int32)
    starts[-1] = n - window // 2
    cen = tvector.l2_normalize(rows[starts.clip(0, n - 1)] + 0.1)
    return q8, sc, cen.astype(np.float32), starts, window


@pytest.mark.parametrize("rescale", [None, RESCALE])
def test_vector_dense_scores(rescale):
    cap, B = 4096, 5
    rows, doc, valid, q, sim = make_vectors(0, B, cap)
    kw = dict(cap=cap, **_rkw(rescale))
    exp = jhybrid._vector_dense_scores(
        _j(rows).astype(jnp.bfloat16), _j(doc), _j(valid), _j(q), _j(sim), **kw)
    got = thybrid._vector_dense_scores(
        _t(rows).to(torch.bfloat16), _t(doc), _t(valid), _t(q), _t(sim), **kw)
    assert got.shape == (B, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    assert (np.asarray(exp) > 0).sum() >= B


def test_vector_dense_scores_in_small_chunks(monkeypatch):
    """Chunking the (B, N) similarities does not change the maxima."""
    cap, B = 4096, 3
    rows, doc, valid, q, sim = make_vectors(1, B, cap)
    args = (_t(rows).to(torch.bfloat16), _t(doc), _t(valid), _t(q), _t(sim))
    kw = dict(cap=cap, **_rkw(None))
    whole = thybrid._vector_dense_scores(*args, **kw)
    monkeypatch.setattr(thybrid, "_SIM_ELEMS", 1000)
    assert torch.equal(thybrid._vector_dense_scores(*args, **kw), whole)


@pytest.mark.parametrize("has_mask,has_omc", [(False, False), (True, True)])
def test_fuse(has_mask, has_omc):
    rng = np.random.default_rng(2)
    B, cap = 4, 2048
    bm25 = (rng.random((B, cap)) * (rng.random((B, cap)) < 0.2) * 9).astype(np.float32)
    matched = rng.integers(0, 3, (B, cap)).astype(np.float32)
    vec = (rng.random((B, cap)) * (rng.random((B, cap)) < 0.1)).astype(np.float32)
    vec[3] = 0.0  # a query with no vector hit: span from BM25 alone
    bm25[2] = 0.0  # one with no text hit
    thr = np.array([0, 1, 0, 2], np.float32)
    mask = rng.random((B, cap)) < 0.6
    omc = rng.uniform(0.5, 2, cap).astype(np.float32)
    ef, ep = jhybrid._fuse(_j(bm25), _j(matched), _j(vec), _j(thr),
                           _j(mask if has_mask else np.ones((B, cap), bool)),
                           _j(omc), has_omc=has_omc)
    tf, tp = thybrid._fuse(_t(bm25), _t(matched), _t(vec), _t(thr),
                           _t(mask) if has_mask else None,
                           _t(omc) if has_omc else None, has_omc=has_omc)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(ep))
    np.testing.assert_allclose(tf.numpy(), np.asarray(ef), rtol=1e-6)


def _packed_args(c, q, sim, use_thr):
    B = c["starts"].shape[0]
    idesc = np.stack([c["starts"], c["lens"]])
    fdesc = np.stack([c["weights"], c["field_b"], c["avg"]])
    scalars = np.stack([c["n_docs"], c["thr"] if use_thr else np.zeros(B, np.float32),
                        sim]).astype(np.float32)
    return [*c["slab"], idesc, fdesc, scalars]


def _assert_search_out(got, exp, with_bitmap):
    assert len(got) == len(exp) == (4 if with_bitmap else 3)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    assert_topk_agrees(got[0].numpy(), got[1].numpy(), exp[0], exp[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(exp[2]))
    assert np.asarray(exp[2]).min() > 0
    if with_bitmap:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(exp[3]))


@pytest.mark.parametrize(
    "has_mask,has_omc,use_thr,rescale,with_bitmap,exact",
    [
        (False, False, False, None, False, False),
        (True, True, True, RESCALE, True, False),
        (True, False, True, None, True, True),
        (False, True, False, RESCALE, False, False),
    ],
)
def test_hybrid_search_topk_packed(has_mask, has_omc, use_thr, rescale,
                                   with_bitmap, exact):
    c = make_case(3)
    B, cap = c["starts"].shape[0], c["cap"]
    rows, doc, valid, q, sim = make_vectors(4, B, cap)
    base = _packed_args(c, q, sim, use_thr)
    mask = c["mask"] if has_mask else np.zeros((1, 1), bool)
    omc = c["omc"] if has_omc else np.ones(1, np.float32)
    kw = dict(lr=c["lr"], exact=exact, cap=cap, k=16, has_mask=has_mask,
              has_omc=has_omc, with_bitmap=with_bitmap, **_rkw(rescale))
    exp = jhybrid.hybrid_search_topk_packed(
        *map(_j, base), _j(rows).astype(jnp.bfloat16), _j(doc), _j(valid),
        _j(q), _j(mask), _j(omc), **kw)
    got = thybrid.hybrid_search_topk_packed(
        *map(_t, base), _t(rows).to(torch.bfloat16), _t(doc), _t(valid),
        _t(q), _t(mask) if has_mask else None, _t(omc) if has_omc else None,
        **kw)
    _assert_search_out(got, exp, with_bitmap)


@pytest.mark.parametrize("has_mask,rescale", [(False, None), (True, RESCALE)])
def test_vector_dense_scores_int8(has_mask, rescale):
    cap, B = 4096, 5
    rows, doc, _, q, sim = make_vectors(5, B, cap)
    q8, sc, cen, starts, window = ivf_layout(rows, 6)
    mask = (np.random.default_rng(7).random((B, cap)) < 0.5 if has_mask
            else np.ones((B, 1), bool))
    kw = dict(cap=cap, V=64, nprobe=4, window=window, has_mask=has_mask,
              **_rkw(rescale))
    args = (q8, sc, doc, cen, starts, q, sim, mask)
    exp = jhybrid._vector_dense_scores_int8(*map(_j, args), **kw)
    got = thybrid._vector_dense_scores_int8(*map(_t, args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    assert (np.asarray(exp) > 0).sum() > 0


@pytest.mark.parametrize(
    "has_mask,has_omc,has_champ,rescale,with_bitmap",
    [
        (False, False, False, None, False),
        (True, True, True, RESCALE, True),
        (False, True, True, None, True),
    ],
)
def test_hybrid_search_topk_packed_int8(has_mask, has_omc, has_champ, rescale,
                                        with_bitmap):
    c = make_case(8)
    B, cap = c["starts"].shape[0], c["cap"]
    rows, doc, _, q, sim = make_vectors(9, B, cap)
    q8, sc, cen, starts, window = ivf_layout(rows, 10)
    base = _packed_args(c, q, sim, True) + [q8, sc, doc, cen, starts, q]
    mask = c["mask"] if has_mask else np.zeros((1, 1), bool)
    omc = c["omc"] if has_omc else np.ones(1, np.float32)
    champ = [c["champs"], c["ch_idx"], c["ch_w"]] if has_champ else []
    kw = dict(lr=c["lr"], exact=False, cap=cap, k=16, V=64, nprobe=5,
              window=window, has_mask=has_mask, has_omc=has_omc,
              has_champ=has_champ, with_bitmap=with_bitmap, **_rkw(rescale))
    exp = jhybrid.hybrid_search_topk_packed_int8(
        *map(_j, base), _j(mask), _j(omc), *map(_j, champ), **kw)
    got = thybrid.hybrid_search_topk_packed_int8(
        *map(_t, base), _t(mask) if has_mask else None,
        _t(omc) if has_omc else None, *map(_t, champ), **kw)
    _assert_search_out(got, exp, with_bitmap)


def _shared_scores(seed, B, cap):
    rng = np.random.default_rng(seed)
    scores = (rng.random((B, cap)) * (rng.random((B, cap)) < 0.1) * 7).astype(np.float32)
    matched = np.where(scores > 0, rng.integers(1, 3, (B, cap)), 0).astype(np.float32)
    thr = rng.integers(0, 2, B).astype(np.float32)
    return scores, matched, thr


@pytest.mark.parametrize("tail", ["flat", "int8"])
@pytest.mark.parametrize("has_mask,has_omc,rescale",
                         [(False, False, None), (True, True, RESCALE)])
def test_hybrid_finalize_topk(tail, has_mask, has_omc, rescale):
    B, cap = 6, 4096
    scores, matched, thr = _shared_scores(11, B, cap)
    rows, doc, valid, q, sim = make_vectors(12, B, cap)
    rng = np.random.default_rng(13)
    mask = rng.random((B, cap)) < 0.6 if has_mask else np.zeros((1, 1), bool)
    omc = rng.uniform(0.5, 2, cap).astype(np.float32) if has_omc else np.ones(1, np.float32)
    kw = dict(cap=cap, k=16, has_mask=has_mask, has_omc=has_omc, **_rkw(rescale))
    if tail == "flat":
        jvec = (_j(rows).astype(jnp.bfloat16), _j(doc), _j(valid))
        tvec = (_t(rows).to(torch.bfloat16), _t(doc), _t(valid))
        jfn, tfn = jhybrid.hybrid_finalize_topk, thybrid.hybrid_finalize_topk
    else:
        q8, sc, cen, starts, window = ivf_layout(rows, 14)
        jvec = tuple(map(_j, (q8, sc, doc, cen, starts)))
        tvec = tuple(map(_t, (q8, sc, doc, cen, starts)))
        kw.update(V=64, nprobe=4, window=window)
        jfn, tfn = jhybrid.hybrid_finalize_topk_int8, thybrid.hybrid_finalize_topk_int8
    exp = jfn(_j(scores), _j(matched), _j(thr), *jvec, _j(q), _j(sim),
              _j(mask), _j(omc), **kw)
    got = tfn(_t(scores), _t(matched), _t(thr), *tvec, _t(q), _t(sim),
              _t(mask) if has_mask else None, _t(omc) if has_omc else None,
              **kw)
    _assert_search_out(got, exp, False)


# ---------------------------------------------------------------------------
# The executors, on one StringIndex with champion terms and a live layer,
# and a vector index per package whose docs are the index's docs
# ---------------------------------------------------------------------------

CHAMP_MIN = 2048
N_COMMITTED = CHAMP_MIN + 600
N_DOCS = N_COMMITTED + 300
VOCAB = [f"w{i}" for i in range(120)]
PROPS = ["title", "body"]


def _index_doc(idx, rng, d, heavy):
    words = list(rng.choice(VOCAB, int(rng.integers(2, 6))))
    title = words + (["heavy"] if heavy else []) + ["common"]
    idx.index_text(d, "title", [(w, []) for w in title])
    body = list(rng.choice(VOCAB, int(rng.integers(3, 9))))
    idx.index_text(d, "body", [(w, []) for w in body])


def _string_index(module):
    """The corpus's StringIndex of one package (string_index module
    `module`), and the generator it leaves for the vectors."""
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "CHAMPION_MIN", CHAMP_MIN)
        idx = module.StringIndex()
        for d in range(N_COMMITTED):
            _index_doc(idx, rng, d, heavy=True)
        idx.commit()
        for d in range(N_COMMITTED, N_DOCS):
            _index_doc(idx, rng, d, heavy=False)
        idx.slab_split()
    assert ("title", "heavy") in idx._champ_map
    return idx, rng


@pytest.fixture(scope="module")
def corpus():
    """One seeded corpus in each package's StringIndex ('jidx' for the JAX
    executors, 'tidx' for the port's). 'heavy' is a committed-only
    champion term; 'common' has live postings too, so it falls back to
    ranged scanning. Vectors: docs d % 7 == 0 have two rows, d % 11 == 3
    none. The IVF layout is the JAX index's own, carried into the
    port's."""
    jidx, rng = _string_index(jsi)
    tidx, _ = _string_index(tsi)
    jv = jvi.VectorIndex(jvi.VectorIndexConfig(dim=D))
    tv = tvi.VectorIndex(tvi.VectorIndexConfig(dim=D), "cpu")
    vecs = {}
    for d in range(N_DOCS):
        if d % 11 == 3:
            continue
        vecs[d] = rng.normal(size=(2 if d % 7 == 0 else 1, D)).astype(np.float32)
        for v in (jv, tv):
            v.insert(d, list(vecs[d]))
    for v in (jv, tv):
        v.commit()
    ji = jvi.VectorIndex(jvi.VectorIndexConfig(dim=D))
    ji._committed_matrix = jv._committed_matrix
    ji._committed_docs = jv._committed_docs
    ji._build_ivf()
    ti = tvi.VectorIndex.from_jax_state(
        ji._committed_matrix, ji._committed_docs, ji._ivf,
        tvi.VectorIndexConfig(dim=D), "cpu")
    return dict(jidx=jidx, tidx=tidx, vecs=vecs, jv=jv, tv=tv, ji=ji, ti=ti)


def _queries(corpus, seed, B):
    rng = np.random.default_rng(seed)
    pool = VOCAB[:40] + ["heavy", "common", "nosuchword"]
    toks = [list(rng.choice(pool, int(rng.integers(1, 4)))) for _ in range(B)]
    toks[0] = ["nosuchword"]  # a vector-only query, never filtered
    toks[1] = ["heavy", "w1"]
    docs = rng.choice(sorted(corpus["vecs"]), B)
    q = np.stack([corpus["vecs"][d][0] for d in docs])
    q = tvector.l2_normalize(q + 0.05 * rng.normal(size=q.shape).astype(np.float32))
    sims = rng.choice([0.0, 0.1, 0.3], B).tolist()
    return toks, q.astype(np.float32), sims


def _masks(seed, B):
    rng = np.random.default_rng(seed)
    return [None if b % 3 == 0 else rng.random(N_DOCS) < 0.5 for b in range(B)]


def _exec_kw(seed, B, filtered, rescale):
    return dict(
        doc_masks=_masks(seed, B) if filtered else None,
        thresholds=[0.0] * (B - 2) + [1.0, 2.0],
        omc=np.random.default_rng(seed + 1).uniform(0.5, 2, N_DOCS).astype(np.float32),
        omc_key=("omc", 1), rescale=rescale,
    )


@pytest.mark.parametrize("filtered,rescale", [(False, None), (True, RESCALE)])
def test_search_topk_hybrid_matches_jax(corpus, filtered, rescale):
    B = 6
    jidx, tidx = corpus["jidx"], corpus["tidx"]
    toks, q, sims = _queries(corpus, 1, B)
    jplans = [jidx.plan_query(t, PROPS, {"title": 2.0}) for t in toks]
    tplans = [plan_query(tidx, t, PROPS, {"title": 2.0}) for t in toks]
    args = ([float(N_DOCS)] * B, N_DOCS, 10)
    kw = dict(_exec_kw(2, B, filtered, rescale), with_bitmap=True)
    exp = jexec.HybridSearchTopK().search_topk_hybrid(
        jidx, jplans, *args, corpus["jv"].flat_device_rows(), q, sims, **kw)
    got = texec.HybridSearchTopK("cpu").search_topk_hybrid(
        tidx, tplans, *args, corpus["tv"].flat_device_rows(), q, sims, **kw)
    assert_topk_agrees(got[0], got[1], exp[0], exp[1])
    np.testing.assert_array_equal(got[2], exp[2])
    assert got[3].shape == (B, N_DOCS)
    np.testing.assert_array_equal(got[3], exp[3])
    assert got[2][0] > 0  # the vector-only query matched


@pytest.mark.parametrize("filtered,with_bitmap", [(False, False), (True, True)])
def test_search_topk_hybrid_int8_matches_jax(corpus, filtered, with_bitmap):
    """Champion plans (use_champions=True, as the read side plans this
    path) on the JAX index's IVF layout."""
    B = 6
    jidx, tidx = corpus["jidx"], corpus["tidx"]
    toks, q, sims = _queries(corpus, 3, B)
    jplans = [jidx.plan_query(t, PROPS, {}, use_champions=True) for t in toks]
    tplans = [plan_query(tidx, t, PROPS, {}, use_champions=True) for t in toks]
    assert any(p.champ_idx is not None for p in tplans)
    args = ([float(N_DOCS)] * B, N_DOCS, 10)
    kw = dict(_exec_kw(4, B, filtered, None), with_bitmap=with_bitmap,
              candidates=64)
    exp = jexec.HybridSearchTopK().search_topk_hybrid_int8(
        jidx, jplans, *args, corpus["ji"].int8_device_rows(), q, sims, **kw)
    got = texec.HybridSearchTopK("cpu").search_topk_hybrid_int8(
        tidx, tplans, *args, corpus["ti"].int8_device_rows(), q, sims, **kw)
    assert_topk_agrees(got[0], got[1], exp[0], exp[1])
    np.testing.assert_array_equal(got[2], exp[2])
    if with_bitmap:
        np.testing.assert_array_equal(got[3], exp[3])


@pytest.mark.parametrize("tail", ["vec_rows", "vec_rows_int8"])
@pytest.mark.parametrize("filtered", [False, True])
def test_search_topk_shared_hybrid_tails_match_jax(corpus, tail, filtered):
    B = 10
    toks, q, sims = _queries(corpus, 5, B)
    kw = _exec_kw(6, B, filtered, RESCALE if filtered else None)
    args = (toks, PROPS, {"title": 2.0}, float(N_DOCS), N_DOCS, 10)
    rows = {"vec_rows": ("jv", "tv", "flat_device_rows"),
            "vec_rows_int8": ("ji", "ti", "int8_device_rows")}[tail]
    ev, ei, ec = jexec.SharedBatchExecutor().search_topk_shared(
        corpus["jidx"], *args, queries=q, similarities=sims,
        **{tail: getattr(corpus[rows[0]], rows[2])()}, **kw)
    tv, ti, tc = texec.SharedBatchExecutor("cpu").search_topk_shared(
        corpus["tidx"], *args, queries=q, similarities=sims,
        **{tail: getattr(corpus[rows[1]], rows[2])()}, **kw)
    assert tv.shape == (B, 10)
    assert_topk_agrees(tv, ti, ev, ei)
    np.testing.assert_array_equal(tc, ec)
    assert tc[0] > 0
