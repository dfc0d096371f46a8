"""oramacore_tpu_torch.index.vector_index against the JAX package's
VectorIndex on the same inserts (CPU).

Flat searches compare hits doc for doc with scores within atol 1e-5. The
IVF tier runs on the JAX index's own layout, carried across with
`VectorIndex.from_jax_state`, so probe windows and candidates are the
same rows; its f32 rerank is the same numpy code. The port's own k-means
build is compared with JAX's: centroids within atol 1e-4 (both sum
bf16-rounded rows in f32, in other orders), assignments equal outside
near-ties. Both packages' IVF thresholds are shrunk with monkeypatch, as
tests/test_ivf.py does."""

import numpy as np
import pytest
import torch

import oramacore_tpu.index.vector_index as jvi
import oramacore_tpu_torch.index.vector_index as tvi
from tests.test_ivf import clustered_corpus

ATOL = 1e-5
DIM = 32


def _cfg(rescale=None):
    return dict(dim=DIM, score_rescale=rescale)


def _pair(rescale=None):
    return (jvi.VectorIndex(jvi.VectorIndexConfig(**_cfg(rescale))),
            tvi.VectorIndex(tvi.VectorIndexConfig(**_cfg(rescale)), "cpu"))


def _both(pair, method, *args, **kw):
    return [getattr(x, method)(*args, **kw) for x in pair]


def assert_hits_agree(got, exp, atol=ATOL):
    assert set(got) == set(exp), (sorted(set(got) ^ set(exp)))
    for d, s in exp.items():
        assert abs(got[d] - s) <= atol, (d, got[d], s)


@pytest.fixture
def small_ivf(monkeypatch):
    for mod in (jvi, tvi):
        monkeypatch.setattr(mod, "IVF_MIN_ROWS", 2000)
        monkeypatch.setattr(mod, "IVF_NPROBE", 8)


def _fill(pair, rng, n_docs, first=0):
    """Docs first..first+n_docs-1; every fifth doc has two vectors."""
    for d in range(first, first + n_docs):
        vecs = rng.normal(size=(2 if d % 5 == 0 else 1, DIM)).astype(np.float32)
        _both(pair, "insert", d, list(vecs))


@pytest.fixture
def flat_pair():
    """1,200 committed docs (a delete dropped at commit), then 150 live
    docs after the commit, one of them deleted live."""
    rng = np.random.default_rng(0)
    pair = _pair()
    _fill(pair, rng, 1200)
    _both(pair, "commit", deleted={17, 20})
    _fill(pair, rng, 150, first=1200)
    _both(pair, "delete_doc_live", 1210)
    assert pair[1].n_rows() == pair[0].n_rows() > 1350
    assert 20 not in pair[1]._committed_docs
    return pair


def _targets(rng, n):
    return list(rng.normal(size=(n, DIM)).astype(np.float32))


@pytest.mark.parametrize("filtered", [False, True])
def test_flat_search_matches_jax(flat_pair, filtered):
    rng = np.random.default_rng(1)
    mask = rng.random(1400) < 0.5 if filtered else None
    for n_targets in (1, 3):
        exp, got = _both(flat_pair, "search", _targets(rng, n_targets),
                         limit=10, similarity=0.05, filter_mask=mask)
        assert len(exp) >= 10
        assert_hits_agree(got, exp)
        if filtered:
            assert all(mask[d] for d in got)
    # a live row after the commit is found, a live-deleted doc is not
    live_doc, live_vec = flat_pair[1]._live_docs[-1], flat_pair[1]._live_rows[-1]
    exp, got = _both(flat_pair, "search", [live_vec], limit=10, similarity=0.0)
    assert live_doc in got and 1210 not in got
    assert_hits_agree(got, exp)


def test_flat_search_many_with_rescale_matches_jax():
    rng = np.random.default_rng(2)
    pair = _pair(rescale=(0.7, 1.0))
    base = rng.normal(size=(40, DIM)).astype(np.float32)
    for d in range(900):  # rows near a few directions: rescale keeps many
        v = base[d % 40] + 0.4 * rng.normal(size=DIM).astype(np.float32)
        _both(pair, "insert", d, [v])
    _both(pair, "commit")
    q = base[:6] + 0.2 * rng.normal(size=(6, DIM)).astype(np.float32)
    sims = [0.0, 0.2, 0.5, 0.0, 0.9, 0.1]
    exp, got = _both(pair, "search_many", q, limit=8, similarities=sims)
    for g, e in zip(got, exp):
        assert_hits_agree(g, e)
    assert any(0.0 < s < 1.0 for e in exp for s in e.values())


def test_flat_duplicated_rows_keep_the_jax_tie_order():
    """Docs inserted with the same vector tie exactly: the rows of the
    page come in JAX's order, slot for slot."""
    rng = np.random.default_rng(3)
    pair = _pair()
    protos = rng.normal(size=(4, DIM)).astype(np.float32)
    for d in range(3000):
        _both(pair, "insert", d, [protos[rng.integers(0, 4)]])
    _both(pair, "commit")
    q = tvi.l2_normalize(protos[:3] + 0.1)
    (ev, er), (tv, tr) = [x._topk_rows(q, 12, None)[:2] for x in pair]
    np.testing.assert_array_equal(tr, np.asarray(er))
    np.testing.assert_allclose(tv, np.asarray(ev), atol=ATOL)
    assert len(np.unique(tv[0])) == 1  # one tie group fills the page


def test_flat_device_rows_layout(flat_pair):
    jm, jd, jv = flat_pair[0].flat_device_rows()
    tm, td, tv = flat_pair[1].flat_device_rows()
    assert tm.dtype == torch.bfloat16 and tm.shape == tuple(jm.shape)
    np.testing.assert_array_equal(tm.float().numpy(),
                                  np.asarray(jm).astype(np.float32))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert flat_pair[1].int8_device_rows() is None
    assert flat_pair[1].int8_doc2row(2048) is None


@pytest.fixture
def ivf_pair(small_ivf):
    """The JAX index builds its IVF at commit; the port's index takes that
    layout over with from_jax_state."""
    n = 4000
    vecs = clustered_corpus(n, DIM, seed=0)
    j = jvi.VectorIndex(jvi.VectorIndexConfig(dim=DIM))
    for i in range(n):
        j.insert(i, [vecs[i]])
    j.commit()
    assert j._ivf is not None
    t = tvi.VectorIndex.from_jax_state(
        j._committed_matrix, j._committed_docs, j._ivf,
        tvi.VectorIndexConfig(dim=DIM), "cpu")
    return (j, t), vecs


def _near(vecs, rng, n):
    q = vecs[rng.choice(len(vecs), n)]
    return list(q + 0.05 * rng.normal(size=q.shape).astype(np.float32))


def test_ivf_search_on_the_jax_layout_matches_jax(ivf_pair):
    pair, vecs = ivf_pair
    rng = np.random.default_rng(4)
    for q in _near(vecs, rng, 8):
        exp, got = _both(pair, "search", [q], limit=10, similarity=-1.0)
        assert_hits_agree(got, exp)
    exp, got = _both(pair, "search", _near(vecs, rng, 3), limit=10,
                     similarity=0.5)
    assert_hits_agree(got, exp)


def test_ivf_search_many_and_filter_match_jax(ivf_pair):
    pair, vecs = ivf_pair
    rng = np.random.default_rng(5)
    qs = np.stack(_near(vecs, rng, 6))
    exp, got = _both(pair, "search_many", qs, limit=10,
                     similarities=[-1.0, 0.0, 0.5, 0.9, -1.0, 0.3])
    for g, e in zip(got, exp):
        assert_hits_agree(g, e)
    mask = np.zeros(len(vecs), bool)
    mask[rng.choice(len(vecs), 1500, replace=False)] = True
    exp, got = _both(pair, "search", [qs[0]], limit=10, similarity=-1.0,
                     filter_mask=mask)
    assert got and all(mask[d] for d in got)
    assert_hits_agree(got, exp)


def test_ivf_device_rows_and_doc2row_match_jax(ivf_pair):
    (j, t), _ = ivf_pair
    assert t.flat_device_rows() is None
    ej, et = j.int8_device_rows(), t.int8_device_rows()
    assert et[5:] == tuple(ej[5:])                    # window, nprobe
    for a, b in zip(et[:5], ej[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t.int8_doc2row(3000).numpy(),
                                  np.asarray(j.int8_doc2row(3000)))
    assert t.int8_doc2row(3000) is t.int8_doc2row(3000)  # cached


def test_ivf_with_live_rows_searches_flat_like_jax(ivf_pair):
    pair, vecs = ivf_pair
    new = tvi.l2_normalize(np.ones(DIM, np.float32))
    _both(pair, "insert", len(vecs), [new])
    exp, got = _both(pair, "search", [new], limit=5, similarity=-1.0)
    assert got[len(vecs)] == pytest.approx(1.0, abs=2e-2)
    assert_hits_agree(got, exp)


def _row_centroids(ivf, n):
    """Centroid of each committed row under an IVF layout: packed row j
    lies in the last unit starting at or before j."""
    u = np.searchsorted(ivf["unit_starts"], np.arange(n), side="right") - 1
    out = np.empty((n, ivf["unit_cen"].shape[1]), np.float32)
    out[ivf["perm"]] = ivf["unit_cen"][u]
    return out


def test_own_ivf_build_matches_jax(small_ivf):
    """The port's _build_ivf against JAX's on tests/test_ivf.py's
    clustered corpus: centroids within atol 1e-4, assignments equal
    outside near-ties, the same packed layout where they are equal, and
    recall@10 >= 0.95 of the port's own layout."""
    n = 4000
    vecs = clustered_corpus(n, DIM, seed=0)
    pair = _pair()
    for i in range(n):
        _both(pair, "insert", i, [vecs[i]])
    _both(pair, "commit")
    (j, t) = pair
    assert t._ivf is not None and t._ivf["window"] == j._ivf["window"]
    cj, ct = _row_centroids(j._ivf, n), _row_centroids(t._ivf, n)
    same = np.abs(cj - ct).max(axis=1) <= 1e-4
    # a row may move only between two centroids it is near-tied to
    for r in np.nonzero(~same)[0]:
        assert abs(vecs[r] @ cj[r] - vecs[r] @ ct[r]) <= 1e-3, r
    assert same.mean() >= 0.99
    if same.all():
        for key in ("q", "scales", "docs", "unit_starts", "perm"):
            np.testing.assert_array_equal(t._ivf[key], j._ivf[key], key)
    rng = np.random.default_rng(7)
    queries = tvi.l2_normalize(
        vecs[rng.choice(n, 20)] + 0.05 * rng.normal(size=(20, DIM)).astype(np.float32)
    )
    recalls = []
    for q in queries:
        exact = set(np.argsort(-(vecs @ q))[:10].tolist())
        got = t.search([q], limit=10, similarity=-1.0)
        top = sorted(got.items(), key=lambda kv: -kv[1])[:10]
        recalls.append(len(exact & {d for d, _ in top}) / 10)
    assert np.mean(recalls) >= 0.95, np.mean(recalls)


def test_oversized_cluster_splits_into_units(small_ivf):
    """n_centroids=4 over a corpus that is 95% one vector: that cluster
    spans several probe units, and both packages build the same units."""
    rng = np.random.default_rng(9)
    hub = tvi.l2_normalize(rng.normal(size=(1, 16)).astype(np.float32))
    rest = tvi.l2_normalize(rng.normal(size=(150, 16)).astype(np.float32))
    vecs = np.concatenate([np.repeat(hub, 2850, axis=0), rest])
    pair = (jvi.VectorIndex(jvi.VectorIndexConfig(dim=16)),
            tvi.VectorIndex(tvi.VectorIndexConfig(dim=16), "cpu"))
    for i in range(len(vecs)):
        _both(pair, "insert", i, [vecs[i]])
    _both(pair, "commit")
    _both(pair, "_build_ivf", n_centroids=4)
    (j, t) = pair
    assert len(t._ivf["unit_starts"]) > 4
    np.testing.assert_array_equal(t._ivf["unit_starts"], j._ivf["unit_starts"])
    got = t.search([vecs[len(vecs) - 1]], limit=5, similarity=-1.0)
    assert got[len(vecs) - 1] >= 0.95


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_loads_in_the_other_package(flat_pair, tmp_path, writer):
    j, t = flat_pair
    _both(flat_pair, "commit")
    prefix = str(tmp_path / "snap" / "vec")
    if writer == "jax":
        jvi.save_vector_index(j, prefix)
        loaded = tvi.load_vector_index(prefix, tvi.VectorIndexConfig(dim=DIM), "cpu")
    else:
        tvi.save_vector_index(t, prefix)
        loaded = jvi.load_vector_index(prefix, jvi.VectorIndexConfig(dim=DIM))
    np.testing.assert_array_equal(loaded._committed_matrix, j._committed_matrix)
    np.testing.assert_array_equal(loaded._committed_docs, j._committed_docs)
    q = _targets(np.random.default_rng(8), 1)
    assert_hits_agree(loaded.search(q, 10, 0.0), j.search(q, 10, 0.0))
