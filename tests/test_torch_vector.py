"""oramacore_tpu_torch.ops.vector's vector search against the JAX
package's on the same numpy inputs (CPU).

Tolerances: scores atol 1e-5 (both sides multiply bf16-rounded operands
exactly and sum in f32, in different orders); ids equal outside near-ties
(`assert_topk_agrees`). Where every product and sum is exact (rows and
queries of a few multiples of 1/4), ties are exact on both sides and the
ids must equal the JAX ids one for one, which pins the tie order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oramacore_tpu.ops import vector as jvector
from oramacore_tpu_torch.ops import vector as tvector
from tests.test_torch_bm25 import assert_topk_agrees

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n, d):
    return tvector.l2_normalize(rng.normal(size=(n, d)).astype(np.float32))


def _np(x):
    return np.asarray(x)


def assert_search_agrees(got, exp, atol=ATOL):
    """(vals, rows) of the port against JAX's: values within atol, rows
    equal outside near-ties, NEG_INF slots -1 on both sides."""
    gv, gr = (_np(x) for x in got)
    ev, er = (_np(x) for x in exp)
    np.testing.assert_allclose(gv, ev, rtol=0, atol=atol)
    real = ev > -1e29
    assert_topk_agrees(np.where(real, gv, -1.0), gr, np.where(real, ev, -1.0), er)
    np.testing.assert_array_equal(gr[~real], er[~real])


def _exact_corpus(rng, n, d, n_distinct):
    """Rows drawn from a few distinct vectors of multiples of 1/4: every
    dot is exact in f32 and in bf16, so equal rows tie exactly."""
    base = rng.integers(-2, 3, (n_distinct, d)).astype(np.float32) / 4
    return base[rng.integers(0, n_distinct, n)]


@pytest.mark.parametrize("chunk", [1024, 8192])
def test_flat_cosine_topk(chunk):
    rng = np.random.default_rng(0)
    N, D, B, k = 8192, 64, 5, 32
    mat = _unit(rng, N, D)
    q = _unit(rng, B, D)
    valid = rng.random(N) < 0.9
    exp = jvector.flat_cosine_topk(jnp.asarray(q), jnp.asarray(mat, jnp.bfloat16),
                                   jnp.asarray(valid), k=k, chunk=chunk)
    got = tvector.flat_cosine_topk(_t(q), _t(mat).to(torch.bfloat16),
                                   _t(valid), k=k, chunk=chunk)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_search_agrees(got, exp)


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_flat_cosine_topk_duplicated_rows_tie_order(chunk):
    """Many rows share one vector: the carry / chunk merge and the
    in-chunk selection order the ties exactly as JAX does."""
    rng = np.random.default_rng(1)
    N, D, B, k = 8192, 16, 6, 48
    mat = _exact_corpus(rng, N, D, 5)
    q = _exact_corpus(rng, B, D, 6)
    valid = rng.random(N) < 0.8
    exp = jvector.flat_cosine_topk(jnp.asarray(q), jnp.asarray(mat, jnp.bfloat16),
                                   jnp.asarray(valid), k=k, chunk=chunk)
    got = tvector.flat_cosine_topk(_t(q), _t(mat).to(torch.bfloat16),
                                   _t(valid), k=k, chunk=chunk)
    np.testing.assert_array_equal(_np(got[0]), _np(exp[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(exp[1]))
    assert len(np.unique(_np(exp[0])[0])) < k // 4  # the page is all ties


def test_flat_cosine_topk_fewer_valid_rows_than_k():
    rng = np.random.default_rng(2)
    N, D, B, k = 2048, 32, 3, 64
    mat = _unit(rng, N, D)
    q = _unit(rng, B, D)
    valid = np.zeros(N, bool)
    valid[rng.choice(N, 20, replace=False)] = True
    exp = jvector.flat_cosine_topk(jnp.asarray(q), jnp.asarray(mat, jnp.bfloat16),
                                   jnp.asarray(valid), k=k, chunk=1024)
    got = tvector.flat_cosine_topk(_t(q), _t(mat).to(torch.bfloat16),
                                   _t(valid), k=k, chunk=1024)
    assert_search_agrees(got, exp)
    assert (_np(got[1])[:, 20:] == -1).all()
    assert (_np(got[0])[:, 20:] == tvector.NEG_INF).all()


def test_flat_cosine_topk_filtered():
    rng = np.random.default_rng(3)
    N, D, B, k, cap = 4096, 32, 4, 16, 1500
    mat = _unit(rng, N, D)
    q = _unit(rng, B, D)
    row_doc = rng.integers(0, cap + 20, N).astype(np.int32)  # some past cap
    doc_mask = rng.random(cap) < 0.5
    valid = rng.random(N) < 0.95
    exp = jvector.flat_cosine_topk_filtered(
        jnp.asarray(q), jnp.asarray(mat, jnp.bfloat16), jnp.asarray(row_doc),
        jnp.asarray(doc_mask), jnp.asarray(valid), k=k, chunk=1024)
    got = tvector.flat_cosine_topk_filtered(
        _t(q), _t(mat).to(torch.bfloat16), _t(row_doc), _t(doc_mask),
        _t(valid), k=k, chunk=1024)
    assert_search_agrees(got, exp)


def test_quantize_rows_int8_is_exact():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(500, 48)).astype(np.float32)
    rows[3] = 0.0                                  # scale floor 1e-12
    rows[7, :4] = [127.5, -127.5, 0.5, -0.5]       # halves round to even
    eq, es = jvector.quantize_rows_int8(jnp.asarray(rows))
    tq, ts = tvector.quantize_rows_int8(_t(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _np(eq))
    np.testing.assert_array_equal(ts.numpy(), _np(es))


def _int8_corpus(rng, N, D, zero_frac=0.1):
    mat = _unit(rng, N, D)
    q8, sc = (t.numpy() for t in tvector.quantize_rows_int8(_t(mat)))
    sc = np.where(rng.random(N) < zero_frac, 0.0, sc).astype(np.float32)
    return q8, sc


@pytest.mark.parametrize("chunk", [1024, 8192])
def test_int8_scan_topk(chunk):
    rng = np.random.default_rng(5)
    N, D, B, k = 8192, 64, 4, 24
    q8, sc = _int8_corpus(rng, N, D)
    q = _unit(rng, B, D)
    exp = jvector.int8_scan_topk(jnp.asarray(q), jnp.asarray(q8),
                                 jnp.asarray(sc), k=k, chunk=chunk)
    got = tvector.int8_scan_topk(_t(q), _t(q8), _t(sc), k=k, chunk=chunk)
    assert_search_agrees(got, exp)


def _ivf_layout(rng, N, D, U, window):
    """A packed int8 layout with U units; the last unit starts so late
    that its clamped window overlaps the one before it."""
    q8, sc = _int8_corpus(rng, N, D)
    starts = np.sort(rng.choice(N - 1, U - 1, replace=False))
    starts = np.append(starts, N - window // 3).astype(np.int32)
    starts[-2] = N - window                          # overlaps the last
    cen = _unit(rng, U, D)
    return q8, sc, cen, starts


@pytest.mark.parametrize("nprobe", [3, 12])
def test_ivf_int8_topk(nprobe):
    rng = np.random.default_rng(6)
    N, D, B, U, window, k = 4096, 32, 6, 12, 256, 40
    q8, sc, cen, starts = _ivf_layout(rng, N, D, U, window)
    q = _unit(rng, B, D)
    args = (q, q8, sc, cen, starts)
    kw = dict(k=k, nprobe=nprobe, window=window)
    exp = jvector.ivf_int8_topk(*(jnp.asarray(a) for a in args), **kw)
    got = tvector.ivf_int8_topk(*(_t(a) for a in args), **kw)
    assert_search_agrees(got, exp)


def test_ivf_int8_overlapping_windows_return_the_same_duplicate_rows():
    """Two probed units whose clamped windows overlap: the overlap's rows
    come back twice, on both sides, slot for slot."""
    rng = np.random.default_rng(7)
    N, D, U, window, k = 2048, 16, 4, 512, 64
    q8, sc = _int8_corpus(rng, N, D, zero_frac=0.0)
    starts = np.array([0, 700, N - window, N - 100], np.int32)  # last clamps
    q = tvector.l2_normalize(q8[N - 200:N - 199].astype(np.float32))
    cen = np.stack([-q[0], -q[0], q[0], q[0]]).astype(np.float32)
    args = (q, q8, sc, cen, starts)
    kw = dict(k=k, nprobe=2, window=window)
    exp = jvector.ivf_int8_topk(*(jnp.asarray(a) for a in args), **kw)
    got = tvector.ivf_int8_topk(*(_t(a) for a in args), **kw)
    rows = _np(got[1])[0]
    assert len(np.unique(rows)) < len(rows)          # duplicates returned
    np.testing.assert_array_equal(rows, _np(exp[1])[0])
    np.testing.assert_allclose(_np(got[0]), _np(exp[0]), atol=ATOL)


@pytest.mark.parametrize("has_mask", [False, True])
def test_ivf_int8_topk_masked(has_mask):
    rng = np.random.default_rng(8)
    N, D, B, U, window, k, cap = 4096, 32, 5, 10, 512, 32, 3000
    q8, sc, cen, starts = _ivf_layout(rng, N, D, U, window)
    row_doc = rng.integers(0, cap + 30, N).astype(np.int32)
    mask = rng.random((B, cap)) < 0.4 if has_mask else np.ones((B, 1), bool)
    q = _unit(rng, B, D)
    args = (q, q8, sc, row_doc, cen, starts, mask)
    kw = dict(k=k, nprobe=4, window=window, has_mask=has_mask)
    exp = jvector.ivf_int8_topk_masked(*(jnp.asarray(a) for a in args), **kw)
    got = tvector.ivf_int8_topk_masked(*(_t(a) for a in args), **kw)
    assert_search_agrees(got, exp)


def test_ivf_scan_in_small_steps_is_the_same(monkeypatch):
    """Bounding the upcast tiles (one (query, probe) pair per step) does
    not change the result beyond f32 rounding (bmm may sum in another
    order at another batch size)."""
    rng = np.random.default_rng(9)
    N, D, B, U, window, k = 2048, 16, 3, 8, 256, 16
    q8, sc, cen, starts = _ivf_layout(rng, N, D, U, window)
    args = [_t(a) for a in (_unit(rng, B, D), q8, sc, cen, starts)]
    kw = dict(k=k, nprobe=5, window=window)
    whole = tvector.ivf_int8_topk(*args, **kw)
    monkeypatch.setattr(tvector, "_SCAN_ELEMS", 1)
    stepped = tvector.ivf_int8_topk(*args, **kw)
    assert_search_agrees(stepped, whole, atol=1e-6)


def test_top_centroids_and_ivf_gather_topk():
    rng = np.random.default_rng(10)
    N, D, B, C, rpp, k = 4096, 32, 4, 16, 256, 20
    mat = _unit(rng, N, D)
    valid = rng.random(N) < 0.9
    cen = _unit(rng, C, D)
    list_starts = (np.arange(C) * rpp).astype(np.int32)
    list_starts[-1] = N - rpp // 2   # read from a clamped start, as JAX
    q = _unit(rng, B, D)
    ev, ei = jvector.top_centroids(jnp.asarray(q), jnp.asarray(cen), nprobe=5)
    tv, ti = tvector.top_centroids(_t(q), _t(cen), nprobe=5)
    np.testing.assert_allclose(tv.numpy(), _np(ev), atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), _np(ei))
    probes = np.concatenate([_np(ei)[:, :4], np.full((B, 1), C - 1)], 1)
    probes = probes.astype(np.int32)
    exp = jvector.ivf_gather_topk(
        jnp.asarray(q), jnp.asarray(mat, jnp.bfloat16), jnp.asarray(valid),
        jnp.asarray(list_starts), jnp.asarray(probes), k=k, rows_per_probe=rpp)
    got = tvector.ivf_gather_topk(
        _t(q), _t(mat).to(torch.bfloat16), _t(valid), _t(list_starts),
        _t(probes), k=k, rows_per_probe=rpp)
    assert_search_agrees(got, exp)


def test_l2_normalize_is_the_jax_packages():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(7, 9)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_array_equal(tvector.l2_normalize(x),
                                  jvector.l2_normalize(x))
    np.testing.assert_array_equal(tvector.l2_normalize(x[0]),
                                  jvector.l2_normalize(x[0]))
