"""The port's score_windows / score_ranges_accumulate (plain versions on
the CPU) against the JAX package on the same numpy inputs."""

import numpy as np
import pytest
import torch


def _slab(rng, n, n_docs):
    p_doc = rng.integers(0, n_docs, n).astype(np.int32)
    p_tf = rng.integers(0, 4, n).astype(np.float32)  # tf == 0 slots included
    p_flen = rng.uniform(1, 50, n).astype(np.float32)
    return p_doc, p_tf, p_flen


@pytest.mark.parametrize("aligned", [True, False])
def test_score_windows_matches_pallas_interpret(monkeypatch, aligned):
    """Same windows through the Pallas kernel (interpret mode) and the
    port; unaligned starts only exist on the port's side, so they are held
    against the kernel's numpy oracle."""
    import jax
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)

    from oramacore_tpu.ops import pallas_score
    from oramacore_tpu_torch.ops.score_windows import score_windows

    rng = np.random.default_rng(1)
    P, W, NS = 1 << 15, 1024, 16
    p_doc, p_tf, p_flen = _slab(rng, P + W, 5000)
    if aligned:
        starts = (rng.integers(0, P // 1024, NS) * 1024).astype(np.int32)
    else:
        starts = rng.integers(0, P, NS).astype(np.int32)
    b = rng.uniform(0.3, 0.9, NS)
    avg = rng.uniform(5, 40, NS)
    params = np.stack([
        rng.uniform(0.5, 2.0, NS), 1.0 - b, b / avg, np.zeros(NS),
    ], axis=1).astype(np.float32)

    if aligned:
        exp_docs, exp_ntf = pallas_score.score_windows(
            jax.numpy.asarray(p_doc), jax.numpy.asarray(p_tf),
            jax.numpy.asarray(p_flen), jax.numpy.asarray(starts),
            jax.numpy.asarray(params), w=W, rows_per_program=8,
        )
    else:
        exp_docs, exp_ntf = pallas_score.host_score_windows(
            p_doc, p_tf, p_flen, starts, params, W
        )
    docs, ntf = score_windows(
        torch.from_numpy(p_doc), torch.from_numpy(p_tf),
        torch.from_numpy(p_flen), torch.from_numpy(starts),
        torch.from_numpy(params), w=W,
    )
    np.testing.assert_array_equal(docs.numpy(), np.asarray(exp_docs))
    np.testing.assert_allclose(ntf.numpy(), np.asarray(exp_ntf), rtol=1e-6)


def test_score_windows_outside_slab_reads_zero():
    from oramacore_tpu_torch.ops.score_windows import score_windows

    p_doc = torch.arange(1, 9, dtype=torch.int32)
    p_tf = torch.ones(8)
    p_flen = torch.ones(8)
    params = torch.tensor([[1.0, 0.25, 0.75, 0.0]])
    docs, ntf = score_windows(p_doc, p_tf, p_flen,
                              torch.tensor([6], dtype=torch.int32), params, w=4)
    assert docs.tolist() == [[7, 8, 0, 0]]
    assert ntf.tolist() == [[1.0, 1.0, 0.0, 0.0]]


def _jax_dense_acc(p_doc, p_tf, p_flen, starts, lens, wt, fb, av, cap, lr):
    """JAX reference: the window gather + ntf of bm25_shared_partial
    (oramacore_tpu/ops/bm25.py:557-567), then its _aggregate_dense."""
    import jax
    import jax.numpy as jnp

    from oramacore_tpu.ops.bm25 import _aggregate_dense

    R, NR = starts.shape
    pd, pt, pf = (jnp.asarray(a) for a in (p_doc, p_tf, p_flen))
    flat = jnp.asarray(starts.reshape(-1))
    d = jax.vmap(lambda s: jax.lax.dynamic_slice(pd, (s,), (lr,)))(flat)
    t = jax.vmap(lambda s: jax.lax.dynamic_slice(pt, (s,), (lr,)))(flat)
    f = jax.vmap(lambda s: jax.lax.dynamic_slice(pf, (s,), (lr,)))(flat)
    d, t, f = (x.reshape(R, NR, lr) for x in (d, t, f))
    slot = jnp.arange(lr)[None, None, :]
    b_ = jnp.asarray(fb)[:, :, None]
    denom = (1.0 - b_) + b_ * f / jnp.maximum(jnp.asarray(av)[:, :, None], 1e-9)
    ntf = jnp.asarray(wt)[:, :, None] * t / jnp.maximum(denom, 1e-9)
    keep = (slot < jnp.asarray(lens)[:, :, None]) & (t > 0)
    ntf = jnp.where(keep, ntf, 0.0)
    d = jnp.where(keep, d, cap)
    return np.asarray(
        _aggregate_dense(d.reshape(R, NR * lr), ntf.reshape(R, NR * lr), cap)
    )


@pytest.mark.parametrize(
    "cap,exact",
    [(4096, False), (32768, True), (65536, False)],
    ids=["onehot-small", "onehot-max-exact", "scatter"],
)
def test_score_ranges_accumulate_matches_aggregate_dense(cap, exact):
    """Both _aggregate_dense branches: one-hot matmul (cap <= 32768) and
    scatter-add (cap > 32768). Sums are reordered, so scores compare at
    rtol 1e-5 / atol 1e-6 and the set of hit docs exactly."""
    from oramacore_tpu_torch.ops.score_windows import score_ranges_accumulate

    rng = np.random.default_rng(cap + exact)
    R, NR, LR = 6, 4, 512
    P = 20000
    p_doc, p_tf, p_flen = _slab(rng, P + LR, cap)
    p_etf = np.where(rng.random(P + LR) < 0.5, p_tf, 0).astype(np.float32)
    starts = rng.integers(0, P, (R, NR)).astype(np.int32)
    lens = rng.integers(0, LR + 1, (R, NR)).astype(np.int32)
    lens[0, :] = 0  # an empty row
    wt = rng.uniform(0.5, 2.0, (R, NR)).astype(np.float32)
    fb = rng.uniform(0.3, 0.9, (R, NR)).astype(np.float32)
    av = rng.uniform(5, 40, (R, NR)).astype(np.float32)
    exp = _jax_dense_acc(
        p_doc, p_etf if exact else p_tf, p_flen, starts, lens, wt, fb, av,
        cap, LR,
    )
    acc = torch.zeros((R, cap))
    out = score_ranges_accumulate(
        *(torch.from_numpy(a) for a in (p_doc, p_tf, p_etf, p_flen,
                                         starts, lens, wt, fb, av)),
        acc, exact=exact, max_len=LR,
    )
    assert out is acc
    got = acc.numpy()
    np.testing.assert_array_equal(got > 0, exp > 0)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_score_ranges_accumulate_drops_docs_outside_cap():
    from oramacore_tpu_torch.ops.score_windows import score_ranges_accumulate

    p_doc = torch.tensor([0, 3, 5, 9], dtype=torch.int32)
    ones = torch.ones(4)
    acc = torch.zeros((1, 6))
    score_ranges_accumulate(
        p_doc, ones, ones, ones,
        torch.tensor([[0]], dtype=torch.int32),
        torch.tensor([[4]], dtype=torch.int32),
        torch.ones((1, 1)), torch.zeros((1, 1)), torch.ones((1, 1)),
        acc, exact=False, max_len=4,
    )
    assert acc.tolist() == [[1.0, 0.0, 0.0, 1.0, 0.0, 1.0]]


def _ranges(seed, R, NR, n):
    rng = np.random.default_rng(seed)
    starts = rng.integers(-9, n, (R, NR))
    lens = rng.integers(0, 3 * 4096 * 4, (R, NR))    # up to 12 tiles
    lens[rng.random((R, NR)) < 0.3] = 0
    lens[:, 0] = rng.integers(1, 4, R)                # under one vector
    return (torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


@pytest.mark.parametrize("R,NR", [(1, 1), (7, 5), (64, 32)])
def test_work_list_covers_every_posting_once_in_row_major_order(R, NR):
    """The kernel's walk (`work_items_plain`): each pair's postings are
    covered exactly once by its tiles, in order; pairs come in row-major
    order; a pair with len == 0 has no tile."""
    from oramacore_tpu_torch.ops.score_windows import (
        TILE_VECS,
        work_items_plain,
        work_list_plain,
    )

    starts, lens = _ranges(R * NR, R, NR, 1 << 20)
    cum = work_list_plain(starts, lens)
    pair, lo, hi = work_items_plain(starts, lens)
    assert cum.shape == (R * NR,) and len(pair) == int(cum[-1])
    assert bool((pair[1:] >= pair[:-1]).all())          # row-major order
    assert bool((hi > lo).all() and (hi - lo <= 4 * TILE_VECS).all())
    s, n = starts.reshape(-1).long(), lens.reshape(-1).long()
    for p in range(R * NR):
        mine = pair == p
        if n[p] == 0:
            assert not mine.any()
            continue
        plo, phi = lo[mine], hi[mine]
        assert plo[0] == s[p] and phi[-1] == s[p] + n[p]
        assert torch.equal(plo[1:], phi[:-1])          # contiguous, disjoint
        assert bool(((plo[1:] - (s[p] - (s[p] & 3))) % (4 * TILE_VECS) == 0).all())


def test_work_list_walk_equals_the_plain_version():
    """Accumulating tile by tile along the work list, as the kernel does,
    gives the plain version's acc."""
    from oramacore_tpu_torch.ops.score_windows import (
        score_ranges_accumulate_plain,
        work_items_plain,
    )

    rng = np.random.default_rng(11)
    n, cap, R, NR = 1 << 16, 5000, 5, 6
    p_doc, p_tf, p_flen = (torch.from_numpy(a) for a in _slab(rng, n, cap + 50))
    starts, lens = _ranges(12, R, NR, n)
    lens = lens.clamp(max=20000)
    wt, fb, av = (torch.from_numpy(rng.uniform(lo, hi, (R, NR)).astype(np.float32))
                  for lo, hi in ((0.5, 2), (0.3, 0.9), (5, 40)))
    exp = score_ranges_accumulate_plain(p_doc, p_tf, p_flen, starts, lens,
                                        wt, fb, av, torch.zeros((R, cap)))
    got = torch.zeros((R, cap))
    pair, lo, hi = work_items_plain(starts, lens)
    for p, a, b in zip(pair.tolist(), lo.tolist(), hi.tolist()):
        r, j = divmod(p, NR)
        one = lambda t: t[r:r + 1, j:j + 1].contiguous()  # noqa: E731
        score_ranges_accumulate_plain(
            p_doc, p_tf, p_flen, torch.tensor([[a]], dtype=torch.int32),
            torch.tensor([[b - a]], dtype=torch.int32), one(wt), one(fb),
            one(av), got[r:r + 1])
    assert torch.equal(got > 0, exp > 0)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-6)


def test_wrappers_check_their_inputs():
    from oramacore_tpu_torch.ops.score_windows import (
        LAUNCHES,
        score_ranges_accumulate,
        score_windows,
    )

    i32 = torch.zeros(8, dtype=torch.int32)
    f32 = torch.zeros(8)
    with pytest.raises(TypeError):
        score_windows(f32, f32, f32, torch.zeros(1, dtype=torch.int32),
                      torch.zeros((1, 4)), w=4)
    with pytest.raises(ValueError):
        score_windows(i32, f32, f32, torch.zeros(1, dtype=torch.int32),
                      torch.zeros((2, 4)), w=4)
    rng2 = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):  # acc rows != R
        score_ranges_accumulate(
            i32, f32, f32, f32, rng2, rng2, torch.zeros((2, 3)),
            torch.zeros((2, 3)), torch.ones((2, 3)), torch.zeros((3, 8)),
            exact=False, max_len=1,
        )
    with pytest.raises(ValueError):  # non-contiguous
        score_ranges_accumulate(
            i32, f32, f32, f32, rng2, rng2, torch.zeros((3, 2)).T,
            torch.zeros((2, 3)), torch.ones((2, 3)), torch.zeros((2, 8)),
            exact=False, max_len=1,
        )
    # the plain versions never count as kernel launches
    assert LAUNCHES == {"score_windows": 0, "score_ranges_accumulate": 0}
