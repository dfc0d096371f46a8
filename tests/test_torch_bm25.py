"""oramacore_tpu_torch.ops.bm25 / ops.vector against their JAX
counterparts on the same numpy inputs (CPU; the port's kernels run their
plain versions here).

Tolerances: scores rtol 1e-5 (the port sums per-doc ntf in another order
than the one-hot matmul / scatter); matched counts, match counts and
packed bits exact; top-k ids exact except between near-tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oramacore_tpu.ops import bm25 as jbm25
from oramacore_tpu.ops import vector as jvector
from oramacore_tpu_torch.ops import bm25 as tbm25
from oramacore_tpu_torch.ops import vector as tvector

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _near(a, b):
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


def assert_topk_agrees(vals, ids, evals, eids):
    """Values within RTOL; ids equal except at a near-tie: a position
    whose value ties a neighbour's, or the last one (it may tie a value
    just outside the page)."""
    vals, evals = np.asarray(vals), np.asarray(evals)
    ids, eids = np.asarray(ids), np.asarray(eids)
    np.testing.assert_allclose(vals, evals, rtol=RTOL)
    k = vals.shape[1]
    for b in range(vals.shape[0]):
        for i in np.nonzero(ids[b] != eids[b])[0]:
            tied = i == k - 1 or any(
                _near(evals[b, i], evals[b, j])
                for j in (i - 1, i + 1) if 0 <= j < k
            )
            assert tied, (b, i, ids[b], eids[b], evals[b])


def make_case(seed, *, B=4, T=3, NR=3, lr=256, cap=4096, n_post=6000,
              C=3, NC=2):
    rng = np.random.default_rng(seed)
    n = n_post + lr  # trailing zero pad: no window reads past the end
    doc = np.zeros(n, np.int32)
    tf = np.zeros(n, np.float32)
    etf = np.zeros(n, np.float32)
    flen = np.zeros(n, np.float32)
    doc[:n_post] = rng.integers(0, cap - 7, n_post)
    tf[:n_post] = rng.integers(0, 4, n_post)
    etf[:n_post] = np.where(rng.random(n_post) < 0.6, tf[:n_post], 0)
    flen[:n_post] = rng.integers(1, 60, n_post)
    c = dict(
        slab=(doc, tf, etf, flen), lr=lr, cap=cap,
        starts=rng.integers(0, n_post - lr, (B, T, NR)).astype(np.int32),
        lens=rng.integers(0, lr + 1, (B, T, NR)).astype(np.int32),
        weights=rng.uniform(0.5, 2.0, (B, T, NR)).astype(np.float32),
        field_b=rng.uniform(0.3, 0.9, (B, T, NR)).astype(np.float32),
        avg=rng.uniform(5, 40, (B, T, NR)).astype(np.float32),
        n_docs=rng.integers(cap // 2, 4 * cap, B).astype(np.float32),
        mask=rng.random((B, cap)) < 0.7,
        omc=rng.uniform(0.5, 2.0, cap).astype(np.float32),
        thr=rng.integers(0, 3, B).astype(np.float32),
        champs=(rng.random((C, cap)) * (rng.random((C, cap)) < 0.05)
                ).astype(np.float32),
        ch_idx=rng.integers(-1, C, (B, T, NC)).astype(np.int32),
        ch_w=rng.uniform(0.5, 2.0, (B, T, NC)).astype(np.float32),
    )
    c["lens"][0, 0, :] = 0  # a token with no postings
    return c


@pytest.mark.parametrize(
    "has_champ,use_mask,exact",
    [(False, False, False), (True, True, False), (True, False, True)],
)
def test_bm25_score_batch(has_champ, use_mask, exact):
    c = make_case(1)
    mask = c["mask"] if use_mask else np.ones_like(c["mask"])
    desc = [c[k] for k in ("starts", "lens", "weights", "field_b", "avg",
                           "n_docs")]
    champ = [c["champs"], c["ch_idx"], c["ch_w"]] if has_champ else []
    es, em = jbm25.bm25_score_batch(
        *(jnp.asarray(a) for a in (*c["slab"], *desc, mask, *champ)),
        lr=c["lr"], exact=exact, cap=c["cap"], has_champ=has_champ,
    )
    ts, tm = tbm25.bm25_score_batch(
        *(_t(a) for a in (*c["slab"], *desc)),
        _t(mask) if use_mask else None,
        *(_t(a) for a in champ),
        lr=c["lr"], exact=exact, cap=c["cap"], has_champ=has_champ,
    )
    np.testing.assert_array_equal(tm.numpy(), np.asarray(em))
    np.testing.assert_allclose(ts.numpy(), np.asarray(es), rtol=RTOL, atol=1e-6)
    assert np.asarray(em).max() >= 2  # multi-token matches exercised


@pytest.mark.parametrize(
    "cap,has_mask,has_omc,use_thr,has_champ,with_bitmap,exact",
    [
        (4096, False, False, False, False, False, False),
        (4096, True, True, True, True, True, False),
        (16384, True, False, True, True, True, True),   # two-level top-k
        (65536, False, True, False, False, True, False),  # scatter branch
    ],
)
def test_bm25_search_topk_packed(cap, has_mask, has_omc, use_thr,
                                 has_champ, with_bitmap, exact):
    c = make_case(2, cap=cap)
    B = c["starts"].shape[0]
    idesc = np.stack([c["starts"], c["lens"]])
    fdesc = np.stack([c["weights"], c["field_b"], c["avg"]])
    scalars = np.stack([c["n_docs"],
                        c["thr"] if use_thr else np.zeros(B, np.float32)])
    mask = c["mask"] if has_mask else np.zeros((1, 1), bool)
    omc = c["omc"] if has_omc else np.ones(1, np.float32)
    champ = [c["champs"], c["ch_idx"], c["ch_w"]] if has_champ else []
    kw = dict(lr=c["lr"], exact=exact, cap=cap, k=16, has_mask=has_mask,
              has_omc=has_omc, has_champ=has_champ, with_bitmap=with_bitmap)
    exp = jbm25.bm25_search_topk_packed(
        *(jnp.asarray(a) for a in (*c["slab"], idesc, fdesc, scalars, mask,
                                   omc, *champ)), **kw,
    )
    got = tbm25.bm25_search_topk_packed(
        *(_t(a) for a in (*c["slab"], idesc, fdesc, scalars)),
        _t(mask) if has_mask else None, _t(omc) if has_omc else None,
        *(_t(a) for a in champ), **kw,
    )
    assert len(got) == len(exp) == (4 if with_bitmap else 3)
    assert got[1].dtype == torch.int32
    assert_topk_agrees(got[0].numpy(), got[1].numpy(), exp[0], exp[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(exp[2]))
    assert np.asarray(exp[2]).min() > 0
    if with_bitmap:
        bits = got[3].numpy()
        assert bits.dtype == np.uint8 and bits.shape == (B, cap // 8)
        np.testing.assert_array_equal(bits, np.asarray(exp[3]))


def make_shared_case(seed, *, U=8, cu=4, NR=3, lr=256, B=6, T=3, cap=4096):
    c = make_case(seed, B=U, T=1, NR=NR, lr=lr, cap=cap)
    rng = np.random.default_rng(seed + 100)
    # slots hold a unique-token index, or the padding sentinel U
    c["token_map"] = rng.integers(0, U + 1, (B, T)).astype(np.int32)
    c["qmask"] = rng.random((B, cap)) < 0.6
    c["u"] = [c[k][:, 0] for k in ("starts", "lens", "weights", "field_b",
                                   "avg")]
    c["cu"] = cu
    c["B"] = B
    return c


@pytest.mark.parametrize("masked,exact", [(False, False), (True, True)])
def test_bm25_shared_partial(masked, exact):
    c = make_shared_case(3)
    B, cap = c["B"], c["cap"]
    s0 = np.random.default_rng(4).random((B, cap)).astype(np.float32)
    m0 = (np.random.default_rng(5).random((B, cap)) < 0.1).astype(np.float32)
    kw = dict(lr=c["lr"], cap=cap, cu=c["cu"], exact=exact)
    nd = 3000.0
    if masked:
        es, em = jbm25.bm25_shared_partial_masked(
            *(jnp.asarray(a) for a in (*c["slab"], *c["u"], c["token_map"],
                                       c["qmask"])),
            jnp.float32(nd), jnp.asarray(s0), jnp.asarray(m0), **kw,
        )
        ts, tm = tbm25.bm25_shared_partial_masked(
            *(_t(a) for a in (*c["slab"], *c["u"], c["token_map"],
                              c["qmask"])),
            nd, _t(s0.copy()), _t(m0.copy()), **kw,
        )
    else:
        es, em = jbm25.bm25_shared_partial(
            *(jnp.asarray(a) for a in (*c["slab"], *c["u"], c["token_map"])),
            jnp.float32(nd), jnp.asarray(s0), jnp.asarray(m0), **kw,
        )
        ts, tm = tbm25.bm25_shared_partial(
            *(_t(a) for a in (*c["slab"], *c["u"], c["token_map"])),
            nd, _t(s0.copy()), _t(m0.copy()), **kw,
        )
    np.testing.assert_array_equal(tm.numpy(), np.asarray(em))
    np.testing.assert_allclose(ts.numpy(), np.asarray(es), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_bm25_shared_champions(masked):
    rng = np.random.default_rng(6)
    B, T, U, NC, C, cap = 5, 3, 4, 2, 3, 4096
    champs = (rng.random((C, cap)) * (rng.random((C, cap)) < 0.1)
              ).astype(np.float32)
    ch_rows = rng.integers(-1, C, (U, NC)).astype(np.int32)
    ch_rows[:, 0] = np.arange(U) % C  # every entry has a row
    ch_w = rng.uniform(0.5, 2.0, (U, NC)).astype(np.float32)
    entry_token = np.array([0, 2, 5, 7], np.int32)
    token_map = rng.choice([-1, 0, 1, 2, 5, 7], (B, T)).astype(np.int32)
    qmask = rng.random((B, cap)) < 0.6
    s0 = np.zeros((B, cap), np.float32)
    args = [champs, ch_rows, ch_w, entry_token, token_map]
    if masked:
        es, em = jbm25.bm25_shared_champions_masked(
            *(jnp.asarray(a) for a in (*args, qmask)), jnp.float32(900.0),
            jnp.asarray(s0), jnp.asarray(s0), cap=cap,
        )
        ts, tm = tbm25.bm25_shared_champions_masked(
            *(_t(a) for a in (*args, qmask)), 900.0, _t(s0.copy()),
            _t(s0.copy()),
        )
    else:
        es, em = jbm25.bm25_shared_champions(
            *(jnp.asarray(a) for a in args), jnp.float32(900.0),
            jnp.asarray(s0), jnp.asarray(s0), cap=cap,
        )
        ts, tm = tbm25.bm25_shared_champions(
            *(_t(a) for a in args), 900.0, _t(s0.copy()), _t(s0.copy()),
        )
    np.testing.assert_array_equal(tm.numpy(), np.asarray(em))
    np.testing.assert_allclose(ts.numpy(), np.asarray(es), rtol=RTOL, atol=1e-6)
    assert np.asarray(em).max() >= 1


def test_champion_acc_ignores_empty_slots():
    """A -1 slot must weigh nothing, not read the last champion row."""
    champs = torch.tensor([[1.0, 0.0], [0.0, 5.0]])
    acc = tbm25._champion_acc(
        champs, torch.tensor([[0, -1]], dtype=torch.int32),
        torch.tensor([[2.0, 3.0]]),
    )
    assert acc.tolist() == [[2.0, 0.0]]


@pytest.mark.parametrize("cap", [4096, 16384])
def test_finalize_topk(cap):
    rng = np.random.default_rng(cap)
    B = 4
    scores = (rng.random((B, cap)) * (rng.random((B, cap)) < 0.3)
              ).astype(np.float32)
    matched = rng.integers(0, 4, (B, cap)).astype(np.float32)
    thr = np.array([0, 1, 2, 3], np.float32)
    omc = rng.uniform(0.5, 2.0, cap).astype(np.float32)
    exp = jbm25.finalize_topk(
        *(jnp.asarray(a) for a in (scores, matched, thr, omc)), k=16
    )
    got = tbm25.finalize_topk(*(_t(a) for a in (scores, matched, thr, omc)),
                              k=16)
    assert_topk_agrees(got[0].numpy(), got[1].numpy(), exp[0], exp[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(exp[2]))


@pytest.mark.parametrize("n", [1000, 32768])
def test_topk_2level_tie_order(n):
    """Heavy ties (integer scores): ids must equal lax.top_k's exactly —
    lower index first below 16384 lanes, group rank then position above."""
    rng = np.random.default_rng(n)
    s = rng.integers(0, 6, (3, n)).astype(np.float32)
    s[0, :] = 5.0  # all tied
    s[1, ::2] = -np.inf
    ev, ei = jvector.topk_2level(jnp.asarray(s), 16)
    tv, ti = tvector.topk_2level(_t(s), 16)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ei))


def test_postings_device_from_numpy_pads():
    arrays4 = (np.array([3, 1], np.int32), np.array([1, 2], np.float32),
               np.array([1, 0], np.float32), np.array([4, 5], np.float32))
    slab = tbm25.PostingsDevice.from_numpy(arrays4, "cpu", pad=3)
    assert [t.dtype for t in slab] == [torch.int32] + [torch.float32] * 3
    assert slab.doc.tolist() == [3, 1, 0, 0, 0]
    assert slab.flen.tolist() == [4.0, 5.0, 0.0, 0.0, 0.0]
    assert tbm25.PostingsDevice.from_numpy(arrays4, "cpu").doc.shape[0] == (
        2 + tbm25.MAX_RANGE_LEN
    )
