"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. Every test skips on a host without CUDA.

This file imports no jax, so it also runs where jax is not installed
(`tests/conftest.py` imports jax; skip it there):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from oramacore_tpu_torch import require_cuda

    require_cuda()
    return torch.device("cuda")


def _slab(rng, n, n_docs, dev):
    doc = torch.from_numpy(rng.integers(0, n_docs, n).astype(np.int32))
    tf = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32))
    flen = torch.from_numpy(rng.uniform(1, 50, n).astype(np.float32))
    return doc.to(dev), tf.to(dev), flen.to(dev)


@pytest.mark.parametrize("aligned", [True, False])
def test_score_windows_kernel(cuda, aligned):
    from oramacore_tpu_torch.ops import score_windows as sw

    rng = np.random.default_rng(0)
    n, w, ns = 1 << 20, 1024, 256
    doc, tf, flen = _slab(rng, n, 100_000, cuda)
    hi = n // 1024 if aligned else n  # some windows run past the end
    starts = rng.integers(0, hi, ns) * (1024 if aligned else 1)
    starts = torch.from_numpy(starts.astype(np.int32)).to(cuda)
    b = rng.uniform(0.3, 0.9, ns)
    params = torch.from_numpy(np.stack(
        [rng.uniform(0.5, 2, ns), 1 - b, b / rng.uniform(5, 40, ns),
         np.zeros(ns)], axis=1).astype(np.float32)).to(cuda)
    before = sw.LAUNCHES["score_windows"]
    docs, ntf = sw.score_windows(doc, tf, flen, starts, params, w=w)
    torch.cuda.synchronize()
    assert sw.LAUNCHES["score_windows"] == before + 1
    pdocs, pntf = sw.score_windows_plain(doc, tf, flen, starts, params, w)
    assert torch.equal(docs, pdocs)
    torch.testing.assert_close(ntf, pntf, rtol=1e-6, atol=0)


@pytest.mark.parametrize("exact", [False, True])
def test_score_ranges_accumulate_kernel(cuda, exact):
    """Long ranges span several blocks; empty ranges, tf == 0 slots and
    docs outside [0, cap) are dropped. Atomic adds reorder f32 sums."""
    from oramacore_tpu_torch.ops import score_windows as sw

    rng = np.random.default_rng(1)
    n, R, NR, cap = 1 << 22, 12, 5, 300_000
    doc, tf, flen = _slab(rng, n, cap + 1000, cuda)
    etf = torch.where(torch.rand(n, device=cuda) < 0.5, tf, 0.0)
    lens = rng.integers(0, 70_000, (R, NR))
    lens[0] = 0
    lens[1, 0] = 131072
    starts = rng.integers(0, n - 131072, (R, NR))
    desc = [torch.from_numpy(a).to(cuda) for a in (
        starts.astype(np.int32), lens.astype(np.int32),
        rng.uniform(0.5, 2, (R, NR)).astype(np.float32),
        rng.uniform(0.3, 0.9, (R, NR)).astype(np.float32),
        rng.uniform(5, 40, (R, NR)).astype(np.float32),
    )]
    acc = torch.zeros((R, cap), device=cuda)
    sw.score_ranges_accumulate(doc, tf, etf, flen, *desc, acc, exact=exact,
                               max_len=131072)
    torch.cuda.synchronize()
    ref = sw.score_ranges_accumulate_plain(
        doc, etf if exact else tf, flen, *desc, torch.zeros_like(acc)
    )
    assert torch.equal(acc > 0, ref > 0)
    torch.testing.assert_close(acc, ref, rtol=1e-5, atol=1e-6)
    # a low max_len hint only shrinks the grid: same result
    acc2 = torch.zeros_like(acc)
    sw.score_ranges_accumulate(doc, tf, etf, flen, *desc, acc2, exact=exact,
                               max_len=1)
    torch.testing.assert_close(acc2, ref, rtol=1e-5, atol=1e-6)


def test_score_ranges_accumulate_row_offset_past_2_pow_31(cuda):
    """row * cap passes 2^31 elements: the kernel's row offset is 64-bit."""
    from oramacore_tpu_torch.ops import score_windows as sw

    R, cap = 2100, 1 << 20  # 2100 * 2^20 > 2^31 (8.8 GB of f32)
    doc = torch.tensor([5, 7, cap - 1, 3], dtype=torch.int32, device=cuda)
    ones = torch.ones(4, device=cuda)
    starts = torch.zeros((R, 1), dtype=torch.int32, device=cuda)
    lens = torch.full((R, 1), 4, dtype=torch.int32, device=cuda)
    f = torch.ones((R, 1), device=cuda)
    acc = torch.zeros((R, cap), device=cuda)
    sw.score_ranges_accumulate(doc, ones, ones, ones, starts, lens, f,
                               torch.zeros_like(f), f, acc, exact=False,
                               max_len=4)
    torch.cuda.synchronize()
    assert acc[-1, cap - 1].item() == 1.0 and acc[-1, 5].item() == 1.0
    assert acc.sum().item() == 4 * R


def _ranges_case(rng, case, n):
    """(starts, lens, rows) of one edge case of the work-list kernel."""
    # rows_1024 has more pairs than a block's own work list takes, so the
    # kernel reads the one the work-list kernel writes
    R, NR = (1024, 5) if case == "rows_1024" else (16, 8)
    starts = rng.integers(0, n - 200_000, (R, NR))
    lens = rng.integers(1, 20_000, (R, NR))
    if case == "unaligned":      # every start off a 16-byte boundary
        starts = starts - starts % 4 + rng.integers(1, 4, (R, NR))
        lens[:, ::3] = rng.integers(1, 4, (R, (NR + 2) // 3))  # under a vector
    elif case == "empty":        # zero-length pairs, whole empty rows
        lens[rng.random((R, NR)) < 0.5] = 0
        lens[3] = 0
        lens[-1] = 0
    elif case == "slab_end":     # ranges that run past either end
        starts[:, 0] = n - rng.integers(1, 5000, R)
        starts[:, 1] = -rng.integers(1, 5000, R)
        starts[:, 2] = n - 4
    elif case == "long":         # one range of MAX_RANGE_LEN postings
        lens[2, 5] = 131072
    return starts, lens, R


@pytest.mark.parametrize("case", ["unaligned", "empty", "slab_end", "long",
                                  "rows_1024", "misaligned_slab"])
@pytest.mark.parametrize("exact", [False, True])
def test_score_ranges_accumulate_edge_cases(cuda, case, exact):
    """The work-list kernel against the plain version: the hit set
    exactly, values within rtol 1e-5 / atol 1e-6 (atomic sums reorder).
    `misaligned_slab` hands the kernel columns 4 bytes past a 16-byte
    boundary, so it takes its element-by-element loads."""
    from oramacore_tpu_torch.ops import score_windows as sw

    rng = np.random.default_rng(7)
    n, cap = (1 << 22) + 5, 1 << 20
    doc, tf, flen = _slab(rng, n + 1, cap + 1000, cuda)
    etf = torch.where(torch.rand(n + 1, device=cuda) < 0.5, tf, 0.0)
    if case == "misaligned_slab":
        doc, tf, etf, flen = (c[1:] for c in (doc, tf, etf, flen))
    else:
        doc, tf, etf, flen = (c[:n] for c in (doc, tf, etf, flen))
    starts, lens, R = _ranges_case(rng, case, n)
    NR = starts.shape[1]
    desc = [torch.from_numpy(a).to(cuda) for a in (
        starts.astype(np.int32), lens.astype(np.int32),
        rng.uniform(0.5, 2, (R, NR)).astype(np.float32),
        rng.uniform(0.3, 0.9, (R, NR)).astype(np.float32),
        rng.uniform(5, 40, (R, NR)).astype(np.float32),
    )]
    acc = torch.zeros((R, cap), device=cuda)
    before = sw.LAUNCHES["score_ranges_accumulate"]
    sw.score_ranges_accumulate(doc, tf, etf, flen, *desc, acc, exact=exact,
                               max_len=int(lens.max()))
    torch.cuda.synchronize()
    assert sw.LAUNCHES["score_ranges_accumulate"] == before + 1
    ref = sw.score_ranges_accumulate_plain(
        doc, etf if exact else tf, flen, *desc, torch.zeros_like(acc))
    assert torch.equal(acc > 0, ref > 0)
    assert torch.allclose(acc, ref, rtol=1e-5, atol=1e-6)
    assert ref.count_nonzero() > 0


def test_score_ranges_work_list_kernel(cuda):
    """The kernel's prologue writes the plain version's work list: the
    inclusive cumsum of tiles over the pairs in row-major order."""
    from oramacore_tpu_torch.ops import score_windows as sw

    rng = np.random.default_rng(8)
    for R, NR in ((1, 1), (64, 32), (1024, 32), (3, 1000)):
        starts = torch.from_numpy(
            rng.integers(-5, 1 << 22, (R, NR)).astype(np.int32)).to(cuda)
        lens = rng.integers(0, 131073, (R, NR))
        lens[rng.random((R, NR)) < 0.3] = 0
        lens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
        work = torch.full((R * NR,), -1, dtype=torch.int64, device=cuda)
        lib = sw.load_kernels()
        err = lib.score_ranges_work_list_launch(
            starts.data_ptr(), lens.data_ptr(), R * NR, work.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(work, sw.work_list_plain(starts, lens))


def test_wrapper_raises_instead_of_falling_back(cuda):
    from oramacore_tpu_torch.ops import score_windows as sw

    doc = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # one tensor left on the CPU
        sw.score_windows(doc, torch.zeros(8), torch.zeros(8, device=cuda),
                         torch.zeros(1, dtype=torch.int32, device=cuda),
                         torch.zeros((1, 4), device=cuda), w=4)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_gather_windows_kernel(cuda, dtype):
    """Aligned starts (the TPU contract), starts that are not multiples of
    4 (word-by-word chunks), windows across both ends of a slab whose
    length is not a multiple of 4: all equal to the plain version."""
    from oramacore_tpu_torch.ops import gather_windows as gw

    rng = np.random.default_rng(2)
    n, w = (1 << 20) + 1027, 2048
    src = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32))
    src = (src if dtype == torch.int32 else src.float() / 7).to(cuda)
    starts = np.concatenate([
        rng.integers(0, n // 1024, 200) * 1024,      # aligned
        rng.integers(0, n, 50),                       # any start
        [n - w + 1, n - 5, n - 1024 - 3, -1024, -3, n + 10, 0],
    ])
    starts = torch.from_numpy(starts.astype(np.int32)).to(cuda)
    before = gw.LAUNCHES["gather_windows"]
    got = gw.gather_windows(src, starts, w=w)
    torch.cuda.synchronize()
    assert gw.LAUNCHES["gather_windows"] == before + 1
    exp = gw.gather_windows_plain(src, starts, w)
    assert got.dtype == dtype and torch.equal(got, exp)
    assert not got[-2].any()  # a window wholly past the end reads 0


def test_gather_windows_refuses_a_misaligned_slab(cuda):
    from oramacore_tpu_torch.ops import gather_windows as gw

    src = torch.zeros(4096 + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError):  # 4 bytes past a 16-byte boundary
        gw.gather_windows(src, torch.zeros(1, dtype=torch.int32, device=cuda),
                          w=1024)


def _search_inputs(seed, B=4, T=3, NR=3, lr=256, cap=32768, n_post=20000):
    """Seeded inputs of the fused searches; scores and sort values repeat,
    so the tie rules decide the pages. Every doc has at most one posting
    in the slab, so no sum depends on the order of the atomic adds and
    ties are exact on both devices."""
    rng = np.random.default_rng(seed)
    n = n_post + lr
    slab = [np.zeros(n, np.int32)] + [np.zeros(n, np.float32)] * 3
    slab[0][:n_post] = rng.permutation(cap)[:n_post]
    slab[1] = slab[1].copy()
    slab[1][:n_post] = rng.integers(0, 3, n_post)
    slab[2] = slab[1].copy()
    slab[3] = slab[3].copy()
    slab[3][:n_post] = rng.choice([10.0, 20.0], n_post)
    idesc = np.stack([rng.integers(0, n_post - lr, (B, T, NR)),
                      rng.integers(0, lr + 1, (B, T, NR))]).astype(np.int32)
    fdesc = np.stack([np.ones((B, T, NR)), np.full((B, T, NR), 0.75),
                      np.full((B, T, NR), 15.0)]).astype(np.float32)
    scalars = np.stack([np.full(B, float(cap)),
                        np.array([0, 1, 0, 2][:B])]).astype(np.float32)
    svals = rng.integers(-3, 4, cap).astype(np.float32)
    svals[rng.random(cap) < 0.3] = -0.0
    svals[rng.random(cap) < 0.1] = np.nan
    gid = rng.integers(-1, 64, cap).astype(np.int32)
    mask = rng.random((B, cap)) < 0.7
    return [*slab, idesc, fdesc, scalars, mask], svals, gid, lr, cap


@pytest.mark.parametrize("desc", [True, False])
def test_sorted_and_grouped_searches_on_the_card_equal_the_cpu(cuda, desc):
    """The selections (torch.topk on int64 keys, stable sorts,
    searchsorted) order pages on the card exactly as on the CPU."""
    from oramacore_tpu_torch.ops import bm25

    args, svals, gid, lr, cap = _search_inputs(3)
    out = {}
    for dev in ("cpu", cuda):
        t = [torch.from_numpy(a).to(dev) for a in args]
        kw = dict(lr=lr, exact=False, cap=cap, has_mask=True, has_omc=False)
        srt = bm25.bm25_search_sorted_packed(
            *t, None, torch.from_numpy(svals).to(dev), k=512, desc=desc, **kw)
        grp = bm25.bm25_search_grouped_packed(
            *t, None, torch.from_numpy(gid).to(dev), k=16, R=8, G=64, **kw)
        out[str(dev)] = [x.cpu() for x in (*srt, *grp)]
    cpu, card = out["cpu"], out[str(cuda)]
    exact = (0, 1, 3, 4, 6, 9)    # docs1, vals1, docs2, valid2, counts (x2)
    for i in exact:
        assert torch.equal(card[i], cpu[i]), i
    for i in (2, 5, 7, 10):       # scores: atomic sums reorder
        torch.testing.assert_close(card[i], cpu[i], rtol=1e-5, atol=1e-6)
    fin = torch.isfinite(cpu[10])
    assert torch.equal(torch.isfinite(card[10]), fin)
    assert torch.equal(card[11][fin], cpu[11][fin])


def _near_tie_ok(vals, ids, evals, eids, rtol=1e-5):
    """ids equal except where a value ties a neighbour's (or is last)."""
    vals, evals = np.asarray(vals), np.asarray(evals)
    np.testing.assert_allclose(vals, evals, rtol=rtol, atol=1e-5)
    k = vals.shape[1]
    for b in range(vals.shape[0]):
        for i in np.nonzero(np.asarray(ids)[b] != np.asarray(eids)[b])[0]:
            assert i == k - 1 or any(
                abs(evals[b, i] - evals[b, j]) <= rtol * abs(evals[b, i])
                for j in (i - 1, i + 1) if 0 <= j < k), (b, i)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _both_devices(cuda, fn, *arrays):
    """fn on the CPU and on the card, from the same numpy inputs; outputs
    as CPU tensors."""
    outs = []
    for dev in ("cpu", cuda):
        out = fn(*_on(dev, *arrays))
        outs.append([o.cpu() for o in (out if isinstance(out, tuple) else (out,))])
    return outs


def test_vector_scans_on_the_card_equal_the_cpu(cuda):
    """Flat bf16 and IVF int8 scans at 64k rows x 384: the card's f32
    products (TF32 off) agree with the CPU's within f32 rounding."""
    from oramacore_tpu_torch.ops import vector as tv

    rng = np.random.default_rng(20)
    N, D, B, k, cap = 1 << 16, 384, 16, 64, 60_000
    rows = _unit(rng, N, D)
    q = _unit(rng, B, D)
    valid = rng.random(N) < 0.95
    cpu, card = _both_devices(
        cuda, lambda q, m, v: tv.flat_cosine_topk(
            q, m.to(torch.bfloat16), v, k=k, chunk=16384), q, rows, valid)
    _near_tie_ok(card[0], card[1], cpu[0], cpu[1])
    q8, sc = (t.numpy() for t in tv.quantize_rows_int8(torch.from_numpy(rows)))
    starts = np.sort(rng.choice(N - 2048, 64, replace=False)).astype(np.int32)
    cen = _unit(rng, 64, D)
    doc = rng.integers(0, cap, N).astype(np.int32)
    mask = rng.random((B, cap)) < 0.5
    cpu, card = _both_devices(
        cuda, lambda *a: tv.ivf_int8_topk_masked(
            *a, k=k, nprobe=8, window=2048, has_mask=True),
        q, q8, sc, doc, cen, starts, mask)
    _near_tie_ok(card[0], card[1], cpu[0], cpu[1])


@pytest.mark.parametrize("int8", [False, True])
def test_hybrid_on_the_card_equals_the_cpu(cuda, int8):
    """The fused hybrid search (the score_ranges_accumulate kernel on the
    card, the plain version on the CPU) and the shared tails."""
    from oramacore_tpu_torch.ops import hybrid as th
    from oramacore_tpu_torch.ops import vector as tv

    args, _, _, lr, cap = _search_inputs(21)
    B = args[6].shape[1]
    rng = np.random.default_rng(22)
    n_rows, D = 40_000, 64
    rows = _unit(rng, n_rows, D)
    doc = rng.integers(0, cap, n_rows).astype(np.int32)
    q = _unit(rng, B, D)
    sim = np.full(B, 0.1, np.float32)
    scalars = np.concatenate([args[6], sim[None]]).astype(np.float32)
    omc = rng.uniform(0.5, 2, cap).astype(np.float32)
    kw = dict(exact=False, cap=cap, k=16, has_mask=True, has_omc=True,
              has_rescale=False, rescale_lo=0.0, rescale_hi=1.0,
              with_bitmap=True)
    if int8:
        q8, sc = (t.numpy() for t in tv.quantize_rows_int8(torch.from_numpy(rows)))
        starts = np.sort(rng.choice(n_rows - 1, 32, replace=False)).astype(np.int32)
        vec = (q8, sc, doc, _unit(rng, 32, D), starts)
        fn = lambda *a: th.hybrid_search_topk_packed_int8(  # noqa: E731
            *a, lr=lr, V=128, nprobe=6, window=1024, **kw)
    else:
        valid = rng.random(n_rows) < 0.97
        vec = (rows, doc, valid)
        fn = lambda *a: th.hybrid_search_topk_packed(  # noqa: E731
            *a[:7], a[7].to(torch.bfloat16), *a[8:], lr=lr, **kw)
    cpu, card = _both_devices(cuda, fn, *args[:6], scalars, *vec, q,
                              args[7], omc)
    _near_tie_ok(card[0], card[1], cpu[0], cpu[1])
    assert torch.equal(card[2], cpu[2]) and torch.equal(card[3], cpu[3])
    assert cpu[2].min() > 0


def test_vector_index_ivf_build_on_the_card_equals_the_cpu(cuda):
    """k-means on the card (index_add_ atomics) against the CPU build:
    centroids within atol 1e-4, the same searches."""
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    rng = np.random.default_rng(23)
    centers = _unit(rng, 40, 64)
    vecs = centers[rng.integers(0, 40, 20_000)]
    vecs = vecs + 0.15 * rng.normal(size=vecs.shape).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        vidx = VectorIndex(VectorIndexConfig(dim=64), dev)
        for d in range(len(vecs)):
            vidx.insert(d, [vecs[d]])
        vidx.commit()
        flat = vidx.search([vecs[3], vecs[9]], limit=10, similarity=0.0)
        vidx._build_ivf()
        out[str(dev)] = (vidx._ivf, flat,
                         vidx.search([vecs[3]], limit=10, similarity=0.0))
    (ci, cf, cs), (gi, gf, gs) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(gi["unit_cen"], ci["unit_cen"], atol=1e-4)
    np.testing.assert_array_equal(gi["perm"], ci["perm"])
    for got, exp in ((gf, cf), (gs, cs)):
        assert set(got) == set(exp)
        assert all(abs(got[d] - exp[d]) <= 1e-5 for d in exp)
