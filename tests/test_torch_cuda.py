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


def _term_slab(rng, n_terms, n_docs, dev, max_df=30_000):
    """A slab of doc-sorted per-term ranges (distinct docs per term), tf
    in {1, 2, 3} with an exact tf that is sometimes 0, flen in [5, 50):
    (doc, tf, etf, flen) on `dev`, and each term's (start, len)."""
    dfs = rng.integers(1, max_df, n_terms)
    docs = [np.sort(rng.choice(n_docs, int(d), replace=False)) for d in dfs]
    doc = np.concatenate(docs).astype(np.int32)
    n = len(doc)
    tf = rng.integers(1, 4, n).astype(np.float32)
    etf = np.where(rng.random(n) < 0.7, tf, 0).astype(np.float32)
    flen = rng.uniform(5, 50, n).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(dfs)[:-1]])
    ranges = list(zip(starts.tolist(), dfs.tolist()))
    cols = [torch.from_numpy(a).to(dev) for a in (doc, tf, etf, flen)]
    return cols, ranges


def _candidates(rng, B, C, n_docs, n_real):
    """int32[B, C] ascending: n_real distinct docs, then n_docs (cap)."""
    cand = np.full((B, C), n_docs, np.int32)
    for b in range(B):
        cand[b, :n_real] = np.sort(rng.choice(n_docs, n_real, replace=False))
    return cand


def _boff(corpus, st, ln, capb, span=4):
    """Bucket-offset tables as search_exec._pruned_bs_boff builds them:
    (flat, base, shift, steps); flat[0:2] is the empty-range row."""
    p_doc = corpus["p_doc"]
    full = capb.bit_length() - 1
    rows, total, spans = [np.zeros(2, np.int32)], 2, {}
    base = np.zeros(st.shape, np.int32)
    shift = np.full(st.shape, full, np.int32)
    max_span = 1
    for i in np.ndindex(st.shape):
        s0, n = int(st[i]), int(ln[i])
        if n <= 0:
            continue
        if (s0, n) not in spans:
            sh = full
            while sh > 0 and (n << sh) > capb * span:
                sh -= 1
            K = max(capb >> sh, 1)
            row = np.empty(K + 1, np.int32)
            row[0], row[K] = 0, n
            row[1:K] = np.searchsorted(p_doc[s0:s0 + n],
                                       np.arange(1, K, dtype=np.int64) << sh)
            spans[(s0, n)] = (total, sh, int(np.diff(row).max()))
            rows.append(row)
            total += K + 1
        base[i], shift[i], ms = spans[(s0, n)]
        max_span = max(max_span, ms)
    flat = np.concatenate(rows)
    buf = np.zeros(1 << int(np.ceil(np.log2(len(flat) + 1))), np.int32)
    buf[:len(flat)] = flat
    steps = 4
    while (1 << steps) < max_span + 1:
        steps += 4
    return buf, base, shift, steps


@pytest.mark.parametrize("with_boff", [False, True])
def test_rescore_bsearch_kernel(cuda, with_boff):
    """Empty ranges, ranges that end the slab, cap sentinels and NR=2
    pieces: the kernel against its plain version on the card (the same
    summation order: scores within rtol 1e-6, matched exact)."""
    from oramacore_tpu_torch.ops import pruned as pr

    rng = np.random.default_rng(30)
    n_docs, B, T, NR, C = 200_000, 8, 3, 2, 1024
    (doc, tf, _etf, flen), ranges = _term_slab(rng, 40, n_docs, cuda)
    n = doc.shape[0]
    st = np.zeros((B, T, NR), np.int32)
    ln = np.zeros((B, T, NR), np.int32)
    for b in range(B):
        for t in range(T):
            s, d = ranges[int(rng.integers(0, len(ranges)))]
            half = d // 2
            st[b, t] = (s, s + half)
            ln[b, t] = (half, d - half)
    ln[1, 2] = 0                                       # an empty token
    st[2, 0], ln[2, 0] = (ranges[-1][0], ranges[-1][0] + ranges[-1][1] // 2), \
        (ranges[-1][1] // 2, ranges[-1][1] - ranges[-1][1] // 2)  # slab end
    assert st[2, 0, 1] + ln[2, 0, 1] == n
    cand = _candidates(rng, B, C, n_docs, 900)
    cand[3] = n_docs                                   # only sentinels
    # half of each query's candidates are docs of its ranges: many hits
    for b in range(B):
        s, d = int(st[b, 0, 0]), int(ln[b, 0, 0])
        if d:
            own = doc[s:s + d].cpu().numpy()[:450]
            rest = np.setdiff1d(cand[b, :900], own)[:900 - len(own)]
            cand[b] = n_docs
            cand[b, :len(own) + len(rest)] = np.sort(np.concatenate([own, rest]))
    cand[3] = n_docs
    idf = rng.uniform(0.5, 5, (B, T)).astype(np.float32)
    desc = [torch.from_numpy(a).to(cuda) for a in (
        st, ln, rng.uniform(0.5, 2, (B, T, NR)).astype(np.float32),
        rng.uniform(0.3, 0.9, (B, T, NR)).astype(np.float32),
        rng.uniform(10, 40, (B, T, NR)).astype(np.float32), idf, cand)]
    steps = 16
    boff = None
    if with_boff:
        corpus = {"p_doc": doc.cpu().numpy()}
        flat, base, shift, steps = _boff(corpus, st, ln, 1 << 18, span=16)
        boff = tuple(torch.from_numpy(a).to(cuda) for a in (flat, base, shift))
    before = pr.LAUNCHES["rescore_bsearch"]
    s, m = pr.rescore_bsearch(doc, tf, flen, *desc, bs_steps=steps, boff=boff)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["rescore_bsearch"] == before + 1
    ps, pm = pr.rescore_bsearch_plain(doc, tf, flen, *desc, bs_steps=steps,
                                      boff=boff)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=1e-6)
    assert pm.sum() > 1000 and not pm[3].any()


BS_CARD_CASES = ["one_round_windows", "two_round_windows", "no_tables_deep",
                 "odd_pairs", "many_searches", "misaligned_slab",
                 "skewed_buckets"]


@pytest.mark.parametrize("case", BS_CARD_CASES)
def test_rescore_bsearch_kernel_windows(cuda, case):
    """The window reads of rescore_bsearch against its plain version
    (scores within rtol 1e-6, matched exact, one launch). A first range
    of consecutive docs at a start 3 postings past a 16-byte boundary
    gives bucket windows of exactly 16 postings (`one_round_windows`: 19
    from the boundary, one round of int4 loads) or 32 (`two_round_windows`:
    probe rounds); `no_tables_deep` searches whole ranges of up to 60k
    postings (bs_steps 16, no tables); `odd_pairs` has B * C = 6,993 pairs,
    not a multiple of a block's 17; `many_searches` has T * NR = 320
    searches a pair, more than a block's threads; `misaligned_slab` gives
    p_doc 4 bytes past a 16-byte boundary, so windows load one by one;
    `skewed_buckets` packs each 64-doc bucket's 20 docs at its end, so the
    chunk read at the even-spread guess misses on either side. An empty
    token and a row of sentinels in every case."""
    from oramacore_tpu_torch.ops import pruned as pr

    rng = np.random.default_rng(33)
    n_docs, capb = 100_000, 1 << 17
    B, T, NR, C = dict(odd_pairs=(7, 5, 3, 999),
                       many_searches=(2, 20, 16, 64)).get(case, (6, 3, 2, 512))
    lead = 3 if case != "misaligned_slab" else 4
    first = np.arange(4096, dtype=np.int32)
    if case == "skewed_buckets":
        first = (64 * np.arange(200)[:, None] + 44 + np.arange(20)).astype(
            np.int32).ravel()
    parts = [np.zeros(lead, np.int32), first]
    parts += [np.sort(rng.choice(n_docs, int(d), replace=False)).astype(np.int32)
              for d in rng.integers(1000, 60_000, 8)]
    doc_np = np.concatenate(parts)
    starts = np.cumsum([0] + [len(p) for p in parts])[:-1]
    ranges = list(zip(starts[1:].tolist(), [len(p) for p in parts[1:]]))
    n = len(doc_np)
    cols = [torch.from_numpy(a).to(cuda) for a in (
        doc_np, rng.integers(1, 4, n).astype(np.float32),
        rng.uniform(5, 50, n).astype(np.float32))]
    if case == "misaligned_slab":   # drop one posting: every range moves back
        cols = [c[1:] for c in cols]
        doc_np = doc_np[1:]
        ranges = [(s - 1, d) for s, d in ranges]
    doc, tf, flen = cols
    st = np.zeros((B, T, NR), np.int32)
    ln = np.zeros((B, T, NR), np.int32)
    for i in np.ndindex(B, T, NR):
        s, d = ranges[0] if i[2] == 0 else ranges[int(rng.integers(1, len(ranges)))]
        st[i], ln[i] = s, d
    ln[1, T - 1] = 0                                   # an empty token
    cand = _candidates(rng, B, C, n_docs, C - 7)
    cand[:, : C // 4] = rng.choice(int(first[-1]) + 20, (B, C // 4))  # range 0
    cand = np.sort(cand, axis=1)
    cand[B - 1] = n_docs                               # only sentinels
    idf = rng.uniform(0.5, 5, (B, T)).astype(np.float32)
    desc = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        st, ln, rng.uniform(0.5, 2, (B, T, NR)).astype(np.float32),
        rng.uniform(0.3, 0.9, (B, T, NR)).astype(np.float32),
        rng.uniform(10, 40, (B, T, NR)).astype(np.float32), idf, cand)]
    steps, boff = 16, None
    if case != "no_tables_deep":
        # range 0 holds docs 0..4095: buckets of 2^shift docs hold 2^shift
        # postings; span 0.5 gives shift 4 there, span 1 shift 5 (and the
        # skewed range's 4,000 docs shift 6 at span 2)
        span, sh0 = dict(two_round_windows=(1.0, 5),
                         skewed_buckets=(2.0, 6)).get(case, (0.5, 4))
        flat, base, shift, steps = _boff({"p_doc": doc_np}, st, ln, capb, span)
        assert (shift[..., 0][ln[..., 0] > 0] == sh0).all()
        boff = tuple(torch.from_numpy(a).to(cuda) for a in (flat, base, shift))
    before = pr.LAUNCHES["rescore_bsearch"]
    s, m = pr.rescore_bsearch(doc, tf, flen, *desc, bs_steps=steps, boff=boff)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["rescore_bsearch"] == before + 1
    ps, pm = pr.rescore_bsearch_plain(doc, tf, flen, *desc, bs_steps=steps,
                                      boff=boff)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=1e-6)
    assert pm[: B - 1].sum() > B and not pm[B - 1].any()


WL_CARD_CASES = ["plain", "fmask", "exact", "nre", "filter_selects_nothing",
                 "slab_end", "large_c", "tile_edges", "small_c", "fbits",
                 "fbits_nre_exact", "misaligned_slab"]


@pytest.mark.parametrize("case", WL_CARD_CASES)
def test_rescore_worklist_kernel(cuda, case):
    """The worklist kernel against its plain version on the card: scores
    within rtol 1e-5 / atol 1e-6 (atomic adds reorder the sums), matched
    exact. Padding entries, repeated and sentinel candidates in every
    case; `slab_end` puts entries within lch of the slab's end (the start
    clamps, as JAX's dynamic_slice does); `large_c` needs more than 48 KB
    of shared memory for the candidate table, `small_c` has C = 8;
    `tile_edges` adds entries of 1, TILE - 1, TILE, TILE + 1 and lch
    postings at every 16-byte offset; the `fbits` cases hand the kernel
    the filter's bitmap (the plain version reads the f32 mask);
    `misaligned_slab` gives columns 4 bytes past a 16-byte boundary, so
    postings load one by one."""
    from oramacore_tpu_torch.ops import pruned as pr

    rng = np.random.default_rng(31)
    n_docs, B, T = 100_000, 6, 3
    lch = 8192 if case == "tile_edges" else 4096
    C = {"large_c": 16384, "small_c": 8}.get(case, 1024)
    (doc, tf, etf, flen), ranges = _term_slab(rng, 30, n_docs, cuda)
    if case == "misaligned_slab":
        doc, tf, etf, flen = (c[1:] for c in (doc, tf, etf, flen))
        ranges = [(s - 1, d) for s, d in ranges[1:]]
    n = doc.shape[0]
    tf_src = etf if case in ("exact", "fbits_nre_exact") else tf
    two = case in ("nre", "fbits_nre_exact")
    wl, prev = [], []
    for b in range(B):
        for t in range(T):
            picks = [ranges[int(rng.integers(0, len(ranges)))]
                     for _ in range(2 if two else 1)]
            for k, (s, d) in enumerate(picks):
                for off in range(0, d, lch):
                    wl.append((b, t, s + off, min(lch, d - off)))
                    prev.append(picks[:k])
    if case == "slab_end":
        wl += [(0, 0, n - 100, 100), (1, 1, n - lch + 7, lch - 7)]
        prev += [[], []]
    if case == "tile_edges":
        tile = pr.TILE_POSTINGS
        for k, ln in enumerate([1, tile - 1, tile, tile + 1, lch] * 4):
            wl.append((k % B, k % T, 1000 + 9000 * k + k % 4, ln))
            prev.append([])
    W = -(-len(wl) // 128) * 128 + 128                 # padding entries
    wl_i = np.zeros((4, W), np.int32)
    wl_i[:, :len(wl)] = np.array(wl, np.int32).T
    wl_f = np.stack([rng.uniform(0.5, 2, W), rng.uniform(0.3, 0.9, W),
                     np.full(W, 27.5)]).astype(np.float32)
    nre = 1 if two else 0
    wl_prev = None
    if nre:
        wl_prev = np.zeros((2, W, 1), np.int32)
        for j, p in enumerate(prev):
            if p:
                wl_prev[:, j, 0] = p[0]
        wl_prev = torch.from_numpy(wl_prev).to(cuda)
    cand = _candidates(rng, B, C, n_docs, max(C // 2, min(C - 40, n_docs // 4)))
    if C > 20:
        cand[0, 10:20] = cand[0, 10]                   # repeated ids
    cand = np.sort(cand, axis=1)
    fmask = fbits = None
    if case in ("fmask", "filter_selects_nothing", "fbits", "fbits_nre_exact"):
        keep = rng.random(n_docs) < (0.0 if case == "filter_selects_nothing"
                                     else 0.5)
        fmask = torch.from_numpy(keep.astype(np.float32)).to(cuda)
        if case.startswith("fbits"):
            fbits = pr.pack_mask_bits(fmask)
    args = [doc, tf_src, flen] + [torch.from_numpy(a).to(cuda) for a in (
        wl_i, wl_f, np.full(B, float(n_docs), np.float32), cand)]
    kw = dict(lch=lch, T=T, nre=nre, bs_steps=16 if nre else 0)
    before = pr.LAUNCHES["rescore_worklist"]
    s, m = pr.rescore_worklist(*args, wl_prev, fmask, fbits=fbits, **kw)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["rescore_worklist"] == before + 1
    ps, pm = pr.rescore_worklist_plain(*args, wl_prev, fmask, **kw)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-6)
    if case == "filter_selects_nothing":
        assert not pm.any()
    elif C > 20:
        assert pm.sum() > 100
        assert torch.equal(pm[0, 10:20], pm[0, 10:11].expand(10))
    else:
        assert pm.sum() > 0


def test_pruned_search_on_the_card_equals_the_cpu(cuda):
    """search_topk_pruned's routes on one small index, the card against
    the CPU: v4, v3 filtered, exact, cand_given and exact counts."""
    from oramacore_tpu_torch.index import search_exec as ex
    from oramacore_tpu_torch.index import string_index as si
    from oramacore_tpu_torch.index.plan import plan_query

    rng = np.random.default_rng(32)
    vocab = [f"w{i}" for i in range(40)]
    p = 1.0 / (np.arange(40) + 3.0)
    idx = si.StringIndex()
    n_docs = 6000
    old = si.PREFIX_LEN
    si.PREFIX_LEN = 512
    try:
        for d in range(n_docs):
            words = rng.choice(vocab, int(rng.integers(3, 12)), p=p / p.sum())
            idx.index_text(d, "body", [(w, ["stem" + w[1:]]) for w in words])
        idx.commit()
        qs = [list(rng.choice(vocab[:20], 3)) for _ in range(8)]
        plans = [plan_query(idx, q, ["body"], {}, with_prefix=True) for q in qs]
    finally:
        si.PREFIX_LEN = old
    assert idx._slab_prefix_ranges
    small = np.zeros(n_docs, bool)
    small[rng.choice(n_docs, 500, replace=False)] = True
    runs = dict(v4={}, filtered=dict(mask=rng.random(n_docs) < 0.5),
                exact=dict(exact=True), cand_given=dict(mask=small),
                counts=dict(exact_counts=True))
    for name, kw in runs.items():
        out = [ex.PrunedPlanMixin(dev).search_topk_pruned(
            idx, plans, [float(n_docs)] * 8, n_docs, 10, **kw)
            for dev in ("cpu", cuda)]
        (cv, ci, cc), (gv, gi, gc) = out
        _near_tie_ok(gv, gi, cv, ci)
        np.testing.assert_array_equal(gc, cc, err_msg=name)
        assert np.isfinite(cv[:, 0]).all(), name


def _reps(rng, n, n_docs, cap, kept=0.6):
    """Phase A's shape: sorted docs with a sentinel tail (doc == cap,
    rep 0) and 0/1 reps."""
    docs = np.sort(rng.integers(0, n_docs, n)).astype(np.int32)
    docs[-n // 4:] = cap
    rep = (rng.random(n) < kept).astype(np.float32)
    rep[-n // 4:] = 0.0
    return docs, rep


def _overlapping_bounds(rng, G):
    a = np.round(rng.uniform(0, 100, G) * 2) / 2
    return np.stack([a, a + np.round(rng.uniform(0, 40, G) * 2) / 2],
                    axis=1).astype(np.float32)


def _num_column(rng, n):
    v = (np.round(rng.uniform(0, 100, n) * 2) / 2).astype(np.float32)
    v[rng.random(n) < 0.1] = np.nan
    return v


# case -> (numeric, G, what the reps hold); "G_max" is the most buckets
# one block holds
FACET_CARD_CASES = {
    "cat_G64": (False, 64, "kept"),
    "cat_G1": (False, 1, "kept"),
    "cat_G1024": (False, 1024, "kept"),
    "cat_G20000_smem_over_48k": (False, 20000, "kept"),
    "cat_no_kept_reps": (False, 64, "none"),
    "cat_all_sentinels": (False, 64, "sentinels"),
    "num_overlapping_ranges": (True, 8, "kept"),
    "num_G1": (True, 1, "kept"),
    "num_G1024": (True, 1024, "kept"),
    "num_G8000_smem_over_48k": (True, 8000, "kept"),
    "cat_unsorted": (False, 64, "unsorted"),
    "num_unsorted": (True, 8, "unsorted"),
    "cat_hybrid_runs": (False, 64, "hybrid"),
    "num_hybrid_runs": (True, 8, "hybrid"),
    "cat_docs_outside_the_column": (False, 64, "outside"),
    "cat_one_bucket": (False, 64, "one_bucket"),
    "num_one_range_value": (True, 8, "one_bucket"),
    "cat_n0": (False, 64, "n0"),
    "num_n0": (True, 8, "n0"),
    "cat_odd_n": (False, 64, "odd_n"),
    "num_odd_n": (True, 40, "odd_n"),
    "cat_misaligned_views": (False, 64, "misaligned"),
    "num_misaligned_views": (True, 8, "misaligned"),
    "cat_G_max": (False, "G_max", "kept"),
    "num_G_max": (True, "G_max", "kept"),
}


def _facet_reps(rng, held, n=1 << 20, n_docs=3_000_000, cap=1 << 22):
    """Phase A's reps (`_reps`), or the case's variant: no kept rep, only
    sentinels, shuffled, the hybrid's two ascending runs and sentinel
    padding, kept docs outside [0, n_docs) (negative, past it, the cap and
    the 2**30 sentinel), n = 0, n not a multiple of 4 or 8."""
    if held == "n0":
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    if held == "odd_n":
        n -= 3
    docs, rep = _reps(rng, n, n_docs, cap)
    if held == "none":
        rep[:] = 0.0
    elif held == "sentinels":
        docs[:] = cap
        rep[:] = 0.0
    elif held == "unsorted":
        perm = rng.permutation(n)
        docs, rep = docs[perm], rep[perm]
    elif held == "hybrid":
        vd = np.sort(rng.choice(n_docs, n // 8, replace=False)).astype(np.int32)
        vrep = (rng.random(n // 8) < 0.7).astype(np.float32)
        docs = np.concatenate([docs, vd, np.full(n // 16, cap, np.int32)])
        rep = np.concatenate([rep, vrep, np.zeros(n // 16, np.float32)])
    elif held == "outside":
        at = rng.choice(n - n // 4, 64, replace=False)
        docs[at] = rng.choice(np.array([-7, -1, n_docs, n_docs + 5, cap, 2**30],
                                       np.int32), 64)
        rep[at] = 1.0
    return docs, rep


def _card_views(cuda, held, docs, rep):
    """docs and rep on the card; "misaligned": views one word into their
    buffers (not 16-byte aligned)."""
    if held != "misaligned":
        return torch.from_numpy(docs).to(cuda), torch.from_numpy(rep).to(cuda)
    return (torch.from_numpy(np.r_[np.int32(0), docs]).to(cuda)[1:],
            torch.from_numpy(np.r_[np.float32(0), rep]).to(cuda)[1:])


@pytest.mark.parametrize("case", list(FACET_CARD_CASES))
def test_facet_hist_kernel(cuda, case):
    """facet_hist against its plain version: ids -1 and >= G, NaN and
    overlapping inclusive ranges, docs in any order, docs clipped into the
    column, one bucket taking every rep, n = 0, a ragged n, misaligned
    views, G from 1 to the most one block holds; exact int32 counts."""
    from oramacore_tpu_torch.ops import facet_hist as fh

    numeric, G, held = FACET_CARD_CASES[case]
    if G == "G_max":
        G = fh.max_buckets(numeric)
    rng = np.random.default_rng(len(case))
    cap = 1 << 22
    docs, rep = _facet_reps(rng, held, n_docs=cap - 1000, cap=cap)
    if numeric:
        col = _num_column(rng, cap)
        bounds = _overlapping_bounds(rng, G)
        if held == "one_bucket":
            col[:] = bounds[0, 0]
    else:
        col = rng.integers(-1, G + 3, cap).astype(np.int32)
        bounds = np.zeros((G, 2), np.float32)
        if held == "one_bucket":
            col[:] = G // 2
    args = [*_card_views(cuda, held, docs, rep)] + [
        torch.from_numpy(a).to(cuda) for a in (col, bounds)]
    before = fh.LAUNCHES["facet_hist"]
    got = fh.facet_hist(*args, G=G, numeric=numeric)
    torch.cuda.synchronize()
    assert fh.LAUNCHES["facet_hist"] == before + 1
    exp = fh.facet_hist_plain(*args, G, numeric)
    assert got.dtype == torch.int32 and torch.equal(got, exp)
    if held in ("none", "sentinels", "n0"):
        assert int(got.sum()) == 0
    else:
        assert int(got.sum()) > 0
    if held == "one_bucket" and not numeric:
        assert int(got[G // 2]) == int((rep != 0).sum())


# case -> (numeric, G, M, what the reps hold)
MULTI_CARD_CASES = {
    "cat_M8": (False, 32, 8, "kept"),
    "cat_M1": (False, 32, 1, "kept"),
    "cat_G1": (False, 1, 4, "kept"),
    "cat_G1024": (False, 1024, 4, "kept"),
    "cat_last_real_row": (False, 32, 4, "last"),
    "cat_no_kept_reps": (False, 32, 4, "none"),
    "cat_all_sentinels": (False, 32, 4, "sentinels"),
    "num_overlapping_ranges": (True, 8, 3, "kept"),
    "num_M8_G1024": (True, 1024, 8, "kept"),
    "num_last_real_row": (True, 8, 3, "last"),
    "cat_unsorted": (False, 32, 4, "unsorted"),
    "num_unsorted": (True, 8, 3, "unsorted"),
    "cat_hybrid_runs": (False, 32, 4, "hybrid"),
    "num_hybrid_runs": (True, 8, 3, "hybrid"),
    "cat_docs_outside_row_ptr": (False, 32, 4, "outside"),
    "num_docs_outside_row_ptr": (True, 8, 3, "outside"),
    "cat_M_below_the_rows": (False, 32, 2, "truncated"),
    "num_M_below_the_rows": (True, 8, 2, "truncated"),
    "cat_one_bucket": (False, 32, 4, "one_bucket"),
    "num_one_range_value": (True, 8, 3, "one_bucket"),
    "cat_n0": (False, 32, 4, "n0"),
    "num_n0": (True, 8, 3, "n0"),
    "cat_odd_n": (False, 32, 4, "odd_n"),
    "num_odd_n_G40": (True, 40, 3, "odd_n"),
    "cat_misaligned_views": (False, 32, 4, "misaligned"),
    "num_misaligned_views": (True, 8, 3, "misaligned"),
    "cat_G_max": (False, "G_max", 4, "kept"),
    "num_G_max": (True, "G_max", 3, "kept"),
}


def _pair_table(rng, n_docs, M, G, numeric):
    """Doc-sorted deduped (doc, value) rows, 0..M values a doc (the last
    doc M of them), and the sentinel row."""
    k = rng.integers(0, M + 1, n_docs)
    k[-1] = M
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), k)
    if numeric:
        vals = _num_column(rng, len(docs))
    else:
        vals = rng.integers(-1, G + 3, len(docs)).astype(np.int32)
    order = np.lexsort((vals, docs))
    docs, vals = docs[order], vals[order]
    first = np.r_[True, (docs[1:] != docs[:-1]) | (vals[1:] != vals[:-1])]
    docs, vals = docs[first], vals[first]
    return (np.r_[docs, 2**30].astype(np.int32),
            np.r_[vals, 0].astype(vals.dtype))


@pytest.mark.parametrize("case", list(MULTI_CARD_CASES))
def test_facet_hist_multi_kernel(cuda, case):
    """facet_hist_multi against its plain version: value_counts for ids,
    range_counts (one count per range a doc's values hit) for numbers; a
    doc at the table's last real row; no kept reps; only sentinels; docs
    in any order; kept docs outside [0, L), the 2**30 sentinel doc among
    them, which count nothing; M below a doc's rows; one bucket taking
    every rep; n = 0, a ragged n, misaligned views; G up to the most one
    block holds."""
    from oramacore_tpu_torch.ops import facet_hist as fh

    numeric, G, M, held = MULTI_CARD_CASES[case]
    if G == "G_max":
        G = fh.max_buckets(numeric, multi=True)
    rng = np.random.default_rng(100 + len(case))
    n_docs, cap = 2_000_000, 1 << 21
    pd, pv = _pair_table(rng, n_docs, 8 if held == "truncated" else M, G,
                         numeric)
    if held == "one_bucket":
        pv[:] = 0.5 if numeric else G // 2
        # pairs stay distinct as the kernel takes them: one row a doc
        keep = np.r_[True, pd[1:] != pd[:-1]]
        pd, pv = pd[keep], pv[keep]
    docs, rep = _facet_reps(rng, held if held not in ("last", "truncated",
                                                      "one_bucket") else
                            "kept", n=1 << 19, n_docs=n_docs, cap=cap)
    if held == "last":
        docs[:] = cap
        rep[:] = 0.0
        docs[0], rep[0] = n_docs - 1, 1.0
    bounds = (_overlapping_bounds(rng, G) if numeric
              else np.zeros((G, 2), np.float32))
    if held == "one_bucket" and numeric:
        bounds[:] = [0.0, 1.0]
    pd_dev = torch.from_numpy(pd).to(cuda)
    args = [*_card_views(cuda, held, docs, rep), pd_dev,
            torch.from_numpy(pv).to(cuda), fh.row_ptr_table(pd_dev, n_docs),
            torch.from_numpy(bounds).to(cuda)]
    before = fh.LAUNCHES["facet_hist_multi"]
    got = fh.facet_hist_multi(*args, G=G, M=M, numeric=numeric)
    torch.cuda.synchronize()
    assert fh.LAUNCHES["facet_hist_multi"] == before + 1
    exp = fh.facet_hist_multi_plain(*args, G, M, numeric)
    assert got.dtype == torch.int32 and torch.equal(got, exp)
    if held in ("none", "sentinels", "n0"):
        assert int(got.sum()) == 0
    elif held == "last":
        last = pd[:-1] == n_docs - 1
        if numeric:
            v = pv[:-1][last]
            want = sum(bool(((v >= lo) & (v <= hi)).any()) for lo, hi in bounds)
        else:
            v = pv[:-1][last]
            want = int(((v >= 0) & (v < G)).sum())
        assert int(got.sum()) == want
    else:
        assert int(got.sum()) > 0
    if held == "outside":   # the outside docs alone count nothing
        out = (docs < 0) | (docs >= n_docs)
        assert (out & (rep != 0) & (docs == 2**30)).any()
        d2 = torch.from_numpy(docs[out]).to(cuda)
        got = fh.facet_hist_multi(d2, torch.ones_like(d2, dtype=torch.float32),
                                  *args[2:], G=G, M=M, numeric=numeric)
        assert int(got.sum()) == 0
    if held == "one_bucket":
        n_kept = int(((rep != 0) & (docs < n_docs)).sum())
        counts = got.cpu().numpy()
        assert int(counts[0 if numeric else G // 2]) > 0
        assert int(counts.max()) <= n_kept


def test_pruned_facets_and_hybrid_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """facet_counts_pruned (text, thresholded, hybrid, vec_only; every
    spec kind) and search_topk_hybrid_int8_pruned (v4, v3 filtered,
    cand_given) on one small index and int8 layout, the card against the
    CPU."""
    from oramacore_tpu_torch.benches import hybrid10m as h
    from oramacore_tpu_torch.index import search_exec as ex
    from oramacore_tpu_torch.index import string_index as si
    from oramacore_tpu_torch.index.plan import plan_query

    rng = np.random.default_rng(33)
    vocab = [f"w{i}" for i in range(40)]
    p = 1.0 / (np.arange(40) + 3.0)
    idx = si.StringIndex()
    n_docs = 6000
    old = si.PREFIX_LEN
    si.PREFIX_LEN = 512
    try:
        for d in range(n_docs):
            words = rng.choice(vocab, int(rng.integers(3, 12)), p=p / p.sum())
            idx.index_text(d, "body", [(w, ["stem" + w[1:]]) for w in words])
        idx.commit()
        qs = [list(rng.choice(vocab[:20], 3)) for _ in range(8)]
        plans = [plan_query(idx, q, ["body"], {}, with_prefix=True) for q in qs]
    finally:
        si.PREFIX_LEN = old
    for name, v in dict(D=32, N_CENTERS=16, N_CENTROIDS=64, SAMPLE=4096,
                        CHUNK=4096, WINDOW=256, LLOYD_BLOCK=1024).items():
        monkeypatch.setattr(h, name, v)
    lay_cpu = h.build_layout(n_docs, "cpu")
    lay_gpu = h.Int8Layout(*(t.to(cuda) for t in (
        lay_cpu.mat, lay_cpu.scales, lay_cpu.row_doc, lay_cpu.unit_cen,
        lay_cpu.unit_starts, lay_cpu.pos)), window=lay_cpu.window,
        nprobe=lay_cpu.nprobe)
    q = h.query_vectors(8, "cpu")
    ids = rng.integers(-1, 12, n_docs).astype(np.int32)
    vals = _num_column(rng, n_docs)
    bounds = _overlapping_bounds(rng, 8)
    mdocs = np.repeat(np.arange(n_docs), rng.integers(0, 4, n_docs))
    pd, pv, m = ex.pair_table(mdocs, rng.integers(0, 10, len(mdocs)), n_docs)
    npd, npv, nm = ex.pair_table(mdocs, _num_column(rng, len(mdocs)), n_docs)
    specs = [("cat", ids, 10), ("num", vals, bounds), ("mcat", pd, pv, 10, m),
             ("mnum", npd, npv, bounds, nm)]
    for opts in (dict(), dict(thr=2.0), dict(vec=True),
                 dict(vec=True, vec_only=True)):
        counts = []
        for dev, lay in (("cpu", lay_cpu), (cuda, lay_gpu)):
            e = ex.HybridSearchTopK(dev)
            kw2 = dict(opts)
            if kw2.pop("vec", False):
                kw2["vec"] = (lay, q[:1], 0.3, None)
            counts.append([e.facet_counts_pruned(idx, plans[0], n_docs, s,
                                                 None, **kw2) for s in specs])
            counts[-1].append(e.facet_match_count(plans[0]))
        for c, g in zip(*counts):
            np.testing.assert_array_equal(g, c, err_msg=str(opts))
    capb = ex.round_up_pow2(n_docs, 128)
    small = np.zeros(n_docs, bool)
    small[rng.choice(n_docs, 500, replace=False)] = True
    for kw3 in (dict(), dict(mask=rng.random(n_docs) < 0.5), dict(mask=small)):
        out = [ex.HybridSearchTopK(dev).search_topk_hybrid_int8_pruned(
            idx, plans, [float(n_docs)] * 8, n_docs, 10, lay.int8_device_rows(),
            lay.int8_doc2row(capb), q, [0.3] * 8, **kw3)
            for dev, lay in (("cpu", lay_cpu), (cuda, lay_gpu))]
        (cv, ci, cc), (gv, gi, gc) = out
        _near_tie_ok(gv, gi, cv, ci)
        np.testing.assert_array_equal(gc, cc)
        assert np.isfinite(cv[:, 0]).all()


def _attention_case(cuda, label, seed):
    from oramacore_tpu_torch.benches.encoder_bench import (
        ATTENTION_CASES,
        attention_inputs,
    )

    case = ATTENTION_CASES[label]
    qkv, mask = attention_inputs(case, seed, cuda)
    return case, qkv, mask


@pytest.mark.parametrize("label", [
    "SemanticBase B=1024 L=64", "SemanticBase B=1024 L=16",
    "SemanticMini B=1024 L=64", "BGEBase B=8 L=128", "BGEBase B=8 L=512",
    "SemanticBase B=128 L=32, 28 padded rows", "SemanticBase B=1 L=16",
    "SemanticBase B=2 L=1, 1 padded row", "BGEBase B=4 L=77, 1 padded row",
    "BGESmall B=8 L=512", "hd 16 B=1024 L=64 H=16", "hd 128 B=8 L=512 H=8",
    "hd 128 B=64 L=16 H=8, 3 padded rows",
    "hd 128 B=64 L=32 H=8, 2 padded rows"])
def test_encoder_attention_kernel(cuda, label):
    """The kernel (f32) against its plain version in f64 on the same
    inputs (`attention_reference`: rows whose keys are all masked take the
    mean of V, as the f32 math gives): within 1e-5 (f32 sums of up to 512
    terms and an online softmax against exact f64)."""
    from oramacore_tpu_torch.benches.encoder_bench import attention_reference
    from oramacore_tpu_torch.ops import attention as at

    case, qkv, mask = _attention_case(cuda, label, 40)
    before = at.LAUNCHES["encoder_attention"]
    got = at.encoder_attention(qkv, mask, case["H"])
    torch.cuda.synchronize()
    assert at.LAUNCHES["encoder_attention"] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ref = attention_reference(qkv, mask, case["H"])
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    # the plain version in f32 on the card agrees too, padded rows included
    plain = at.encoder_attention_plain(qkv, mask, case["H"])
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


def _bert_state(rng, D, n_layers, V=50):
    state = {k: torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32))
             for k, s in dict(tok_emb=(V, D), pos_emb=(64, D),
                              type_emb=(2, D), emb_ln_g=(D,),
                              emb_ln_b=(D,)).items()}
    shapes = dict(qkv_w=(D, 3 * D), qkv_b=(3 * D,), o_w=(D, D), o_b=(D,),
                  attn_ln_g=(D,), attn_ln_b=(D,), ffn_w1=(D, 2 * D),
                  ffn_b1=(2 * D,), ffn_w2=(2 * D, D), ffn_b2=(D,),
                  ffn_ln_g=(D,), ffn_ln_b=(D,))
    for i in range(n_layers):
        for k, s in shapes.items():
            state[f"layers.{i}.{k}"] = torch.from_numpy(
                (rng.normal(size=s) * 0.2).astype(np.float32))
    return state


def test_encoder_refuses_other_head_widths_on_the_card(cuda):
    """A BertEncoder of head width 16 runs on the card through the
    attention kernel (once a layer) and equals its CPU run; head width 8,
    which the kernel does not take, runs on the card through the kernel
    on heads zero-padded to 16 (once a layer) and equals its CPU run (the
    plain attention); head width 160, above every kernel width, is
    refused on the card before any launch (ValueError)."""
    from oramacore_tpu_torch.embeddings import encoder as enc
    from oramacore_tpu_torch.ops import attention as at

    rng = np.random.default_rng(16)
    D, n_layers = 64, 2
    state = _bert_state(rng, D, n_layers)
    ids = torch.from_numpy(rng.integers(0, 50, (4, 16)))
    mask = (torch.arange(16)[None, :] < torch.tensor([[16], [9], [1], [0]])
            ).to(torch.int32)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    for H in (4, 8):
        with torch.inference_mode():
            want = enc.BertEncoder.from_state(state, H)(ids, mask)
            launches = at.LAUNCHES["encoder_attention"]
            got = enc.BertEncoder.from_state(state, H).to(cuda)(
                ids.to(cuda), mask.to(cuda))
            torch.cuda.synchronize()
        assert at.LAUNCHES["encoder_attention"] == launches + n_layers
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain
    wide = enc.BertEncoder.from_state(_bert_state(rng, 320, 1), 2).to(cuda)
    launches = dict(at.LAUNCHES)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="head width 160"):
        wide(ids.to(cuda), mask.to(cuda))
    assert at.LAUNCHES == launches
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain


@pytest.mark.parametrize("hd", [8, 48, 96])
def test_encoder_attention_padded_head_widths(cuda, hd):
    """Head widths under 128 that the kernels do not take: zero-padded to
    the next kernel width (16, 64, 128), launched with the true width's
    divisor and sliced; forward within 1e-5 of the f64 reference, the
    backward kernels within 5e-5 (BWD_TOL) of theirs, one launch each."""
    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.benches.encoder_bench import attention_reference
    from oramacore_tpu_torch.ops import attention as at

    case = dict(B=16, L=70, H=4, hd=hd, padded=2)
    qkv, mask, dctx = tb.backward_inputs(case, 90 + hd, cuda)
    before = dict(at.LAUNCHES)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    got = at.encoder_attention(qkv, mask, 4)
    dqkv = at.encoder_attention_backward(qkv, mask, dctx, 4)
    torch.cuda.synchronize()
    assert {k: at.LAUNCHES[k] - before[k] for k in before} == {
        "encoder_attention": 1, "encoder_attention_backward_dq": 1,
        "encoder_attention_backward_dkv": 1}
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain
    assert got.shape == (16, 70, 4 * hd) and dqkv.shape == qkv.shape
    torch.testing.assert_close(got.double(), attention_reference(qkv, mask, 4),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dqkv.double(),
                               tb.backward_reference(qkv, mask, dctx, 4),
                               rtol=tb.BWD_TOL, atol=tb.BWD_TOL)


def test_encoder_attention_above_128_is_refused_on_the_card(cuda):
    """Head width 160: refused (ValueError) before any launch, forward and
    backward; nothing runs the plain version on the card."""
    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.ops import attention as at

    case = dict(B=4, L=33, H=2, hd=160, padded=1)
    qkv, mask, dctx = tb.backward_inputs(case, 160, cuda)
    before = dict(at.LAUNCHES)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    with pytest.raises(ValueError, match="head width 160"):
        at.encoder_attention(qkv, mask, 2)
    with pytest.raises(ValueError, match="head width 160"):
        at.encoder_attention_backward(qkv, mask, dctx, 2)
    assert at.LAUNCHES == before
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain


def test_encoder_attention_refuses_what_it_cannot_run(cuda):
    from oramacore_tpu_torch.ops import attention as at

    qkv = torch.zeros((2, 16, 3 * 256), device=cuda)
    mask = torch.ones((2, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        at.encoder_attention(qkv.double(), mask, 8)
    with pytest.raises(TypeError):
        at.encoder_attention(qkv, mask.long(), 8)
    # hd 8 is no longer refused: the kernel runs on padded heads
    assert at.encoder_attention(qkv, mask, 32).shape == (2, 16, 256)
    with pytest.raises(ValueError):
        at.encoder_attention(qkv[:, :, 1:-2], mask, 8)
    with pytest.raises(ValueError):
        at.encoder_attention(torch.zeros((1, 513, 3 * 256), device=cuda),
                             torch.ones((1, 513), dtype=torch.int32,
                                        device=cuda), 8)


@pytest.mark.parametrize("label", [
    "training B=64 L=16", "SemanticBase B=1024 L=64", "BGEBase B=8 L=512",
    "hd 16 B=1024 L=64 H=16", "hd 128 B=8 L=512 H=8",
    "SemanticBase B=16 L=37", "SemanticBase B=128 L=32, 28 padded rows",
    "SemanticBase B=2 L=1, 1 padded row", "SemanticBase B=32 L=65",
    "SemanticBase B=64 L=33, 8 padded rows"])
def test_encoder_attention_backward_kernels(cuda, label):
    """Both backward kernels (f32) against the f64 reference
    (`train_bench.backward_reference`: P uniform in rows whose keys are all
    masked, as the f32 math gives): within `BWD_TOL` (f32 sums over up to 512
    keys and 2 recomputed dot products against exact f64; the card's
    largest error in its first run was 8.7e-6)."""
    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.ops import attention as at

    case = tb.BACKWARD_CASES[label]
    qkv, mask, dctx = tb.backward_inputs(case, 60, cuda)
    before = dict(at.LAUNCHES)
    got = at.encoder_attention_backward(qkv, mask, dctx, case["H"])
    torch.cuda.synchronize()
    for name in ("encoder_attention_backward_dq",
                 "encoder_attention_backward_dkv"):
        assert at.LAUNCHES[name] == before[name] + 1
    assert at.LAUNCHES["encoder_attention"] == before["encoder_attention"]
    assert got.shape == qkv.shape and torch.isfinite(got).all()
    ref = tb.backward_reference(qkv, mask, dctx, case["H"])
    torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)
    # one part at a time gives the same gradient
    dqkv, stats = at.launch_backward(qkv, mask, dctx, case["H"],
                                     parts=("dq",))
    at.launch_backward(qkv, mask, dctx, case["H"], parts=("dkv",),
                       dqkv=dqkv, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, got)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 17, 33, 65])
def test_encoder_attention_backward_every_tiling(cuda, hd, L):
    """Every tiling `backward_tiles_for` picks (1, 2 and 4 warps a (b, h),
    one- and two-stage rings, dkv's two walks at hd 128) against the f64
    reference, with a full row, partly masked rows and a row whose keys
    are all masked."""
    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.ops import attention as at

    case = dict(B=5, L=L, H=2, hd=hd, padded=1)
    qkv, mask, dctx = tb.backward_inputs(case, 70 + hd + L, cuda)
    got = at.encoder_attention_backward(qkv, mask, dctx, 2)
    torch.cuda.synchronize()
    ref = tb.backward_reference(qkv, mask, dctx, 2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)


def test_encoder_attention_function_on_the_card(cuda):
    """EncoderAttention's gradient on the card (the kernels) equals its
    gradient on the CPU (the plain versions), and autograd's backward
    thread launches the kernels on the forward's stream."""
    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.ops import attention as at

    case = tb.BACKWARD_CASES["SemanticBase B=16 L=37"]
    qkv, mask, dctx = tb.backward_inputs(case, 61, "cpu")
    x = qkv.clone().requires_grad_(True)
    at.EncoderAttention.apply(x, mask, case["H"]).backward(dctx)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        xc = qkv.to(cuda).requires_grad_(True)
        out = at.EncoderAttention.apply(xc, mask.to(cuda), case["H"])
        out.backward(dctx.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(xc.grad.cpu(), x.grad, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)


def test_encoder_attention_backward_refuses_what_it_cannot_run(cuda):
    from oramacore_tpu_torch.ops import attention as at

    qkv = torch.zeros((2, 16, 3 * 256), device=cuda)
    mask = torch.ones((2, 16), dtype=torch.int32, device=cuda)
    dctx = torch.zeros((2, 16, 256), device=cuda)
    with pytest.raises(TypeError):
        at.encoder_attention_backward(qkv, mask, dctx.double(), 8)
    # hd 8 is no longer refused: the kernels run on padded heads
    assert at.encoder_attention_backward(qkv, mask, dctx, 32).shape == \
        qkv.shape
    with pytest.raises(ValueError):
        at.encoder_attention_backward(qkv, mask, dctx.transpose(0, 1)
                                      .contiguous().transpose(0, 1), 8)
    with pytest.raises(ValueError):
        at.encoder_attention_backward(qkv, mask, dctx.cpu(), 8)


def test_encoder_attention_backward_refuses_another_layout(cuda):
    """The shared memory `backward_tiles_for` passes is the kernels'
    layout: the entry points launch with it and refuse it 16 bytes off."""
    import numpy as np

    from oramacore_tpu_torch.benches import train_bench as tb
    from oramacore_tpu_torch.ops import attention as at

    case = dict(B=3, L=40, H=2, hd=32, padded=0)
    qkv, mask, dctx = tb.backward_inputs(case, 5, cuda)
    dqkv = torch.zeros_like(qkv)
    stats = torch.zeros((3 * 2 * 40, 4), device=cuda)
    lib = at.load_backward_kernels()
    div = float(np.float32(np.sqrt(32)))
    stream = torch.cuda.current_stream().cuda_stream
    for kind, tl in at.backward_tiles_for(3, 2, 40, 32).items():
        fn = getattr(lib, f"encoder_attention_backward_{kind}_launch")
        tail = (dqkv, stats) if kind == "dq" else (stats, dqkv)
        for smem, ok in ((tl.smem, True), (tl.smem + 16, False),
                         (tl.smem - 16, False)):
            err = fn(qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                     *(t.data_ptr() for t in tail), 3, 40, 2, 32, tl.warps,
                     tl.pairs, tl.tile, tl.stages, tl.row_tiles, tl.grid,
                     smem, div, stream)
            assert (err == 0) == ok, (kind, smem, err)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        dqkv.double(), tb.backward_reference(qkv, mask, dctx, 2),
        rtol=tb.BWD_TOL, atol=tb.BWD_TOL)


def test_training_step_on_the_card(cuda):
    """One SemanticBase-width training step on the card: 2 encoder calls x
    4 layers, so 8 launches of the forward and of each backward kernel;
    its loss and gradients equal the CPU's from the same parameters and
    batch."""
    from oramacore_tpu_torch.ops import attention as at
    from oramacore_tpu_torch.train import semantic_encoder as se

    cfg = se.TrainConfig(steps=10)
    state = se.init_state(cfg, len(se.vocab_tokens()),
                          torch.Generator().manual_seed(3))
    card = se.SemanticTrainer(cfg, cuda, state=state)
    cpu = se.SemanticTrainer(cfg, "cpu", state=state)
    batch = card.next_batch()
    cpu_batch = cpu.next_batch()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(batch, cpu_batch))
    at.reset_launch_counts()
    loss, acc = card.step(batch)
    torch.cuda.synchronize()
    assert at.LAUNCHES == {"encoder_attention": 8,
                           "encoder_attention_backward_dq": 8,
                           "encoder_attention_backward_dkv": 8}
    closs, cacc = cpu.step(cpu_batch)
    assert abs(float(loss) - float(closs)) <= 1e-4
    for (k, p), (_, q) in zip(card.model.named_parameters(),
                              cpu.model.named_parameters()):
        g, h = p.grad.cpu(), q.grad
        assert float((g - h).abs().max()) <= 1e-3 * max(
            float(h.abs().max()), 1e-6), k


@pytest.mark.parametrize("pruning", ["auto", "on"])
def test_read_side_on_the_card_equals_the_cpu(cuda, pruning, tmp_path):
    """The runtime on the card: build_orama(device="cuda"), 2,000 games
    documents through the write side and the op log, committed; a CPU
    read side loaded from the same snapshots gives the same answers
    (chip_smoke's gate: ids outside near-ties, scores rtol 1e-4, counts,
    facets, groups, documents) for searches of every kind, dense and
    with pruning "on"."""
    import chip_smoke as cs
    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.embeddings import EmbeddingsService
    from oramacore_tpu_torch.oplog import InMemoryTransport
    from oramacore_tpu_torch.read import ReadSide
    from oramacore_tpu_torch.runtime import build_orama
    from oramacore_tpu_torch.utils.tokenizer import NLPService

    words, stems = ib.vocabulary(2_000, seed=3)
    docs = ib.documents(2_000, seed=3, words=words)
    qtexts = ib.queries(stems, 16, seed=4)
    data = str(tmp_path / "data")
    orama = build_orama(cs.rs_config(data), device=cuda,
                        sync_embeddings=True, start_consumer=False)
    ws, rs = orama.write_side, orama.read_side
    rk, wk = cs.RS_KEYS["games"]
    ws.create_collection(cs.RS_MASTER, "games", read_api_key=rk,
                         write_api_key=wk)
    ws.create_index("games", wk, "main")
    ws.insert_documents("games", "main", wk, docs)
    rs.pump()
    ws.commit()
    rs.commit(force=True)
    orama.stop()
    readers = {dev: ReadSide(cs.rs_config(data, pruning),
                             InMemoryTransport().receiver,
                             EmbeddingsService(), NLPService(), device=dev)
               for dev in (cuda, "cpu")}
    old = (cs.RS_SINGLE, cs.RS_KIND_QUERIES, cs.RS_VEC_B)
    cs.RS_SINGLE, cs.RS_KIND_QUERIES, cs.RS_VEC_B = 4, 1, 8
    try:
        singles, batches = cs.rs_cases(qtexts, qtexts[:8])
    finally:
        cs.RS_SINGLE, cs.RS_KIND_QUERIES, cs.RS_VEC_B = old
    games = lambda name: not name.startswith(("passages", "tolerance"))
    got = {dev: cs.rs_answers(r, singles, batches, games)
           for dev, r in readers.items()}
    bad = []
    for name, results in got["cpu"].items():
        for qi, (a, b) in enumerate(zip(results, got[cuda][name])):
            bad += cs.rs_result_errors(a, b, f"{name}[{qi}]")
    assert not bad, "\n".join(bad[:20])
    assert sum(r.count for r in got[cuda]["fulltext 0"]) > 0
