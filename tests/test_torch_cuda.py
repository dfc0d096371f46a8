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
