"""The plain reference against brute force on a tiny corpus: BM25F by
loops over documents, cosines and fusion by loops over rows."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import Reference, normalize_rows_f32, sim_slack


def tiny(seed=0, n=40, vocab=12, dim=8):
    rng = np.random.default_rng(seed)
    n_tok = rng.integers(1, 9, n)
    tokens = rng.integers(0, vocab, int(n_tok.sum())).astype(np.int32)
    rows = rng.normal(size=(n, dim)).astype(np.float32)
    return n_tok.astype(np.int64), tokens, rows


def brute_bm25(n_tok, tokens, terms):
    n = len(n_tok)
    docs, o = [], 0
    for L in n_tok:
        docs.append(tokens[o:o + L].tolist())
        o += L
    avg = sum(n_tok) / n
    out = np.zeros(n)
    for t in terms:
        df = sum(1 for d in docs if t in d)
        if not df:
            continue
        idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
        for i, d in enumerate(docs):
            tf = d.count(t)
            if tf:
                ntf = tf / (0.25 + 0.75 * len(d) / avg)
                out[i] += idf * 2.2 * ntf / (1.2 + ntf)
    return out


@pytest.mark.parametrize("terms", [[0], [1, 2, 3], [11, 5], [3, 3]])
def test_bm25_matches_brute_force(terms):
    n_tok, tokens, _ = tiny()
    ref = Reference(len(n_tok), 12, n_tok, tokens, None, "cpu")
    got = ref.bm25(terms).numpy()
    want = brute_bm25(n_tok, tokens, terms)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    lo, hi, n_lo, n_hi = ref.scores([terms])[0]
    assert n_lo == n_hi == int((want > 0).sum())
    assert torch.equal(lo, hi)


def test_hybrid_matches_brute_force():
    n_tok, tokens, rows = tiny(1)
    ref = Reference(len(n_tok), 12, n_tok, tokens, rows, "cpu")
    q = rows[3] + 0.3
    q = (q / np.linalg.norm(q)).astype(np.float32)
    sim = 0.2
    lo, hi, n_lo, n_hi = ref.scores([[1, 4]], q[None], sim)[0]
    unit = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
    r16 = torch.tensor(unit).to(torch.bfloat16).double().numpy()
    q16 = torch.tensor(q).to(torch.bfloat16).double().numpy()
    cos = r16 @ q16
    ft = brute_bm25(n_tok, tokens, [1, 4])
    vc = np.where(cos >= sim, np.maximum(cos, 0), 0.0)
    span = max(ft.max(), vc.max())
    present = (ft > 0) | (vc > 0)
    fused = np.where(present, (ft + vc) / span, -np.inf)
    near = np.abs(cos - sim) <= sim_slack(8)
    assert not near.any()
    np.testing.assert_allclose(lo.numpy(), fused, rtol=1e-12)
    np.testing.assert_allclose(hi.numpy(), fused, rtol=1e-12)
    assert n_lo == n_hi == int(present.sum())


def test_rows_normalised_as_the_index_does():
    _, _, rows = tiny(2, n=100, dim=384)
    each = np.stack([r / max(np.linalg.norm(r, axis=-1, keepdims=True)[0],
                             1e-12) for r in rows])
    assert np.array_equal(normalize_rows_f32(rows), each.astype(np.float32))


def test_slack_bounds_an_f32_dot():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2000, 384)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    a16 = torch.tensor(a).to(torch.bfloat16)
    exact = a16.double() @ a16.double()[0]
    f32 = a16.float() @ a16.float()[0]
    assert float((exact - f32.double()).abs().max()) <= sim_slack(384)
