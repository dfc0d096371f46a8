"""oramacore_tpu_torch.ops.assign_rows (CPU: the plain versions) against
the dense formulation it replaces: per-row df and idf, then the (B, rows)
slot-count matrix A times the saturated rows, `scores.addmm_(A, sat)` and
`matched.addmm_(A, present)`, computed here in float64.

Tolerances: matched exactly (counts of 0/1 terms); scores within rtol
2e-6 of float64, since the f32 version rounds each of at most T + 1
additions, the idf and each term's saturation to f32 (2^-24 each)."""

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.ops import assign_rows as ar
from oramacore_tpu_torch.ops import bm25 as tbm25

K1 = tbm25.K1
N_DOCS = 1000.0


def dense_oracle(acc, df, token_map, scores, matched, row0):
    """The assignment products in float64: A[b, j] counts b's slots that
    hold row j (id row0 + j); idf per row, or per (row, query) applied to
    A as the masked twins did."""
    d = df.double().clamp(min=1.0)
    idf = torch.log1p((N_DOCS - d + 0.5) / (d + 0.5))
    rows = acc.shape[0]
    uid = torch.arange(row0, row0 + rows)
    A = (token_map.long()[:, :, None] == uid[None, None, :]).sum(1).double()
    a = acc.double()
    present = (a > 0).double()
    g = (K1 + 1.0) * a / (K1 + a) * present
    if idf.dim() == 1:
        s = scores.double().addmm_(A, idf.double()[:, None] * g)
    else:
        s = scores.double().addmm_(A * idf.double().T, g)
    return s, matched.double().addmm_(A, present)


def make(case, seed=0):
    """(acc, df, token_map, scores, matched, row0) of one case."""
    rng = np.random.default_rng(seed)
    B, T, rows, cap, row0 = 9, 5, 6, 1000, 12
    pad = row0 + 3 * rows          # the ranged classes' sentinel Up
    acc = rng.random((rows, cap)) * (rng.random((rows, cap)) < 0.2)
    acc[:, :5] = -1.0              # below 0: not present, adds nothing
    tmap = rng.integers(row0 - rows, row0 + 2 * rows, (B, T))
    df = rng.integers(0, 400, rows)
    df[0] = 0                      # counts as 1
    if case == "same_term_twice":
        tmap[0, :2] = row0 + 2
        tmap[1, :] = row0 + 4
    elif case == "padding":
        tmap[:, -2:] = pad
        tmap[::2, 0] = -1
    elif case == "no_slot_in_chunk":
        tmap[: B // 2] = rng.integers(row0 + rows, row0 + 2 * rows,
                                      (B // 2, T))
    elif case == "first_and_last_rows":
        tmap[:, 0] = row0
        tmap[:, 1] = row0 + rows - 1
        tmap[:, 2] = row0 - 1          # the previous chunk's last row
        tmap[:, 3] = row0 + rows       # the next chunk's first row
    elif case == "champion_entries":
        # a global map (-1 padding) through the champion entries' ids
        row0 = 0
        entry = np.array([3, 8, 11, 20, 21, 40], np.int32)
        g = rng.choice(np.r_[-1, entry, 5, 9], (B, T))
        g[0, :2] = entry[0]
        tmap = tbm25._entry_map(torch.from_numpy(g.astype(np.int32)),
                                torch.from_numpy(entry)).numpy()
        lut = {int(e): i for i, e in enumerate(entry)}
        assert tmap.tolist() == [[lut.get(int(x), -1) for x in r] for r in g]
    elif case == "idf_per_query":
        df = rng.integers(0, 400, (rows, B))
    scores = rng.random((B, cap)) * (rng.random((B, cap)) < 0.3)
    matched = rng.integers(0, 3, (B, cap))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return (f32(acc), f32(df), torch.from_numpy(tmap.astype(np.int32)),
            f32(scores), f32(matched), row0)


CASES = ["same_term_twice", "padding", "no_slot_in_chunk",
         "first_and_last_rows", "champion_entries", "idf_per_query"]


@pytest.mark.parametrize("case", CASES)
def test_assign_rows_equals_the_assignment_products(case):
    acc, df, tmap, scores, matched, row0 = make(case)
    es, em = dense_oracle(acc, df, tmap, scores, matched, row0)
    s0, m0 = scores.clone(), matched.clone()
    ts, tm = ar.assign_rows_accumulate(acc, df, tmap, scores, matched,
                                       row0=row0, n_docs=N_DOCS, k1=K1)
    assert ts is scores and tm is matched          # updated in place
    np.testing.assert_array_equal(tm.numpy(), em.numpy())
    np.testing.assert_allclose(ts.numpy(), es.numpy(), rtol=2e-6, atol=0)
    assert not torch.equal(tm, m0)                 # the case adds something
    r = tmap.long() - row0
    idle = ~((r >= 0) & (r < acc.shape[0])).any(dim=1)
    assert torch.equal(ts[idle], s0[idle]) and torch.equal(tm[idle], m0[idle])
    if case == "no_slot_in_chunk":
        assert idle.sum() >= acc.shape[0] // 2 and (~idle).any()


def test_assign_rows_refuses_what_it_cannot_take():
    acc, df, tmap, scores, matched, row0 = make("padding")
    kw = dict(row0=row0, n_docs=N_DOCS, k1=K1)
    with pytest.raises(ValueError, match="df must be"):
        ar.assign_rows_accumulate(acc, df[:-1], tmap, scores, matched, **kw)
    with pytest.raises(TypeError, match="token_map"):
        ar.assign_rows_accumulate(acc, df, tmap.long(), scores, matched, **kw)
    with pytest.raises(ValueError, match="matched must be"):
        ar.assign_rows_accumulate(acc, df, tmap, scores, matched[:, 1:]
                                  .contiguous(), **kw)


def test_count_present_counts_docs_above_zero():
    acc = torch.tensor([[0.0, 1.0, -2.0, 3.0, float("nan")],
                        [0.0, 0.0, 0.0, 0.0, 0.0],
                        [1e-30, 2.0, 2.0, 2.0, 2.0]])
    assert ar.count_present(acc).tolist() == [2.0, 0.0, 5.0]
    assert ar.count_present(acc).dtype == torch.float32


def test_touched_pairs_counts_each_query_chunk_once():
    rng = np.random.default_rng(3)
    n_rows, cu = 37, 8
    tmap = rng.integers(-1, n_rows + 9, (50, 7)).astype(np.int32)
    tmap[0] = [0, 1, 2, 3, 4, 5, 6]              # one chunk, seven slots
    tmap[1] = [0, 8, 16, 24, 32, -1, n_rows]     # five chunks, padding
    tmap[2] = n_rows + 3                          # no slot in the class
    want = sum(len({int(u) // cu for u in row if 0 <= u < n_rows})
               for row in tmap)
    assert texec.touched_pairs(tmap, n_rows, cu) == want
    assert texec.touched_pairs(tmap[:3], n_rows, cu) == 1 + 5 + 0

