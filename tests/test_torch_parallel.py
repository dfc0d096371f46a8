"""The port's mesh (`oramacore_tpu_torch/parallel/`), on the CPU: the
bodies of `tests/test_parallel.py` and unit tests of `parallel/mesh.py`.

- The toy sharded step (`make_sharded_search_step` on
  `make_toy_sharded_index`) against JAX's at D = 2, 4 and 8 on JAX's
  virtual CPU devices (and a 2 x 4 grid), and against the host replay of
  its math; the port's `bm25_score_batch` at the shapes of
  `__graft_entry__.entry` against JAX's.
- The dry run of the engine over meshes of 2, 4 and 8 shards (fused full
  text and hybrid, batches, the pruned tier and the pruned hybrid at the
  IVF tier), each answer held to the port's single device.
- ShardMesh: shard-ordered sums equal bit for bit across runs, a shard's
  exception aborts the step and re-raises in the caller (the mesh then
  runs on), a shard that skips a collective breaks it after the timeout,
  and the all_gather merge keeps the lower shard among equal scores, as
  `lax.top_k` over the flat row does.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oramacore_tpu.parallel as jax_par
import oramacore_tpu_torch.index.vector_index as port_vi
import oramacore_tpu_torch.parallel as par
from oramacore_tpu_torch.parallel.engine import _merge_topk
from oramacore_tpu_torch.parallel.mesh import Sharded, ShardMesh

from .torch_mesh_cases import assert_hits_match, run

CPU = torch.device("cpu")
CAP, DIM, K, LR = 128, 32, 8, 16
B, T, NR = 4, 3, 2


def _toy_inputs(seed=7):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 256 - LR, (B, T, NR)).astype(np.int32)
    lens = rng.integers(1, LR, (B, T, NR)).astype(np.int32)
    weights = np.ones((B, T, NR), np.float32)
    avg = np.full((B, T, NR), 25.0, np.float32)
    q = rng.normal(size=(B, DIM)).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
    return starts, lens, weights, avg, q


def _port_toy(n_q, n_d, alpha, seed=3):
    idx = par.make_toy_sharded_index(n_d, 256, 64, CAP, DIM, seed=seed)
    step = par.make_sharded_search_step(
        par.build_mesh(n_q, n_d, [CPU] * (n_q * n_d)), lr=LR, cap=CAP, k=K)
    starts, lens, weights, avg, q = _toy_inputs()
    ids, vals = step(*idx, *(torch.from_numpy(a) for a in
                             (starts, lens, weights, avg, q)),
                     float(CAP * n_d), alpha)
    return ids.numpy(), vals.numpy()


def _jax_toy(n_q, n_d, alpha, seed=3):
    idx = jax_par.make_toy_sharded_index(n_d, 256, 64, CAP, DIM, seed=seed)
    step = jax_par.make_sharded_search_step(
        jax_par.build_mesh(n_q, n_d), lr=LR, cap=CAP, k=K)
    starts, lens, weights, avg, q = _toy_inputs()
    ids, vals = step(*idx, *(jnp.asarray(a) for a in
                             (starts, lens, weights, avg, q)),
                     jnp.float32(CAP * n_d), jnp.float32(alpha))
    return np.asarray(ids), np.asarray(vals)


@pytest.mark.parametrize("grid", [(1, 2), (1, 4), (1, 8), (2, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_toy_sharded_step_matches_jax(grid, alpha):
    """The same toy index and queries through both packages' sharded
    steps: global ids and scores of the top-k, ids equal outside
    near-ties (the bf16 cosines tie often at alpha 0.5)."""
    ids, vals = _port_toy(*grid, alpha)
    j_ids, j_vals = _jax_toy(*grid, alpha)
    for b in range(B):
        assert_hits_match(dict(ids=list(j_ids[b]), scores=list(j_vals[b])),
                          dict(ids=list(ids[b]), scores=list(vals[b])),
                          counts=False)


def test_sharded_matches_single_device_bm25():
    """The doc-sharded step's global top-k (pure BM25) equals a host
    replay of the same scoring math over the whole corpus."""
    n_d = 4
    idx = par.make_toy_sharded_index(n_d, 256, 64, CAP, DIM, seed=3)
    _, vals = _port_toy(1, n_d, 1.0)
    starts, lens, weights, avg, _ = _toy_inputs()
    p_doc, p_tf, p_flen = (t.numpy() for t in idx[:3])
    n_docs = float(CAP * n_d)
    scores = np.zeros((B, CAP * n_d), np.float32)
    for b in range(B):
        for t in range(T):
            acc = np.zeros(CAP * n_d, np.float32)
            for s in range(n_d):
                for r in range(NR):
                    st, ln = int(starts[b, t, r]), int(lens[b, t, r])
                    for p in range(st, min(st + ln, 256)):
                        denom = 0.25 + 0.75 * p_flen[s, p] / 25.0
                        acc[s * CAP + p_doc[s, p]] += p_tf[s, p] / denom
            present = acc > 0
            df = max(present.sum(), 1.0)
            idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
            scores[b] += np.where(present,
                                  idf * 2.2 * acc / (1.2 + acc), 0.0)
    for b in range(B):
        np.testing.assert_allclose(vals[b], np.sort(scores[b])[::-1][:K],
                                   atol=1e-3)


def test_entry_matches_jax():
    """The port's bm25_score_batch at `__graft_entry__.entry`'s shapes
    equals JAX's."""
    import __graft_entry__ as ge

    from oramacore_tpu_torch.ops.bm25 import bm25_score_batch

    fn, args = ge.entry()
    j_scores, j_matched = jax.jit(lambda *a: fn(*a))(*args)
    (p_doc, p_tf, p_etf, p_flen, starts, lens, weights, field_b, avg,
     n_docs, mask) = (torch.from_numpy(np.array(a)) for a in args)
    scores, matched = bm25_score_batch(
        p_doc, p_tf, p_etf, p_flen, starts, lens, weights, field_b, avg,
        n_docs, mask, lr=128, exact=False, cap=4096)
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(j_matched))


# ---------------------------------------------------------------------------
# the engine's dry run over the mesh
# ---------------------------------------------------------------------------

_WORDS = ["orange", "banana", "apple", "grape", "melon", "kiwi", "plum",
          "pear"]
_rng = np.random.default_rng(3)
DRY_DOCS = [{"id": str(i), "t": " ".join(_rng.choice(_WORDS, size=3,
                                                      replace=False)),
             "n": int(i % 5)} for i in range(96)]
DRY_SEARCH = [{"term": "orange banana", "limit": 5},
              {"term": "apple", "where": {"n": {"gt": 2}}, "limit": 5},
              {"mode": "hybrid", "term": "kiwi plum", "similarity": 0.0,
               "limit": 5}]
DRY_BATCH = [{"term": "orange banana", "limit": 4},
             {"term": "grape melon", "limit": 4},
             {"term": "apple", "where": {"n": {"lte": 2}}, "limit": 4}]
DRY_HYBRID = [{"mode": "hybrid", "term": t, "similarity": 0.0, "limit": 4}
              for t in ("orange banana", "kiwi pear")]
DRY_PRUNED = [{"term": "orange banana", "limit": 5},
              {"term": "orange banana", "limit": 5, "exactCount": True}]
DRY_IVF = [{"mode": "hybrid", "term": "orange pear", "similarity": 0.0,
            "limit": 5}]


def _pruning_on(orama, coll):
    orama.read_side.config.reader_side.pruning = "on"


def _ivf_engaged(orama, coll):
    return next(iter(orama.read_side.collections["c"].indexes.values())
                ).vector._ivf is not None


DRY_STEPS = [("commit", None), ("search", DRY_SEARCH), ("batch", DRY_BATCH),
             ("batch", DRY_HYBRID), ("call", _pruning_on),
             ("search", DRY_PRUNED),
             ("insert", [{"id": "ivf", "t": "orange pear", "n": 1}]),
             ("commit", None), ("call", _ivf_engaged), ("search", DRY_IVF)]
DRY_IVF_KNOBS = [(port_vi, "IVF_MIN_ROWS", 8), (port_vi, "IVF_NPROBE", 64)]


@pytest.fixture(scope="module")
def dry_single():
    return run("torch", 0, DRY_DOCS, DRY_STEPS, monkey=DRY_IVF_KNOBS)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_mesh(dry_single, n):
    """Every production mesh path of the engine runs over n CPU shards
    (fused full text and hybrid, shared batches with filters and hybrid
    tails, the pruned tier with estimated and exact counts, the pruned
    hybrid at the IVF tier), each answer held to the single device."""
    got = run("torch", n, DRY_DOCS, DRY_STEPS, monkey=DRY_IVF_KNOBS)
    assert got[8] and dry_single[8], "IVF must build"
    for i, queries in ((1, DRY_SEARCH), (2, DRY_BATCH), (3, DRY_HYBRID),
                       (5, DRY_PRUNED), (9, DRY_IVF)):
        for q, a, b in zip(queries, dry_single[i], got[i]):
            assert b["count"] > 0, q
            assert_hits_match(a, b, q, tol=2e-3, counts=False)
            assert b["estimated"] == a["estimated"], q
    assert got[5][0]["estimated"] and not got[5][1]["estimated"]
    assert got[5][1]["count"] == dry_single[5][1]["count"]


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

def test_psum_sums_in_shard_order_bit_for_bit():
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=1000).astype(np.float32)
                           * 10.0 ** rng.integers(-8, 8, 1000))
          for _ in range(4)]
    mesh = ShardMesh([CPU] * 4)
    try:
        body = lambda ax, x: ax.psum(x)  # noqa: E731
        first = mesh.run(body, Sharded(xs))
        again = mesh.run(body, Sharded(xs))
    finally:
        mesh.close()
    want = functools.reduce(torch.add, xs)
    for r in list(first) + list(again):
        assert torch.equal(r, want)


def test_pmax_all_gather_and_replicated_arguments():
    mesh = ShardMesh([CPU] * 3)
    try:
        out = mesh.run(
            lambda ax, x, c: (ax.pmax(x * c), ax.all_gather(x, axis=1),
                              ax.index),
            Sharded(torch.full((2, 2), float(s)) for s in range(3)), 2.0)
    finally:
        mesh.close()
    for s, (mx, gathered, index) in enumerate(out):
        assert index == s
        assert torch.equal(mx, torch.full((2, 2), 4.0))
        assert gathered.shape == (2, 3, 2)
        assert torch.equal(gathered[:, 1], torch.ones(2, 2))


def test_a_shard_exception_aborts_the_step_and_reraises():
    mesh = ShardMesh([CPU] * 4, timeout=60.0)
    waited = []

    def body(ax, x):
        if ax.index == 2:
            raise ValueError("shard 2 failed")
        waited.append(ax.index)
        return ax.psum(x)   # the others wait here until the abort

    try:
        with pytest.raises(ValueError, match="shard 2 failed"):
            mesh.run(body, Sharded(torch.ones(3) for _ in range(4)))
        assert sorted(waited) == [0, 1, 3]
        # the mesh runs on after a failed step
        out = mesh.run(lambda ax, x: ax.psum(x), torch.ones(3))
        assert all(torch.equal(r, torch.full((3,), 4.0)) for r in out)
    finally:
        mesh.close()


def test_a_shard_that_skips_a_collective_breaks_it_after_the_timeout():
    mesh = ShardMesh([CPU] * 2, timeout=0.5)

    def body(ax, x):
        return x if ax.index == 1 else ax.psum(x)

    try:
        with pytest.raises(threading.BrokenBarrierError):
            mesh.run(body, torch.ones(2))
    finally:
        mesh.close()


def test_merge_keeps_the_lower_shard_among_equal_scores():
    """_merge_topk's order equals lax.top_k over the gathered flat (B,
    D * k) row: equal scores come lower shard first, and a shard's own
    ties lower slot first."""
    D, k = 4, 3
    rows = [torch.tensor([[5.0, 7.0, 5.0, 1.0, 7.0, 2.0]]) for _ in range(D)]
    mesh = ShardMesh([CPU] * D)
    try:
        out = mesh.run(lambda ax, s: _merge_topk(ax, s, k), Sharded(rows))
    finally:
        mesh.close()
    vals, ids = (t.numpy() for t in out[0])
    local_v, local_i = jax.lax.top_k(jnp.asarray(rows[0].numpy()), k)
    flat_v = jnp.concatenate([local_v] * D, axis=1)
    flat_i = jnp.concatenate([local_i * D + s for s in range(D)], axis=1)
    want_v, sel = jax.lax.top_k(flat_v, k)
    np.testing.assert_array_equal(vals, np.asarray(want_v))
    np.testing.assert_array_equal(
        ids, np.asarray(jnp.take_along_axis(flat_i, sel, axis=1)))
    assert list(ids[0]) == [1 * D + 0, 4 * D + 0, 1 * D + 1]
    assert all(torch.equal(o[1], out[0][1]) for o in out)
