"""Batched (shared term-dedup) search over the port's mesh, on the CPU:
the bodies of `tests/test_sharded_batch.py` on the same corpora.

`search_batch` rides `parallel.engine.ShardedBatchExec` (per-shard shared
scoring with psum'd global df, finalize + all_gather top-k; hybrid tails
over the flat and the int8/IVF vector layouts) and the mesh's fused sort.
Each runtime runs once per module: JAX's mesh and the port's at D = 2
and 4, and the port's single-device read side; the port's mesh is held
to both (ids outside near-ties, scores rtol 1e-4, counts exact; the int8
hybrid's counts within the tie members its V-boundary admits, as in
JAX's test). The IVF cases run the port on JAX's own IVF layout.
"""

from __future__ import annotations

import pytest

import oramacore_tpu.index.vector_index as jax_vi
import oramacore_tpu_torch.index.vector_index as port_vi

from . import test_sharded_batch as jax_suite
from .torch_mesh_cases import assert_hits_match, run

FT_BATCH = jax_suite.FT_BATCH
HY_BATCH = jax_suite.HY_BATCH
FILTERED = [
    {"term": "orange banana", "where": {"n": {"gt": 3}}, "limit": 6},
    {"term": "apple grape", "where": {"n": {"lte": 2}}, "limit": 6},
    {"term": "cherry", "limit": 4},
]
SORTED = [
    {"term": "orange banana", "limit": 8,
     "sort_by": {"property": "n", "order": "asc"}},
    {"term": "apple", "limit": 8, "offset": 2,
     "sort_by": {"property": "n", "order": "asc"}},
    {"term": "cherry grape", "limit": 8, "where": {"n": {"lt": 5}},
     "sort_by": {"property": "n", "order": "asc"}},
]
BATCHES = {"fulltext": FT_BATCH, "filtered": FILTERED, "sorted": SORTED,
           "hybrid flat": HY_BATCH}
SHARDS = (2, 4)
IVF = [(jax_vi, "IVF_MIN_ROWS", 400), (jax_vi, "IVF_NPROBE", 16),
       (port_vi, "IVF_MIN_ROWS", 400), (port_vi, "IVF_NPROBE", 16)]


def _engaged(orama, coll):
    return getattr(orama.read_side, "_shared_executor_sharded",
                   None) is not None


@pytest.fixture(scope="module")
def results():
    docs = jax_suite._docs(220)
    steps = [("commit", None)] + [("batch", b) for b in BATCHES.values()]
    out = {("torch", 0): run("torch", 0, docs, steps)}
    for d in SHARDS:
        out[("jax", d)] = run("jax", d, docs, steps)
        out[("torch", d)] = run("torch", d, docs,
                                steps + [("call", _engaged)])
    return out


def _int8_engaged(orama, coll):
    """The mesh's batch executor holds an int8 probe partition."""
    ex = orama.read_side._shared_executor_sharded
    return any(isinstance(k[0], str) for k in ex._vecs._d)


@pytest.fixture(scope="module")
def int8_results():
    docs = jax_suite._docs(600)
    out = {}
    layout = None
    for d in SHARDS:
        jax_r = run("jax", d, docs, [("commit", None), ("ivf", None),
                                     ("batch", HY_BATCH)], monkey=IVF)
        out[("jax", d)] = jax_r[2]
        layout = jax_r[1]
        out[("torch", d)] = run(
            "torch", d, docs, [("commit", None), ("set_ivf", layout),
                               ("batch", HY_BATCH), ("call", _int8_engaged)],
            monkey=IVF)[2:]
    out[("torch", 0)] = run(
        "torch", 0, docs, [("commit", None), ("set_ivf", layout),
                           ("batch", HY_BATCH)], monkey=IVF)[2:]
    return out


@pytest.mark.parametrize("kind", list(BATCHES))
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_batch_parity(results, shards, kind):
    """The port's mesh against JAX's mesh at the same D and against the
    port's single device."""
    i = 1 + list(BATCHES).index(kind)
    mesh = results[("torch", shards)]
    assert mesh[-1], "the sharded batch executor did not engage"
    for ref in (results[("jax", shards)], results[("torch", 0)]):
        for q, a, b in zip(BATCHES[kind], ref[i], mesh[i]):
            assert_hits_match(a, b, q)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_batch_hybrid_int8_parity(int8_results, shards):
    """The int8/IVF layout shards by probe unit (ensure_vectors_int8):
    hits within tolerance of JAX's mesh and of the port's single device
    on the same layout; counts within the tie members the V-boundary
    admits (docs with one word set embed identically)."""
    mesh, engaged = int8_results[("torch", shards)]
    assert engaged, "the mesh did not take the int8 probe partition"
    for ref in (int8_results[("jax", shards)],
                int8_results[("torch", 0)][0]):
        for q, a, b in zip(HY_BATCH, ref, mesh):
            assert_hits_match(a, b, q, counts=False)
            assert abs(a["count"] - b["count"]) <= 4, q
