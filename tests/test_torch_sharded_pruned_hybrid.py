"""The pruned HYBRID over the port's mesh (`ShardedStringExec.
search_topk_hybrid_int8_pruned`, the mesh's hybrid facets), on the CPU:
the bodies of `tests/test_sharded_pruned_hybrid.py` on its corpus.

Full-text candidates nominate per doc shard, the IVF probe scans units on
their round-robin owners, the global top-V rows route to their doc % D
owner, and BM25F and cosine are both exact on each shard's candidate
union, fused under a pmax'd span. Each runtime runs once per module with
pruning "on", at the int8/IVF tier (IVF_MIN_ROWS and IVF_NPROBE shrunk in
both packages): JAX's mesh at D = 2 and 4, and the port's mesh at the
same D and on one device, the port on JAX's own IVF layout (the packages
cluster with their own k-means). The port's mesh is held to JAX's mesh
and to its single device (ids outside near-ties, scores within 2e-3,
facets exact).
"""

from __future__ import annotations

import pytest

import oramacore_tpu.index.vector_index as jax_vi
import oramacore_tpu_torch.index.vector_index as port_vi
from oramacore_tpu_torch.parallel import engine as eng

from . import test_sharded_pruned_hybrid as jax_suite
from .torch_mesh_cases import assert_hits_match, run

DOCS = jax_suite.DOCS
QUERIES = jax_suite.QUERIES
FILTERED = [{"mode": "hybrid", "term": "apple", "similarity": 0.3,
             "limit": 10, "where": {"n": {"lt": 350}}}]
FACETS = [
    {"mode": "hybrid", "term": "apple banana", "similarity": 0.45,
     "limit": 10, "facets": {"n": {"ranges": [
         {"from": 0, "to": 300}, {"from": 300, "to": 700}]}}},
    {"mode": "hybrid", "term": "mango kiwi lemon", "similarity": 0.5,
     "limit": 10, "where": {"n": {"lt": 350}},
     "facets": {"n": {"ranges": [{"from": 0, "to": 699}]}}},
]
EXACT = [{"mode": "hybrid", "term": "apple", "similarity": 0.3,
          "limit": 10, "exactCount": True},
         {"mode": "hybrid", "term": "fig grape", "similarity": 0.3,
          "limit": 10, "exactCount": True}]
CASES = [("search", QUERIES), ("search", FILTERED), ("search", FACETS),
         ("batch", QUERIES), ("search", EXACT), ("batch", EXACT)]
IVF = [(jax_vi, "IVF_MIN_ROWS", 600), (jax_vi, "IVF_NPROBE", 10_000),
       (port_vi, "IVF_MIN_ROWS", 600), (port_vi, "IVF_NPROBE", 10_000)]
SHARDS = (2, 4)


def _spies():
    seen = {"masks": [], "vec": []}
    hy = eng.ShardedStringExec.search_topk_hybrid_int8_pruned
    fc = eng.ShardedStringExec.facet_counts_pruned

    def hybrid(self, *a, **kw):
        seen["masks"].append(kw.get("mask") is not None)
        return hy(self, *a, **kw)

    def facets(self, *a, **kw):
        seen["vec"].append(kw.get("vec") is not None)
        return fc(self, *a, **kw)

    return seen, [
        (eng.ShardedStringExec, "search_topk_hybrid_int8_pruned", hybrid),
        (eng.ShardedStringExec, "facet_counts_pruned", facets)]


@pytest.fixture(scope="module")
def results():
    out = {}
    layout = None
    for d in SHARDS:
        jax_r = run("jax", d, DOCS, [("commit", None), ("ivf", None)]
                    + CASES, pruning="on", monkey=IVF, batch=700)
        layout = jax_r[1]
        out[("jax", d)] = jax_r[2:]
        seen, monkey = _spies()
        out[("torch", d)] = run(
            "torch", d, DOCS, [("commit", None), ("set_ivf", layout)]
            + CASES, pruning="on", monkey=IVF + monkey, batch=700)[2:]
        out[("spies", d)] = seen
    out[("torch", 0)] = run(
        "torch", 0, DOCS, [("commit", None), ("set_ivf", layout)] + CASES,
        pruning="on", monkey=IVF, batch=700)[2:]
    return out


def _held(results, shards, i, queries):
    for ref in (results[("jax", shards)], results[("torch", 0)]):
        for q, a, b in zip(queries, ref[i], results[("torch", shards)][i]):
            assert_hits_match(a, b, q, tol=2e-3, counts=False)
            assert a["facets"] == b["facets"], q
            yield q, a, b


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_hybrid_matches_single_device(results, shards):
    engaged = 0
    for q, a, b in _held(results, shards, 0, QUERIES):
        if b["ids"]:
            engaged += 1
            # both rode the pruned kernels: counts are flagged
            assert a["estimated"] and b["estimated"], q
    assert engaged >= 6
    assert results[("spies", shards)]["masks"]


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_hybrid_filtered_rides_pruned_mesh(results, shards):
    """A small filter becomes the per-shard candidate lists: results and
    counts exact (no estimate flag), no out-of-filter doc."""
    for q, a, b in _held(results, shards, 1, FILTERED):
        assert b["ids"] and not b["estimated"], q
        assert all(int(i.split(":")[-1]) < 350 for i in b["ids"])
        assert a["count"] == b["count"], q
    assert any(results[("spies", shards)]["masks"])


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_hybrid_facets_parity(results, shards):
    """The probe's owned top-V docs join each shard's full-text reps
    (_get_facet_vec_reps_step); the psum'd histograms equal the single
    device's and JAX's mesh's."""
    for q, a, b in _held(results, shards, 2, FACETS):
        assert b["facets"], q
    vec = results[("spies", shards)]["vec"]
    assert vec and all(vec), vec


@pytest.mark.parametrize("shards", SHARDS)
def test_batched_pruned_hybrid_matches_per_query(results, shards):
    """Hybrid batches at the IVF tier ride the pruned candidate-union
    step in one dispatch on the mesh; each equals its per-query twin."""
    mesh = results[("torch", shards)]
    list(_held(results, shards, 3, QUERIES))
    for q, a, b in zip(QUERIES, mesh[0], mesh[3]):
        assert_hits_match(a, b, q, tol=2e-3, counts=False)
        if b["ids"]:
            assert b["estimated"], q


@pytest.mark.parametrize("shards", SHARDS)
def test_hybrid_exact_count_takes_dense_path(results, shards):
    """exactCount keeps the hybrid on the dense exact path, per query and
    in batches, on the mesh as on one device: unflagged counts."""
    for i in (4, 5):
        for q, a, b in _held(results, shards, i, EXACT):
            assert b["ids"] and not b["estimated"], q
            assert a["count"] == b["count"], q
