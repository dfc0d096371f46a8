"""The port's doc-sharded engine (`oramacore_tpu_torch/parallel/engine.py`)
wired into its read side, on the CPU: the bodies of
`tests/test_sharded_engine.py` on the same corpus and queries.

Each runtime runs once per module (`torch_mesh_cases.run`): JAX's mesh at
D = 2 and 4 (its virtual CPU devices), the port's mesh at the same D
(`mesh_devices=[cpu] * D`) and the port's single-device read side. The
port's mesh is held to JAX's mesh (ids outside near-ties, scores rtol
1e-4, counts, facets and groups exact) and to the port's single device
(ids and counts exact, as JAX's test holds its mesh), on the live layer,
after the commit, and for group-by after tombstones; and once over the
port's HTTP server.
"""

from __future__ import annotations

import asyncio
import tempfile

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.parallel import engine as eng

from . import test_sharded_engine as jax_suite
from .torch_mesh_cases import (
    MASTER,
    assert_groups_match,
    assert_hits_match,
    run,
)

DOCS = jax_suite.DOCS
QUERIES = jax_suite.QUERIES
GROUP_QUERIES = [
    {"term": "orange banana",
     "groupBy": {"properties": ["flag"], "maxResults": 4}},
    {"term": "apple", "groupBy": {"properties": ["n"], "maxResults": 3}},
    {"term": "grape melon",
     "groupBy": {"properties": ["flag", "n"], "maxResults": 2}},
]
DELETED = [str(i) for i in range(0, 200, 17)]
STEPS = [("search", QUERIES), ("commit", None), ("search", QUERIES),
         ("delete", DELETED), ("commit", None), ("search", GROUP_QUERIES)]
SHARDS = (2, 4)


@pytest.fixture(scope="module")
def results():
    grouped = []
    orig = eng.ShardedStringExec.search_topk_grouped

    def spy(self, *a, **kw):
        grouped.append(self.D)
        return orig(self, *a, **kw)

    out = {("torch", 0): run("torch", 0, DOCS, STEPS)}
    for d in SHARDS:
        out[("jax", d)] = run("jax", d, DOCS, STEPS)
        out[("torch", d)] = run(
            "torch", d, DOCS, STEPS,
            monkey=[(eng.ShardedStringExec, "search_topk_grouped", spy)])
    out["grouped"] = grouped
    return out


@pytest.mark.parametrize("phase", [0, 2], ids=["live", "committed"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_engine_matches_jax_mesh(results, shards, phase):
    jax_r, port_r = results[("jax", shards)], results[("torch", shards)]
    for q, a, b in zip(QUERIES, jax_r[phase], port_r[phase]):
        assert_hits_match(a, b, q)
        assert a["facets"] == b["facets"], q


@pytest.mark.parametrize("phase", [0, 2], ids=["live", "committed"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_engine_matches_single_device(results, shards, phase):
    single, mesh = results[("torch", 0)], results[("torch", shards)]
    for q, a, b in zip(QUERIES, single[phase], mesh[phase]):
        assert a["count"] == b["count"], q
        assert a["ids"] == b["ids"], q
        np.testing.assert_allclose(b["scores"], a["scores"], rtol=1e-4,
                                   err_msg=str(q))
        assert a["facets"] == b["facets"], q


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_engine_group_by_matches_single_device(results, shards):
    """Termful group-by rides the mesh's grouped step (shard-local
    (gid, -score, doc) sorts + one 2-key merge sort per group): groups,
    per-group pages, main hits and counts equal the single device's and
    JAX's mesh, after tombstones."""
    assert shards in results["grouped"], "mesh grouped step did not engage"
    for ref in (results[("torch", 0)], results[("jax", shards)]):
        for q, a, b in zip(GROUP_QUERIES, ref[5], results[("torch",
                                                            shards)][5]):
            assert a["groups"], q
            assert_groups_match(a, b, q)
            assert a["count"] == b["count"], q


def test_sharded_engine_through_http_api():
    """insert -> commit -> search through the port's HTTP server on a
    4-shard mesh, results identical to the single-device engine."""
    from oramacore_tpu_torch import config as port_config
    from oramacore_tpu_torch import runtime as port_runtime
    from oramacore_tpu_torch import server as port_server
    from oramacore_tpu_torch.types import SearchParams

    from .test_torch_server import PortTestClient, PortTestServer

    def build(tmp, shards):
        cfg = port_config.OramacoreConfig()
        cfg.data_dir = tmp
        cfg.auth.master_api_key = MASTER
        cfg.writer_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.sharded_shards = shards
        orama = port_runtime.build_orama(
            cfg, sync_embeddings=True, start_consumer=False, device="cpu",
            mesh_devices=[torch.device("cpu")] * shards if shards else None)
        coll = orama.write_side.create_collection(MASTER, "c")
        orama.write_side.create_index("c", coll.write_api_key, "main")
        orama.write_side.insert_documents("c", "main", coll.write_api_key,
                                          DOCS)
        orama.write_side.embedding_queue.flush_and_wait()
        orama.read_side.pump()
        orama.read_side.commit(force=True)
        return orama, coll

    async def go():
        with tempfile.TemporaryDirectory() as t1, \
                tempfile.TemporaryDirectory() as t2:
            single, coll_s = build(t1, 0)
            sharded, coll_m = build(t2, 4)
            assert sharded.read_side.sharded_mesh is not None
            srv = port_server.ApiServer(sharded.config, sharded.write_side,
                                        sharded.read_side)
            tc = PortTestClient(PortTestServer(srv.app))
            await tc.start_server()
            try:
                for q in QUERIES:
                    resp = await tc.post(
                        "/v1/collections/c/search", json=dict(q),
                        headers={"Authorization":
                                 f"Bearer {coll_m.read_api_key}"})
                    assert resp.status == 200, await resp.text()
                    body = await resp.json()
                    ref = single.read_side.search(
                        "c", coll_s.read_api_key,
                        SearchParams.from_json(dict(q)))
                    assert [h["id"] for h in body["hits"]] == \
                        [h.id for h in ref.hits], q
                    assert body["count"] == ref.count, q
            finally:
                await tc.close()
                single.stop()
                sharded.stop()

    asyncio.run(go())
