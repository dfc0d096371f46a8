"""Shared runner of the port's mesh tests (`test_torch_parallel.py` and
`test_torch_sharded_*.py`).

`run(pkg, shards, docs, steps)` builds a runtime of the JAX package
(`pkg="jax"`, its mesh over JAX's virtual CPU devices) or of the port
(`pkg="torch"`, its mesh over `[device] * shards`, the CPU by
default), inserts `docs` into
collection "c" / index "main", commits, runs `steps` and returns their
results as plain summaries (hit ids and scores, counts, facets, groups),
so that one package's run compares with the other's after both runtimes
are stopped. A step is one of:

- ("search", [query JSON, ...]) and ("batch", [query JSON, ...]):
  ReadSide.search / search_batch, one summary a query;
- ("commit", None), ("delete", [doc id, ...]), ("insert", [doc, ...]);
- ("ivf", None): the index's IVF layout (JAX), returned as a step result;
- ("set_ivf", layout): the port index takes the JAX layout in place of
  its own (the two packages cluster with their own k-means);
- ("call", fn): fn(orama, coll), its return value the step's result.

`pruning`, `batch` (documents an insert) and `monkey` (a list of
(object, attribute, value) set while the runtime runs) shape the run.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

MASTER = "mk"


def _pkg(pkg):
    if pkg == "jax":
        from oramacore_tpu import config, runtime, types
    else:
        from oramacore_tpu_torch import config, runtime, types
    return config, runtime, types


def summarize(res) -> dict:
    return dict(
        ids=[h.id for h in res.hits],
        scores=[float(h.score) for h in res.hits],
        count=int(res.count),
        estimated=bool(getattr(res, "count_estimated", False)),
        facets={k: dict(v.values) for k, v in (res.facets or {}).items()},
        groups={tuple(g.values): [(h.id, float(h.score)) for h in g.result]
                for g in (res.groups or [])},
    )


def run(pkg, shards, docs, steps, pruning="auto", batch=100, monkey=(),
        device="cpu"):
    config, runtime, types = _pkg(pkg)
    saved = [(m, n, getattr(m, n)) for m, n, _ in monkey]
    for m, n, v in monkey:
        setattr(m, n, v)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = config.OramacoreConfig()
            cfg.data_dir = tmp
            cfg.auth.master_api_key = MASTER
            cfg.writer_side.insert_batch_commit_size = 10_000_000
            cfg.reader_side.insert_batch_commit_size = 10_000_000
            cfg.reader_side.sharded_shards = shards
            cfg.reader_side.pruning = pruning
            kw = {}
            if pkg == "torch":
                kw = dict(device=device, mesh_devices=(
                    [torch.device(device)] * shards if shards > 1
                    else None))
            orama = runtime.build_orama(cfg, sync_embeddings=True,
                                        start_consumer=False, **kw)
            try:
                ws, rs = orama.write_side, orama.read_side
                coll = ws.create_collection(MASTER, "c")
                ws.create_index("c", coll.write_api_key, "main")
                for s in range(0, len(docs), batch):
                    ws.insert_documents("c", "main", coll.write_api_key,
                                        docs[s:s + batch])
                ws.embedding_queue.flush_and_wait()
                rs.pump()
                assert (rs.sharded_mesh is not None) == (shards > 1)
                out = []
                for kind, arg in steps:
                    out.append(_step(kind, arg, orama, coll, types))
                return out
            finally:
                orama.stop()
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _index(orama):
    return next(iter(orama.read_side.collections["c"].indexes.values()))


def _step(kind, arg, orama, coll, types):
    rs = orama.read_side
    SP = types.SearchParams
    if kind == "search":
        return [summarize(rs.search("c", coll.read_api_key,
                                    SP.from_json(dict(q)))) for q in arg]
    if kind == "batch":
        return [summarize(r) for r in rs.search_batch(
            "c", coll.read_api_key, [SP.from_json(dict(q)) for q in arg])]
    if kind == "commit":
        rs.commit(force=True)
        return None
    if kind == "insert":
        orama.write_side.insert_documents("c", "main", coll.write_api_key,
                                          arg)
        orama.write_side.embedding_queue.flush_and_wait()
        rs.pump()
        return None
    if kind == "delete":
        orama.write_side.delete_documents("c", "main", coll.write_api_key,
                                          arg)
        rs.pump()
        return None
    if kind == "ivf":
        ivf = _index(orama).vector._ivf
        assert ivf is not None, "IVF mode must engage"
        return {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                for k, v in ivf.items()}
    if kind == "set_ivf":
        vec = _index(orama).vector
        assert vec._ivf is not None, "IVF mode must engage"
        vec._ivf = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
                    for k, v in arg.items()}
        vec._gen += 1
        return None
    if kind == "call":
        return arg(orama, coll)
    raise ValueError(kind)


def assert_hits_match(a: dict, b: dict, q=None, tol=1e-4, counts=True):
    """Ranked parity of two summaries allowing id swaps among TIED scores
    (tied docs have no canonical order across kernel shapes): scores
    within tol, the same id set in every run of near-equal scores that
    the page does not cut (a run reaching the page's end, or, under an
    offset, its start, may hold other members of the tie)."""
    sa, sb = a["scores"], b["scores"]
    assert len(sa) == len(sb), (q, a["ids"], b["ids"], sa, sb)
    assert np.allclose(sa, sb, rtol=tol, atol=tol), (q, sa, sb)
    offset = int(q.get("offset", 0)) if isinstance(q, dict) else 0
    i, K = 0, len(sa)
    while i < K:
        j = i
        while j + 1 < K and abs(sa[j + 1] - sa[i]) <= tol * max(
                abs(sa[i]), 1.0):
            j += 1
        if j < K - 1 and not (i == 0 and offset > 0):
            assert set(a["ids"][i:j + 1]) == set(b["ids"][i:j + 1]), (
                q, i, j, a["ids"], b["ids"])
        i = j + 1
    if counts:
        assert a["count"] == b["count"], (q, a["count"], b["count"])


def assert_groups_match(a: dict, b: dict, q=None, tol=1e-3):
    """Group labels equal; each group's ranked page as assert_hits_match."""
    assert set(a["groups"]) == set(b["groups"]), (q, a["groups"],
                                                  b["groups"])
    for key in a["groups"]:
        pa, pb = a["groups"][key], b["groups"][key]
        assert_hits_match(
            dict(ids=[d for d, _ in pa], scores=[s for _, s in pa]),
            dict(ids=[d for d, _ in pb], scores=[s for _, s in pb]),
            (q, key), tol=tol, counts=False)
