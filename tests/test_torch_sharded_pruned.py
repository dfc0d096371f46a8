"""The pruned tier over the port's mesh (`ShardedStringExec.
search_topk_pruned`, `facet_counts_pruned`, the exact-counts step), on
the CPU: the bodies of `tests/test_sharded_pruned.py` on its corpus.

One corpus carries every field those bodies add (`n`, `flag`, `tags`,
`sizes`); each runtime runs once per module: JAX's mesh and the port's at
D = 2 and 4 with pruning "on", and the port's single-device read side
with pruning "off" (the dense reference). The port's mesh is held to the
dense single device (ids outside near-ties, scores rtol 1e-4, exact
counts where the mesh reports them exact, facet counts exact) and to
JAX's mesh (scores within 2e-3, where JAX's worklist sums differ, counts
and their estimated flag equal, facets exact).
"""

from __future__ import annotations

import pytest

from oramacore_tpu_torch.index import search_exec as se
from oramacore_tpu_torch.index.search_exec import PrunedPlanMixin as PM
from oramacore_tpu_torch.ops import pruned as prmod
from oramacore_tpu_torch.parallel import engine as eng

from . import test_sharded_pruned as jax_suite
from .torch_mesh_cases import assert_hits_match, run

VOCAB = jax_suite.VOCAB
DOCS = []
for _i, _d in enumerate(jax_suite.DOCS):
    _d = dict(_d)
    _d["n"] = _i % 7
    _d["flag"] = bool(_i % 2)
    _d["tags"] = ["x", "y", "x"] if _i % 2 else ["x"]
    _d["sizes"] = [_i % 5, (_i % 5) + 3]
    DOCS.append(_d)

QUERIES = jax_suite.QUERIES
EXACT = [
    {"term": "apple banana", "limit": 10},
    {"term": "cherry", "limit": 10},
    {"term": "apple", "limit": 10, "exact": True},
    {"term": "apple banana cherry", "limit": 10, "threshold": 0.6},
]
FILTERED = [
    {"term": "apple banana", "limit": 10, "where": {"n": {"lt": 4}}},
    {"term": "cherry grape", "limit": 10, "where": {"n": {"eq": 2}}},
    {"term": "apple banana fig", "limit": 10, "threshold": 0.6,
     "where": {"n": {"lt": 5}}},
]
FACETS = [
    {"term": "apple banana", "limit": 10, "facets": {
        "n": {"ranges": [{"from": 0, "to": 2}, {"from": 2, "to": 4}]},
        "flag": {"true": True, "false": True}}},
    {"term": "aple", "tolerance": 1, "limit": 10,
     "facets": {"flag": {"true": True, "false": True}}},
    {"term": "apple banana", "threshold": 1.0, "limit": 10,
     "facets": {"flag": {"true": True, "false": True}}},
    {"term": "apple banana", "limit": 10, "facets": {
        "tags": {},
        "sizes": {"ranges": [{"from": 0, "to": 3}, {"from": 4, "to": 7}]}}},
]
BATCH = [
    {"term": "apple banana", "limit": 10},
    {"term": "cherry", "limit": 10},
    {"term": "grape kiwi", "limit": 8},
]
SLICED = [{"term": f"{VOCAB[i % 16]} {VOCAB[(i + 3) % 16]}", "limit": 5,
           "exactCount": True}
          for i in range(2 * PM.PRUNED_COUNTS_SLICE + 4)]
GONE = [str(i) for i in range(0, 400, 9)]
EXTRA = [{"id": f"x{i}", "title": "apple banana zulu",
          "body": "banana cherry"} for i in range(20)]
LIVE = [{"term": "apple banana", "limit": 15}, {"term": "zulu", "limit": 10}]
AFTER = [{"term": "apple banana", "limit": 20}] + FACETS[:1]

STEPS = [
    ("commit", None),
    ("search", QUERIES),                                          # 1
    ("search", [{**q, "exactCount": True} for q in EXACT]),       # 2
    ("search", FILTERED),                                         # 3
    ("search", FACETS),                                           # 4
    ("batch", BATCH),                                             # 5
    ("batch", [{**q, "exactCount": True} for q in BATCH]),        # 6
    ("batch", SLICED),                                            # 7
    ("delete", GONE),
    ("search", AFTER),                                            # 9
    ("commit", None),
    ("insert", EXTRA),
    ("search", LIVE),                                             # 12
]
SHARDS = (2, 4)
# single-device runs of the cases the mesh sends as exactCount: the
# dense reference gets the plain query
REF_STEPS = [(k, [{kk: vv for kk, vv in q.items() if kk != "exactCount"}
                  for q in a] if k in ("search", "batch") else a)
             for k, a in STEPS]


def _spies():
    seen = {"pruned": [], "facets": [], "multi": [], "slices": []}
    orig = {n: getattr(eng.ShardedStringExec, n) for n in (
        "search_topk_pruned", "facet_counts_pruned",
        "_get_facet_hist_multi_step", "_get_pruned_counts_step")}

    def pruned(self, *a, **kw):
        seen["pruned"].append(kw.get("mask") is not None)
        return orig["search_topk_pruned"](self, *a, **kw)

    def facets(self, *a, **kw):
        seen["facets"].append(True)
        return orig["facet_counts_pruned"](self, *a, **kw)

    def multi(self, *a, **kw):
        seen["multi"].append(True)
        return orig["_get_facet_hist_multi_step"](self, *a, **kw)

    def counts(self, **kw):
        body = orig["_get_pruned_counts_step"](self, **kw)

        def wrapped(ax, p_doc, p_tf, p_etf, wl, thr, fm):
            if ax.index == 0:
                seen["slices"].append(int(thr.shape[0]))
            return body(ax, p_doc, p_tf, p_etf, wl, thr, fm)

        return wrapped

    monkey = [(eng.ShardedStringExec, "search_topk_pruned", pruned),
              (eng.ShardedStringExec, "facet_counts_pruned", facets),
              (eng.ShardedStringExec, "_get_facet_hist_multi_step", multi),
              (eng.ShardedStringExec, "_get_pruned_counts_step", counts)]
    return seen, monkey


@pytest.fixture(scope="module")
def results():
    out = {("torch", 0): run("torch", 0, DOCS, REF_STEPS, pruning="off")}
    for d in SHARDS:
        out[("jax", d)] = run("jax", d, DOCS, STEPS, pruning="on")
        seen, monkey = _spies()
        out[("torch", d)] = run("torch", d, DOCS, STEPS, pruning="on",
                                monkey=monkey)
        out[("spies", d)] = seen
    return out


def _pairs(results, shards, i, queries):
    return zip(queries, results[("torch", 0)][i],
               results[("jax", shards)][i], results[("torch", shards)][i])


def _hold(q, dense, jax_mesh, mesh, exact_count):
    assert_hits_match(dense, mesh, q, counts=False)
    assert_hits_match(jax_mesh, mesh, q, tol=2e-3, counts=False)
    assert (jax_mesh["count"], jax_mesh["estimated"]) == \
        (mesh["count"], mesh["estimated"]), q
    assert jax_mesh["facets"] == mesh["facets"] == dense["facets"], q
    if exact_count:
        assert mesh["count"] == dense["count"] and not mesh["estimated"], q
    else:
        assert mesh["count"] >= len(mesh["ids"]), q


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_matches_single_device_dense(results, shards):
    engaged = 0
    for q, a, j, b in _pairs(results, shards, 1, QUERIES):
        _hold(q, a, j, b, exact_count=not b["estimated"])
        engaged += b["estimated"]
    assert engaged >= len(QUERIES) - 2


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_exact_counts(results, shards):
    """exactCount on the mesh: psum of shard-disjoint exact counts equals
    the dense single-device count."""
    for q, a, j, b in _pairs(results, shards, 2, EXACT):
        _hold(q, a, j, b, exact_count=True)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_filtered_matches_single_device(results, shards):
    """Filters ride the mesh's pruned step with the doc-sharded mask;
    small filters are the per-shard candidate lists: exact counts."""
    for q, a, j, b in _pairs(results, shards, 3, FILTERED):
        _hold(q, a, j, b, exact_count=True)
    assert any(results[("spies", shards)]["pruned"])


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_facets_parity(results, shards):
    """Per-shard histograms off the sharded reps, psum'd: facet counts
    (single- and multi-valued) equal the dense path; a thresholded
    facet search's count is the exact rep sum."""
    for q, a, j, b in _pairs(results, shards, 4, FACETS):
        _hold(q, a, j, b, exact_count=q.get("threshold") is not None)
    spies = results[("spies", shards)]
    assert spies["facets"] and spies["multi"]


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_batch(results, shards):
    """search_batch rides the sharded pruned step, estimated counts; with
    exactCount the counts step makes them exact, also in slices of
    PRUNED_COUNTS_SLICE queries."""
    for q, a, j, b in _pairs(results, shards, 5, BATCH):
        _hold(q, a, j, b, exact_count=False)
        assert b["estimated"], q
    for i, qs in ((6, BATCH), (7, SLICED)):
        for q, a, j, b in _pairs(results, shards, i, qs):
            _hold(q, a, j, b, exact_count=True)
    slices = results[("spies", shards)]["slices"]
    S = PM.PRUNED_COUNTS_SLICE
    assert slices and S in slices
    assert slices.count(S) >= -(-len(SLICED) // S)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_pruned_tombstones_and_live_layer(results, shards):
    """Tombstones (no where-filter) keep the mesh pruned with the alive
    mask as its filter; then live postings on top of the commit ride
    the clipped-prefix fallback (ends align up to boundaries)."""
    for i, qs in ((9, AFTER), (12, LIVE)):
        for q, a, j, b in _pairs(results, shards, i, qs):
            _hold(q, a, j, b, exact_count=not b["estimated"])
    gone = {f"main:{g}" for g in GONE}
    assert not set(results[("torch", shards)][9][0]["ids"]) & gone


@pytest.fixture(scope="module")
def policy():
    """PRUNED_BS on and off: which generation each stack dispatched."""
    sdocs = [{"id": d["id"], "t": d["title"],
              **({"_omc": d["_omc"]} if "_omc" in d else {})}
             for d in jax_suite.DOCS]
    q = [{"term": "apple banana", "limit": 10}]
    out = {}
    for flag in (True, False):
        calls = []

        def spy(name):
            fn = getattr(prmod, name)
            return lambda *a, **kw: (calls.append(name), fn(*a, **kw))[1]

        def step_spy(orig=eng.ShardedStringExec._get_pruned_step):
            def spy_step(self, **kw):
                calls.append(("mesh", bool(kw.get("use_bs"))))
                return orig(self, **kw)
            return spy_step

        monkey = [(se.PrunedPlanMixin, "PRUNED_BS", flag),
                  (se, "pruned_fulltext_topk_bs",
                   spy("pruned_fulltext_topk_bs")),
                  (se, "pruned_fulltext_topk", spy("pruned_fulltext_topk")),
                  (eng.ShardedStringExec, "_get_pruned_step", step_spy())]
        steps = [("commit", None), ("search", q)]
        single = run("torch", 0, sdocs, steps, pruning="on", monkey=monkey)
        mesh = run("torch", 2, sdocs, steps, pruning="on", monkey=monkey)
        out[flag] = (calls, single[1][0], mesh[1][0])
    return out


@pytest.mark.parametrize("flag", [True, False])
def test_pruned_kernel_generation_policy(policy, flag):
    """The single device and the mesh dispatch the SAME pruned kernel
    generation: v4 (binary-search rescore) with PRUNED_BS, else v3."""
    calls, a, b = policy[flag]
    single = [c for c in calls if isinstance(c, str)]
    mesh = [c for c in calls if not isinstance(c, str)]
    assert single == (["pruned_fulltext_topk_bs"] if flag
                      else ["pruned_fulltext_topk"])
    assert mesh == [("mesh", flag)]
    assert a["ids"] and b["ids"]
    assert_hits_match(a, b, counts=False)
