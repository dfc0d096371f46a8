"""The port's runtime held to the JAX package's on the CPU, end to end.

The same seeded documents go through the JAX `build_orama` (as
`tests/utils.py` builds it) and the port's `build_orama(device="cpu")`:
3,000 documents of `benches/ingest_bench.documents` in a `games`
collection, and hand-made documents with dates, geo points, bools and
arrays in a two-index `shop` collection that then takes deletes, updates
and an index replacement. The same `SearchParams` JSON goes through
`ReadSide.search` and `ReadSide.search_batch` of both, in four states: the
live layer before any commit, after a commit, after a reload, and after a
reload with `reader_side.pruning = "on"`. Answers agree as
`chip_smoke.rs_result_errors` holds them on the card:

- hit ids are equal, outside near-ties (scores within 1e-5 relative,
  which either package may order its own way, and which may swap docs
  across the page's end);
- scores agree within rtol 1e-4;
- `count` and `count_estimated` are equal;
- facet counts and group labels are equal;
- the hydrated documents of equal ids are equal.

Besides, the JAX write side's op stream, taken from its in-memory
transport and turned into the port's `Operation`s, is applied by a port
`ReadSide`, which then answers as JAX does; and the port's write side
emits the JAX write side's op bodies for the same calls.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import pytest

from chip_smoke import rs_result_errors
from oramacore_tpu import config as jax_config
from oramacore_tpu import runtime as jax_runtime
from oramacore_tpu import types as jax_types
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import runtime as port_runtime
from oramacore_tpu_torch import types as port_types
from oramacore_tpu_torch.benches import ingest_bench as ib
from oramacore_tpu_torch.embeddings import EmbeddingsService
from oramacore_tpu_torch.oplog import InMemoryTransport, Operation
from oramacore_tpu_torch.read import ReadSide
from oramacore_tpu_torch.utils.tokenizer import NLPService

N_GAMES = 3_000
MASTER = "master"
KEYS = {"games": ("games-read", "games-write"),
        "shop": ("shop-read", "shop-write")}


# ---------------------------------------------------------------------------
# the corpus and the searches
# ---------------------------------------------------------------------------

def _corpus():
    words, stems = ib.vocabulary(3_000, seed=15)
    games = ib.documents(N_GAMES, seed=15, words=words)
    qs = ib.queries(stems, 24, seed=16)
    return games, qs


def _shop_docs():
    rng = np.random.default_rng(7)
    colors = ["red", "green", "blue", "black"]
    docs = []
    for i in range(60):
        docs.append({
            "id": f"s{i}",
            "name": f"{colors[i % 4]} shirt model {i % 9} cotton",
            "color": colors[i % 4],
            "tags": [colors[(i + k) % 4] + "-tag" for k in range(i % 3)],
            "sizes": [float(s) for s in range(i % 4)],
            "in_stock": bool(i % 3),
            "added": f"2024-0{1 + i % 9}-1{i % 10}T10:00:00Z",
            "where": {"lat": 45.0 + float(rng.uniform(-1, 1)),
                      "lon": 9.0 + float(rng.uniform(-1, 1))},
            "rating": int(rng.integers(1, 6)),
            "_omc": 1.0 + (i % 5) / 10,
        })
    return docs


def _price_ranges():
    return [{"from": a, "to": a + 10} for a in range(0, 80, 10)]


def _single_cases(qs) -> Dict[str, Tuple[str, Dict[str, Any]]]:
    g = ib.GENRES
    cases: Dict[str, Tuple[str, Dict[str, Any]]] = {}
    for i in range(6):
        cases[f"fulltext_{i}"] = ("games", {"term": qs[i]})
    cases.update({
        "page_2": ("games", {"term": qs[6], "limit": 5, "offset": 5}),
        "where_price": ("games", {"term": qs[7],
                                  "where": {"price": {"between": [10, 40]}}}),
        "where_genre": ("games", {"term": qs[8], "where": {"genre": g[3]}}),
        "where_both": ("games", {"term": qs[9], "where": {
            "genre": [g[1], g[5], g[9]], "price": {"lt": 50}}}),
        "where_or_not": ("games", {"term": qs[10], "where": {"or": [
            {"genre": g[2]}, {"not": {"price": {"gte": 20}}}]}}),
        "facets": ("games", {"term": qs[11], "facets": {
            "genre": {}, "price": {"ranges": _price_ranges()}}}),
        "facets_filtered": ("games", {
            "term": qs[12], "where": {"price": {"gt": 30}},
            "facets": {"genre": {}, "price": {"ranges": _price_ranges()}}}),
        "sort_asc": ("games", {"term": qs[13], "limit": 20, "sortBy": {
            "property": "price", "order": "asc"}}),
        "sort_desc": ("games", {"term": qs[14], "limit": 20, "sortBy": {
            "property": "price", "order": "desc"}}),
        "group_by": ("games", {"term": qs[15], "groupBy": {
            "properties": ["genre"], "maxResults": 3}}),
        "tolerance": ("games", {"term": qs[16], "tolerance": 1}),
        "exact": ("games", {"term": qs[17], "exact": True}),
        "threshold": ("games", {"term": qs[18], "threshold": 1.0}),
        "phrase_boost": ("games", {"term": qs[19], "phraseBoost": 2.0}),
        "exact_count": ("games", {"term": qs[20], "exactCount": True}),
        "pinned": ("games", {"term": "pinned " + qs[21]}),
        "boost_props": ("games", {"term": qs[22], "properties": ["title"],
                                  "boost": {"title": 2.0}}),
        "match_all_sorted": ("games", {"term": "", "limit": 7,
                                       "where": {"genre": g[4]},
                                       "sortBy": {"property": "price"}}),
        "vector": ("games", {"mode": "vector", "term": qs[0],
                             "similarity": 0.2}),
        "vector_filtered": ("games", {"mode": "vector", "term": qs[1],
                                      "similarity": 0.2,
                                      "where": {"price": {"lt": 40}}}),
        "hybrid": ("games", {"mode": "hybrid", "term": qs[2],
                             "similarity": 0.2}),
        "hybrid_facets": ("games", {"mode": "hybrid", "term": qs[3],
                                    "similarity": 0.2,
                                    "facets": {"genre": {}}}),
        # group-by takes the hybrid off the fused kernel: host fusion
        "hybrid_group_by": ("games", {"mode": "hybrid", "term": qs[4],
                                      "similarity": 0.2, "groupBy": {
                                          "properties": ["genre"],
                                          "maxResults": 2}}),
        "shop_fulltext": ("shop", {"term": "red cotton shirt"}),
        "shop_date": ("shop", {"term": "shirt", "limit": 20, "where": {
            "added": {"gte": "2024-04-01T00:00:00Z"}}}),
        "shop_geo": ("shop", {"term": "shirt", "limit": 30, "where": {
            "where": {"radius": {"coordinates": {"lat": 45.0, "lon": 9.0},
                                 "unit": "km", "value": 60}}}}),
        "shop_bool_array": ("shop", {"term": "shirt", "where": {
            "in_stock": True, "tags": "red-tag"}}),
        "shop_facets": ("shop", {"term": "cotton", "facets": {
            "tags": {}, "in_stock": {"true": True, "false": True},
            "sizes": {"ranges": [{"from": 0, "to": 1},
                                 {"from": 2, "to": 3}]}}}),
        "shop_group_multi": ("shop", {"term": "shirt", "groupBy": {
            "properties": ["tags"], "maxResults": 2}}),
        "shop_sort_rating": ("shop", {"term": "model", "limit": 15,
                                      "sortBy": {"property": "rating",
                                                 "order": "desc"}}),
        "shop_one_index": ("shop", {"term": "shirt", "indexes": ["extra"]}),
    })
    return cases


def _batch_cases(qs) -> Dict[str, Tuple[str, List[Dict[str, Any]]]]:
    g = ib.GENRES
    return {
        "batch_fulltext": ("games", [{"term": q} for q in qs[:16]]),
        "batch_filtered": ("games", [
            {"term": q, "where": {"genre": g[i % 4]}}
            for i, q in enumerate(qs[:8])]),
        "batch_sorted": ("games", [
            {"term": q, "sortBy": {"property": "price", "order": "desc"}}
            for q in qs[8:16]]),
        "batch_hybrid": ("games", [
            {"mode": "hybrid", "term": q, "similarity": 0.2}
            for q in qs[:8]]),
        "batch_vector": ("games", [
            {"mode": "vector", "term": q, "similarity": 0.2}
            for q in qs[8:16]]),
        "batch_exact_tolerance": ("games", [
            {"term": q, "tolerance": 1} for q in qs[16:20]]),
        "batch_fallback_facets": ("games", [
            {"term": q, "facets": {"genre": {}}} for q in qs[20:23]]),
        "batch_shop_multi_index": ("shop", [
            {"term": t} for t in ("red shirt", "cotton", "model 3")]),
    }


# ---------------------------------------------------------------------------
# the two runtimes
# ---------------------------------------------------------------------------

class Side:
    """One package's runtime: config module, build function, types."""

    def __init__(self, pkg: str, data_dir: str, pruning: str = "auto"):
        self.pkg = pkg
        self.data_dir = data_dir
        cfg_mod = jax_config if pkg == "jax" else port_config
        cfg = cfg_mod.OramacoreConfig()
        cfg.data_dir = data_dir
        cfg.auth.master_api_key = MASTER
        cfg.writer_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.pruning = pruning
        kw = dict(sync_embeddings=True, start_consumer=False)
        if pkg == "jax":
            self.orama = jax_runtime.build_orama(cfg, **kw)
            self.types = jax_types
        else:
            self.orama = port_runtime.build_orama(cfg, device="cpu", **kw)
            self.types = port_types

    @property
    def w(self):
        return self.orama.write_side

    @property
    def r(self):
        return self.orama.read_side

    def pump(self):
        self.w.embedding_queue.flush_and_wait()
        self.r.pump()

    def search(self, coll: str, params: Dict[str, Any]):
        self.pump()
        return self.r.search(coll, KEYS[coll][0],
                             self.types.SearchParams.from_json(params))

    def search_batch(self, coll: str, plist: List[Dict[str, Any]]):
        self.pump()
        return self.r.search_batch(
            coll, KEYS[coll][0],
            [self.types.SearchParams.from_json(p) for p in plist])

    def commit(self):
        self.pump()
        self.w.commit()
        self.r.commit(force=True)


def _populate(side: Side, games, qs):
    w = side.w
    for cid, (rk, wk) in KEYS.items():
        w.create_collection(MASTER, cid, read_api_key=rk, write_api_key=wk)
    w.create_index("games", KEYS["games"][1], "main")
    for lo in range(0, len(games), 1_000):
        w.insert_documents("games", "main", KEYS["games"][1],
                           games[lo:lo + 1_000])
    pin_docs = [games[5]["id"], games[77]["id"]]
    w.insert_pin_rule("games", KEYS["games"][1], {
        "id": "promo",
        "conditions": [{"pattern": "pinned", "anchoring": "contains"}],
        "consequence": {"promote": [
            {"doc_id": pin_docs[0], "position": 0},
            {"doc_id": pin_docs[1], "position": 2}]},
    })
    wk = KEYS["shop"][1]
    w.create_index("shop", wk, "main")
    w.create_index("shop", wk, "extra")
    shop = _shop_docs()
    w.insert_documents("shop", "main", wk, shop[:40])
    w.insert_documents("shop", "extra", wk, shop[40:])
    # deletes, updates and an index replacement
    w.delete_documents("shop", "main", wk, ["s3", "s8", "s13"])
    w.update_documents("shop", "main", wk, [
        dict(shop[5], name="black cotton shirt updated", rating=5)])
    w.create_temporary_index("shop", wk, "extra", temp_index_id="extra-tmp")
    w.insert_documents("shop", "extra-tmp", wk,
                       [dict(d, name=d["name"] + " v2") for d in shop[40:55]])
    w.replace_index("shop", wk, "extra", "extra-tmp")
    side.pump()


def _answers(side: Side, singles, batches, only=None):
    out = {}
    for name, (coll, p) in singles.items():
        if only is None or name in only:
            out[name] = [side.search(coll, p)]
    for name, (coll, plist) in batches.items():
        if only is None or name in only:
            out[name] = side.search_batch(coll, plist)
    return out


# ---------------------------------------------------------------------------
# the run: both packages, four states
# ---------------------------------------------------------------------------

STATES = ("live", "committed", "reloaded", "pruned")
# the pruned reload runs one case of each kind: every pruned shape
# compiles anew in JAX, and fuzzy (tolerance) plans walk every variant
# span per posting in the plain worklist (tests/test_torch_pruned_exec.py
# holds those at a smaller size)
PRUNED_CASES = (
    "fulltext_0", "fulltext_1", "where_price", "where_genre", "facets",
    "exact", "exact_count", "threshold", "hybrid", "shop_facets",
    "batch_fulltext", "batch_filtered", "batch_hybrid",
)


@pytest.fixture(scope="module")
def run():
    games, qs = _corpus()
    singles = _single_cases(qs)
    batches = _batch_cases(qs)
    dirs = {p: tempfile.mkdtemp(prefix=f"read-side-{p}-")
            for p in ("jax", "port")}
    sides = {p: Side(p, dirs[p]) for p in dirs}
    for s in sides.values():
        _populate(s, games, qs)
    res: Dict[str, Dict[str, Any]] = {}
    res["live"] = {p: _answers(s, singles, batches) for p, s in sides.items()}
    # the JAX op stream and the port's, before anything else is sent
    jax_ops = list(sides["jax"].w.op_sender._t._log)
    port_ops = list(sides["port"].w.op_sender._t._log)
    for s in sides.values():
        s.commit()
    res["committed"] = {p: _answers(s, singles, batches)
                        for p, s in sides.items()}
    for state, pruning in (("reloaded", "auto"), ("pruned", "on")):
        for p in sides:
            sides[p].orama.stop()
            sides[p] = Side(p, dirs[p], pruning=pruning)
        only = PRUNED_CASES if state == "pruned" else None
        res[state] = {p: _answers(s, singles, batches, only)
                      for p, s in sides.items()}
    for s in sides.values():
        s.orama.stop()
    # the JAX op stream applied by a port read side
    t = InMemoryTransport()
    tx = t.sender()
    for op in jax_ops:
        tx.send(Operation(kind=op.kind, collection=op.collection,
                          body=op.body))
    cfg = port_config.OramacoreConfig()
    cfg.data_dir = tempfile.mkdtemp(prefix="read-side-replay-")
    cfg.reader_side.insert_batch_commit_size = 10_000_000
    replay = ReadSide(cfg, t.receiver, EmbeddingsService(), NLPService(),
                      device="cpu")
    replay.pump()
    res["replayed"] = {}
    for name, (coll, p) in singles.items():
        res["replayed"][name] = [replay.search(
            coll, KEYS[coll][0], port_types.SearchParams.from_json(p))]
    for name, (coll, plist) in batches.items():
        res["replayed"][name] = replay.search_batch(
            coll, KEYS[coll][0],
            [port_types.SearchParams.from_json(p) for p in plist])
    yield dict(res=res, singles=singles, batches=batches,
               jax_ops=jax_ops, port_ops=port_ops)
    for d in list(dirs.values()) + [cfg.data_dir]:
        shutil.rmtree(d, ignore_errors=True)


def _case_errors(run, state, name):
    jax_side = run["res"]["live" if state == "replayed" else state]["jax"]
    port_side = (run["res"]["replayed"] if state == "replayed"
                 else run["res"][state]["port"])
    errs = []
    for qi, (a, b) in enumerate(zip(jax_side[name], port_side[name])):
        errs += rs_result_errors(a, b, f"{state} {name}[{qi}]")
    return errs


SINGLE_NAMES = list(_single_cases(_corpus()[1]))
BATCH_NAMES = list(_batch_cases(_corpus()[1]))


def _pairs(names):
    return [(n, st) for n in names for st in STATES + ("replayed",)
            if st != "pruned" or n in PRUNED_CASES]


@pytest.mark.parametrize("name,state", _pairs(SINGLE_NAMES))
def test_search_agrees_with_jax(run, state, name):
    errs = _case_errors(run, state, name)
    assert not errs, "\n".join(errs[:20])


@pytest.mark.parametrize("name,state", _pairs(BATCH_NAMES))
def test_search_batch_agrees_with_jax(run, state, name):
    errs = _case_errors(run, state, name)
    assert not errs, "\n".join(errs[:20])


def test_cases_hit_what_they_name(run):
    """The searches reach what they are meant to test on both sides:
    hits, facets, groups, the pinned docs and the shop's mutations."""
    live = run["res"]["live"]["port"]
    games = _corpus()[0]
    for name in SINGLE_NAMES:
        r = live[name][0]
        if name not in ("shop_one_index",):
            assert r.count > 0 and r.hits, name
    assert live["facets"][0].facets["price"].values
    assert live["group_by"][0].groups
    pinned = [h.id for h in live["pinned"][0].hits]
    assert pinned[0] == "main:" + games[5]["id"]
    assert pinned[2] == "main:" + games[77]["id"]
    # the pruned reload's counts are estimates, as in JAX
    assert run["res"]["pruned"]["port"]["fulltext_0"][0].count_estimated
    shop = [h.id for h in live["shop_fulltext"][0].hits]
    assert "main:s3" not in shop and "main:s8" not in shop
    assert all(h.document["name"].endswith(" v2") for h in
               live["shop_one_index"][0].hits)


def test_port_write_side_emits_the_jax_op_bodies(run):
    jax_ops, port_ops = run["jax_ops"], run["port_ops"]
    assert len(jax_ops) == len(port_ops) > N_GAMES
    for a, b in zip(jax_ops, port_ops):
        assert (a.kind, a.collection) == (b.kind, b.collection)
        if a.kind == "index_embedding":
            assert {k: v for k, v in a.body.items() if k != "vectors"} == \
                {k: v for k, v in b.body.items() if k != "vectors"}
            va = np.asarray(a.body["vectors"], np.float32)
            vb = np.asarray(b.body["vectors"], np.float32)
            assert va.tobytes() == vb.tobytes(), a.body["doc_id"]
        else:
            assert a.body == b.body, (a.kind, a.body, b.body)
