"""The port's ingest path against the JAX package's (CPU):

- `flatten_document` and the field-type helpers, `build_doc_op` and
  `embedding_text` against the write side's `_build_doc_op` and
  `_embedding_text` on seeded documents with strings, arrays, dates,
  numbers, bools, enums, geopoints and `_omc`: equal exactly;
- `EmbeddingQueue` against the JAX queue with a capturing sender, in
  synchronous and threaded mode: the same `index_embedding` bodies;
  `flush_and_wait` with a batch in flight; a failing backend, counted;
  submitters racing the worker;
- `query_tokens` against the read side's token loop (`_plan_fulltext`);
- the whole slice at 2,048 documents of `benches/ingest_bench.py`:
  JSON documents through the ingest loop and the queue into the port's
  StringIndex and VectorIndex, searched with the shared BM25 batch and
  the fused hybrid, against the JAX executors fed the JAX package's own
  op bodies and vectors (scores rtol 1e-5, ids equal outside near-ties,
  counts exact).
"""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import oramacore_tpu.embeddings as jemb
import oramacore_tpu.index.string_index as jsi
import oramacore_tpu.index.vector_index as jvi
import oramacore_tpu.utils.flatten as jflat
import oramacore_tpu.utils.tokenizer as jtok
import oramacore_tpu.write as jwrite
import oramacore_tpu_torch.embeddings as temb
import oramacore_tpu_torch.index.string_index as tsi
import oramacore_tpu_torch.index.vector_index as tvi
import oramacore_tpu_torch.utils.flatten as tflat
from oramacore_tpu.index import search_exec as jexec
from oramacore_tpu.read import ReadSide
from oramacore_tpu.types import Locale as JLocale
from oramacore_tpu_torch import native as tnative
from oramacore_tpu_torch.benches import ingest_bench as ib
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.index.plan import plan_query, query_tokens
from oramacore_tpu_torch.types import Locale
from oramacore_tpu_torch.utils.tokenizer import TextParser
from oramacore_tpu_torch.write.doc_op import build_doc_op, embedding_text
from oramacore_tpu_torch.write.embedding_queue import EmbeddingQueue
from tests import jax_native_libs
from tests.test_torch_bm25 import assert_topk_agrees

K = 10


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX package's native routes, built once per process
    (see tests/jax_native_libs.py)."""
    jax_native_libs.bind()


def seeded_docs(seed=0, n=120):
    """Documents with every kind of value the write side types."""
    rng = np.random.default_rng(seed)
    words = ["running", "runs", "games", "Fantasy", "adventure", "café",
             "東京", "weapons", "happiness", "dog", "x" * 40]
    docs = []
    for d in range(n):
        doc = {"id": f"doc{d}",
               "title": " ".join(rng.choice(words, int(rng.integers(1, 6)))),
               "tags": list(rng.choice(words, int(rng.integers(1, 4)))),
               "genre": str(rng.choice(["rpg", "action", "a long genre name "
                                        "past the enum length"])),
               "price": float(rng.uniform(0, 99)),
               "ratings": [int(x) for x in rng.integers(0, 5, 3)],
               "available": bool(rng.random() < 0.5),
               "released": str(rng.choice(["2024-01-15", "2023-06-30T12:00:00Z",
                                           "2021-02-03 04:05:06"])),
               "meta": {"studio": str(rng.choice(["Acme", "Zeta Games"])),
                        "nested": {"depth": int(d)}},
               "where": {"lat": float(rng.uniform(-90, 90)),
                         "lon": float(rng.uniform(-180, 180))}}
        if d % 3 == 0:
            doc["_omc"] = float(rng.uniform(0.5, 2))
        if d % 5 == 0:
            doc["empty"] = []
            doc["nothing"] = None
            doc["mixed"] = [1, "a"]
        if d % 7 == 3:
            doc["released"] = "not a date"   # a date field's later string
        docs.append(doc)
    return docs


def _discover(field_types, flat, infer):
    for path, value in flat.items():
        if path in ("id", "_omc") or path in field_types:
            continue
        t = infer(value)
        if t is not None:
            field_types[path] = t


def test_flatten_helpers_match_jax():
    for doc in seeded_docs(1, 40):
        flat = tflat.flatten_document(doc)
        assert flat == jflat.flatten_document(doc)
        for path, v in flat.items():
            assert tflat.infer_field_type(v) == jflat.infer_field_type(v)
            assert tflat.string_values(v) == jflat.string_values(v)
            assert tflat.number_values(v) == jflat.number_values(v)
            assert tflat.is_filterable_enum(v) == jflat.is_filterable_enum(v)
        assert tflat.extract_omc(flat) == jflat.extract_omc(flat)
        assert tflat.all_string_properties_text(flat) == \
            jflat.all_string_properties_text(flat)


@pytest.mark.parametrize("use_cache", [False, True])
def test_build_doc_op_matches_jax(use_cache):
    tparser = TextParser(Locale.EN)
    jparser = jtok.TextParser(JLocale.EN)
    tft, jft = {}, {}
    cache = {"running runs": (2, "running\x01run\x02runs\x01run")}
    for d, doc in enumerate(seeded_docs()):
        tflat_, jflat_ = tflat.flatten_document(doc), jflat.flatten_document(doc)
        _discover(tft, tflat_, tflat.infer_field_type)
        _discover(jft, jflat_, jflat.infer_field_type)
        assert tft == jft
        widx = jwrite.WriteIndex(index_id="i", field_types=jft)
        want = jwrite.WriteSide._build_doc_op(
            None, widx, jparser, d, doc["id"], jflat_, doc,
            cache if use_cache else None)
        got = build_doc_op(tft, tparser, d, doc["id"], tflat_, doc,
                           cache if use_cache else None)
        assert got == want
        assert list(got) == ["doc_id", "user_id", "strings_packed", "numbers",
                             "bools", "string_filters", "geos", "dates", "omc",
                             "raw"]
    assert {"string", "string[]", "number", "number[]", "bool", "date",
            "geopoint"} <= set(tft.values())


@pytest.mark.parametrize("fields,auto", [((), True), (("title", "tags"), True),
                                         ((), False), (("meta.studio",), False)])
def test_embedding_text_matches_jax(fields, auto):
    widx = jwrite.WriteIndex(index_id="i", embedding_fields=list(fields),
                             automatic_embeddings=auto)
    for doc in seeded_docs(2, 30):
        flat = tflat.flatten_document(doc)
        assert embedding_text(flat, fields, auto) == \
            jwrite.WriteSide._embedding_text(None, widx, flat)


# ---------------------------------------------------------------------------
# the embedding queue
# ---------------------------------------------------------------------------

class _Capture:
    """The JAX queue's op sender, keeping what it is sent."""

    def __init__(self):
        self.got = []

    def send(self, op):
        self.got.append((op.kind, op.collection, op.body))


def _jobs(n=257, seed=3):
    rng = np.random.default_rng(seed)
    texts = ib.documents(n, seed=seed, words=ib.vocabulary(2000, seed)[0])
    models = ["builtin-minihash-384", "builtin-minihash-768"]
    jobs = []
    for d, doc in enumerate(texts):
        text = "" if d % 50 == 7 else doc["title"] + " " + doc["description"]
        jobs.append((f"c{d % 2}", "i", d, models[int(rng.random() < 0.3)], text))
    return jobs


def _port_queue(synchronous, batch_limit=100, service=None):
    got = []
    q = EmbeddingQueue(service or temb.EmbeddingsService(),
                       lambda coll, body: got.append(
                           ("index_embedding", coll, body)),
                       batch_limit=batch_limit, synchronous=synchronous)
    return q, got


@pytest.mark.parametrize("synchronous", [True, False])
def test_queue_emits_the_jax_bodies(synchronous):
    jobs = _jobs()
    cap = _Capture()
    jq = jwrite.EmbeddingQueue(jemb.EmbeddingsService(), cap, batch_limit=100,
                               synchronous=synchronous)
    tq, got = _port_queue(synchronous)
    for q in (jq, tq):
        q.submit(*jobs[0])
        q.submit_many(jobs[1:200])
        q.submit_many([])
        for job in jobs[200:]:
            q.submit(*job)
    assert tq.flush_and_wait(timeout=60)
    jq.flush_and_wait(timeout=60)
    jq.stop()      # the JAX flush may return before its last batch is done
    tq.stop()
    assert len(got) == len(cap.got) == sum(1 for j in jobs if j[4])
    assert got == cap.got
    assert tq.failed_batches == 0 and tq.batches >= 3 and tq.seconds > 0


class _Blocking:
    """A service whose first call waits for `release`."""

    def __init__(self):
        self.started, self.release = threading.Event(), threading.Event()
        self.inner = temb.EmbeddingsService()

    def calculate_embeddings(self, texts, intent, model=None):
        if not self.started.is_set():
            self.started.set()
            assert self.release.wait(30)
        return self.inner.calculate_embeddings(texts, intent, model)


def test_flush_waits_for_a_batch_in_flight():
    svc = _Blocking()
    q, got = _port_queue(False, batch_limit=100, service=svc)
    try:
        q.submit_many(_jobs(60))
        assert svc.started.wait(30)
        # the queue is empty; its one batch is still computing
        assert not q.flush_and_wait(timeout=0.3)
        assert got == []
        svc.release.set()
        assert q.flush_and_wait(timeout=30)
        assert len(got) == sum(1 for j in _jobs(60) if j[4])
    finally:
        svc.release.set()
        q.stop()
    assert not q._thread.is_alive()


class _Failing:
    def __init__(self):
        self.inner = temb.EmbeddingsService()

    def calculate_embeddings(self, texts, intent, model=None):
        if model == "builtin-minihash-768":
            raise RuntimeError("backend down")
        return self.inner.calculate_embeddings(texts, intent, model)


def test_failing_batches_are_counted_and_skipped():
    jobs = [("c", "i", d, "builtin-minihash-768" if d in (2, 3) else
             "builtin-minihash-384", f"text {d}") for d in range(10)]
    q, got = _port_queue(False, batch_limit=4, service=_Failing())
    try:
        q.submit_many(jobs)
        assert q.flush_and_wait(timeout=30)
    finally:
        q.stop()
    # jobs 0-3 are one batch: its 768 group raised after the 384 group
    # was emitted, as the JAX queue does; batches 4-7 and 8-9 are whole
    assert q.failed_batches == 1
    assert [body["doc_id"] for _, _, body in got] == [0, 1, 4, 5, 6, 7, 8, 9]
    sq, _ = _port_queue(True, service=_Failing())
    with pytest.raises(RuntimeError):
        sq.submit_many(jobs)


def test_queue_under_racing_submitters():
    """Submitters in more threads than the CPU has cores, with a short
    switch interval: every job is emitted exactly once."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    q, got = _port_queue(False, batch_limit=7)
    try:
        def submit(t):
            for d in range(t * 40, (t + 1) * 40):
                q.submit("c", "i", d, "builtin-minihash-384", f"word{d} x")
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
        assert q.flush_and_wait(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        q.stop()
    assert sorted(body["doc_id"] for _, _, body in got) == list(range(640))
    assert q.failed_batches == 0


# ---------------------------------------------------------------------------
# query tokens
# ---------------------------------------------------------------------------

def _read_side_tokens(jparser, term, exact):
    """The JAX read side's `_plan_fulltext` with stand-ins for what it
    reads besides the parser; returns its token list."""
    me = SimpleNamespace(sharded_mesh=None, config=SimpleNamespace(
        reader_side=SimpleNamespace(impact_cap=None)))
    idx = SimpleNamespace(parser=jparser, field_types={"body": "string"},
                          field_params={}, string=SimpleNamespace(
                              plan_query=lambda *a, **k: None))
    mode = SimpleNamespace(term=term, exact=exact, tolerance=None)
    params = SimpleNamespace(properties=None, phrase_boost=None, boost={})
    return ReadSide._plan_fulltext(me, idx, mode, params)[0]


@pytest.mark.parametrize("locale", ["english", "italian", "russian", "chinese"])
@pytest.mark.parametrize("exact", [False, True])
def test_query_tokens_match_the_read_side(locale, exact):
    tparser = TextParser(Locale(locale))
    jparser = jtok.TextParser(JLocale(locale))
    terms = ["", "   ", "!!!", "Running foxes", "walkingly walks", "café runs",
             "книгами красный", "你好世界 games", "x" * 300] + \
        ib.queries(ib.vocabulary(3000, 1)[1], 40, seed=2)
    for term in terms:
        got = query_tokens(tparser, term, exact)
        assert got == _read_side_tokens(jparser, term, exact), term
        assert got and all(isinstance(t, str) for t in got)
    assert query_tokens(tparser, "", exact) == [""]


# ---------------------------------------------------------------------------
# the whole slice, 2,048 documents
# ---------------------------------------------------------------------------

N_SLICE = 2048
PROPS = list(ib.TEXT_FIELDS)


@pytest.fixture(scope="module")
def slice_run():
    words, stems = ib.vocabulary(4000, seed=15)
    docs = ib.documents(N_SLICE, seed=15, words=words)
    qtexts = ib.queries(stems, 24, seed=16)
    # the port: its ingest loop, native tokenizer and live accumulator,
    # a threaded queue into a VectorIndex
    tnative.reset_routes()
    tidx = tsi.StringIndex()
    tvec = tvi.VectorIndex(tvi.VectorIndexConfig(dim=384), "cpu")

    def sink(coll, body):
        tvec.insert(body["doc_id"], [np.asarray(v, np.float32)
                                     for v in body["vectors"]])

    queue = EmbeddingQueue(temb.EmbeddingsService(), sink, batch_limit=100)
    ft = {}
    try:
        stats = ib.ingest(docs, TextParser(Locale.EN), tidx, queue, ft,
                          insert_batch=500)
        assert queue.flush_and_wait(timeout=120)
    finally:
        queue.stop()
    tidx.commit()
    tvec.commit()
    routes = {k: dict(v) for k, v in tnative.ROUTES.items()}
    # the JAX package: its own op bodies, index and vectors
    jparser = jtok.TextParser(JLocale.EN)
    jidx = jsi.StringIndex()
    jvec = jvi.VectorIndex(jvi.VectorIndexConfig(dim=384))
    jft = {}
    texts = []
    for d, doc in enumerate(docs):
        flat = jflat.flatten_document(doc)
        _discover(jft, flat, jflat.infer_field_type)
        body = jwrite.WriteSide._build_doc_op(
            None, jwrite.WriteIndex(index_id="i", field_types=jft), jparser,
            d, doc["id"], flat, doc)
        for path in PROPS:
            jidx.index_text_packed(d, path, *body["strings_packed"][path])
        texts.append(jwrite.WriteSide._embedding_text(
            None, jwrite.WriteIndex(index_id="i"), flat))
    for d, vecs in enumerate(jemb.EmbeddingsService().calculate_embeddings(
            texts, jemb.Intent.PASSAGE)):
        jvec.insert(d, list(vecs))
    jidx.commit()
    jvec.commit()
    return dict(docs=docs, qtexts=qtexts, tidx=tidx, jidx=jidx, tvec=tvec,
                jvec=jvec, stats=stats, routes=routes, ft=ft, jft=jft,
                failed=queue.failed_batches, jparser=jparser)


def test_slice_ingest(slice_run):
    r = slice_run
    assert r["ft"] == r["jft"] == {"title": "string", "description": "string",
                                   "genre": "string", "price": "number"}
    assert r["failed"] == 0
    assert len(r["tvec"]._committed_docs) == N_SLICE
    np.testing.assert_array_equal(r["tvec"]._committed_docs,
                                  r["jvec"]._committed_docs)
    np.testing.assert_array_equal(r["tvec"]._committed_matrix,
                                  r["jvec"]._committed_matrix)
    for x, y in zip(r["tidx"].slab(), r["jidx"].slab(), strict=True):
        np.testing.assert_array_equal(x, y)
    odd = sum(not (d["title"] + d["description"]).isascii() for d in r["docs"])
    assert 0 < odd < N_SLICE // 10
    # every string field of every document was tokenized once (id, title,
    # description, genre); the non-ASCII ones went to Python
    assert r["routes"]["tokenizer"]["python"] == odd
    assert sum(r["routes"]["tokenizer"].values()) == 4 * N_SLICE
    assert r["routes"]["hash_encode"] == {"native": N_SLICE - odd,
                                          "python": odd}
    assert r["routes"]["live_accum"] == {"native": 2 * N_SLICE, "python": 0}
    assert r["stats"]["tokens"] == sum(
        len(TextParser(Locale.EN, use_native=False).tokenize(d[p]))
        for d in r["docs"] for p in PROPS)


def test_slice_bm25_and_hybrid_match_jax(slice_run):
    r = slice_run
    tparser = TextParser(Locale.EN)
    toks = [query_tokens(tparser, q, False) for q in r["qtexts"]]
    assert toks == [_read_side_tokens(r["jparser"], q, False)
                    for q in r["qtexts"]]
    n = N_SLICE
    tv, ti, tc = texec.SharedBatchExecutor("cpu").search_topk_shared(
        r["tidx"], toks, PROPS, {}, float(n), n, K)
    ev, ei, ec = jexec.SharedBatchExecutor().search_topk_shared(
        r["jidx"], toks, PROPS, {}, float(n), n, K)
    assert_topk_agrees(tv, ti, ev, ei)
    np.testing.assert_array_equal(tc, ec)
    assert (tc > 0).sum() >= len(toks) - 2
    # a word no document holds ("...ingly") matches through its stem
    held = set(r["tidx"]._slab_terms_by_field["description"]) | \
        set(r["tidx"]._slab_terms_by_field["title"])
    stem_only = [b for b, q in enumerate(r["qtexts"])
                 if any(w.endswith(ib.QUERY_SUFFIX) and w not in held
                        for w in q.split())]
    assert stem_only and any(tc[b] > 0 for b in stem_only)

    B = 8
    qv = np.stack([v[0] for v in temb.EmbeddingsService().calculate_embeddings(
        r["qtexts"][:B], temb.Intent.QUERY)])
    np.testing.assert_array_equal(qv, np.stack([
        v[0] for v in jemb.EmbeddingsService().calculate_embeddings(
            r["qtexts"][:B], jemb.Intent.QUERY)]))
    sims = [0.1] * B
    tplans = [plan_query(r["tidx"], t, PROPS, {}) for t in toks[:B]]
    jplans = [r["jidx"].plan_query(t, PROPS, {}) for t in toks[:B]]
    args = ([float(n)] * B, n, K)
    got = texec.HybridSearchTopK("cpu").search_topk_hybrid(
        r["tidx"], tplans, *args, r["tvec"].flat_device_rows(), qv, sims)
    exp = jexec.HybridSearchTopK().search_topk_hybrid(
        r["jidx"], jplans, *args, r["jvec"].flat_device_rows(), qv, sims)
    assert_topk_agrees(got[0], got[1], exp[0], exp[1])
    np.testing.assert_array_equal(got[2], exp[2])
    assert (got[2] > 0).all()
    # the flat vector search of the same queries
    for b in range(B):
        th = r["tvec"].search([qv[b]], K, 0.1)
        jh = r["jvec"].search([qv[b]], K, 0.1)
        assert th.keys() == jh.keys() and th
        np.testing.assert_allclose([th[d] for d in jh], list(jh.values()),
                                   rtol=1e-5)
