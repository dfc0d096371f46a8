"""The port's span tracing (`oramacore_tpu_torch/utils/trace.py`) and the
spans of `SharedBatchExecutor.search_topk_shared`, on the CPU.

- A span tree nests per thread; its root goes to the trace log (DEBUG,
  or WARNING when slow) with each span's fields.
- Tracing is on only while a `torch.profiler` records: then a root and
  its spans are kept (newest `KEEP` roots), appear in the exported
  trace as `user_annotation` events inside the caller's
  `record_function`, and time their device work with CUDA events
  (faked here: the CPU build has none). Off, no `record_function` is
  opened, nothing is kept and no event is made.
- One executor call, full text and hybrid, keeps one `exec.shared` root
  whose children are its stages in order, with counters equal to what
  `analyze_shared_batch` and `pack_shared_class` return for the batch
  (`pairs`: the distinct (query, chunk) pairs of the packed slot map);
  each upload is preceded by an `exec.drain` that waits for a CUDA
  stream apart from the copies, only while tracing.
- `chip_smoke.profile_reading` sums kernels, not the spans' device-side
  annotation events.
"""

import collections
import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import oramacore_tpu_torch.index.string_index as tsi
from oramacore_tpu_torch.index import search_exec as texec
from oramacore_tpu_torch.utils import trace

VOCAB = [f"w{i}" for i in range(60)]
N_COMMITTED, N_LIVE = 1100, 50
N_DOCS = N_COMMITTED + N_LIVE
PROPS = ["body"]
QUERIES = [["heavy", "w1"], ["common", "w2", "w3"], ["w4"], ["nosuchword"],
           ["w5", "heavy"], ["common"]]


@pytest.fixture(scope="module")
def index():
    """'heavy' is a champion term (committed only); 'common' is one too
    but has live postings, so it falls back to a range longer than 1,024
    (the second length class); the w-terms take the first class."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsi, "CHAMPION_MIN", 128)
        rng = np.random.default_rng(0)
        idx = tsi.StringIndex()
        for d in range(N_COMMITTED):
            words = list(rng.choice(VOCAB, int(rng.integers(2, 6))))
            idx.index_text(d, "body",
                           [(w, []) for w in words + ["heavy", "common"]])
        idx.commit()
        for d in range(N_COMMITTED, N_DOCS):
            idx.index_text(d, "body", [("common", []), ("w1", [])])
        idx.slab_split()
    assert ("body", "heavy") in idx._champ_map
    return idx


@pytest.fixture(scope="module")
def vec_rows():
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    vecs = np.random.default_rng(1).normal(size=(N_DOCS, 16)).astype(np.float32)
    vidx = VectorIndex(VectorIndexConfig(dim=16), "cpu")
    for d in range(N_DOCS):
        vidx.insert(d, [vecs[d]])
    vidx.commit()
    return vidx.flat_device_rows(), vecs[:len(QUERIES)] / np.linalg.norm(
        vecs[:len(QUERIES)], axis=1, keepdims=True)


def _call(ex, index, hybrid=None):
    kw = {}
    if hybrid is not None:
        rows, q = hybrid
        kw = dict(vec_rows=rows, queries=q,
                  similarities=[0.1] * len(QUERIES))
    return ex.search_topk_shared(index, QUERIES, PROPS, {}, float(N_DOCS),
                                 N_DOCS, 5, thresholds=[0.0] * len(QUERIES),
                                 **kw)


def _newest_root(before):
    roots = [r for r in trace.kept_spans() if r.trace_id > before]
    assert len(roots) == 1, [r.name for r in roots]
    return roots[0]


def _last_id():
    kept = trace.kept_spans()
    return kept[-1].trace_id if kept else 0


def _expected_children(index, n_rows):
    """(name, fields) of each child of one call, from the host helpers;
    `n_rows` the vector rows of a hybrid call (the flat slab's, padding
    included), None for full text."""
    u_ranges, u_champs, tmap, classes, B, T = texec.analyze_shared_batch(
        index, QUERIES, PROPS, {}, None, False, None, None)
    out = [("exec.analyze", dict(
        terms=len(u_ranges),
        champion_terms=sum(c is not None for c in u_champs)))]
    for lr_class, uids in classes.items():
        if not uids:
            continue
        cu = texec.SharedBatchExecutor.CHUNK_BY_CLASS[lr_class]
        arrays = texec.pack_shared_class(u_ranges, uids, tmap, B, T, cu)[:6]
        chunks = arrays[0].shape[0] // cu
        ranges = [r for u in uids for r in u_ranges[u]]
        # (query, chunk) pairs: the distinct chunks of each query's slots
        pairs = sum(len({int(u) // cu for u in row if u < len(uids)})
                    for row in arrays[5])
        out += [("exec.pack", dict(lr_class=lr_class, tokens=len(uids),
                                   chunks=chunks, ranges=len(ranges),
                                   postings=sum(r[1] for r in ranges))),
                ("exec.drain", {}),
                ("exec.upload", dict(copies=6, bytes=sum(a.nbytes
                                                         for a in arrays))),
                ("exec.score", dict(lr_class=lr_class, chunks=chunks,
                                    pairs=pairs))]
    champs = [ui for ui, c in enumerate(u_champs) if c]
    nc = max(len(u_champs[ui]) for ui in champs)
    out += [("exec.pack", dict(lr_class="champion", tokens=len(champs),
                               chunks=1)),
            ("exec.drain", {}),
            ("exec.upload", dict(copies=4, bytes=len(champs) * (8 * nc + 4)
                                 + tmap.nbytes)),
            ("exec.score", dict(lr_class="champion", chunks=1,
                                pairs=sum(any(int(g) in champs for g in row)
                                          for row in tmap))),
            ("exec.pack", {}),
            ("exec.drain", {})]
    if n_rows is not None:
        out += [("exec.upload", dict(copies=3, bytes=4 * B * (2 + 16))),
                ("exec.tail", dict(k=8, rows=n_rows))]
    else:
        out += [("exec.upload", dict(copies=1, bytes=4 * B)),
                ("exec.tail", dict(k=8, rows=0))]
    out.append(("exec.download", dict(bytes=B * 5 * 8 + B * 4)))
    return out


@pytest.mark.parametrize("hybrid", [False, True], ids=["fulltext", "hybrid"])
def test_one_call_keeps_its_stages_in_order(index, vec_rows, hybrid):
    ex = texec.SharedBatchExecutor("cpu")
    tails = vec_rows if hybrid else None
    want = _call(ex, index, tails)       # the slab upload, untraced
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _call(ex, index, tails)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    root = _newest_root(before)
    assert root.name == "exec.shared"
    assert root.fields == dict(batch=len(QUERIES), hybrid=hybrid)
    n_rows = vec_rows[0][0].shape[0] if hybrid else None
    assert [(c.name, c.fields) for c in root.children] == \
        _expected_children(index, n_rows)
    assert all(not c.children for c in root.children)
    assert {s.trace_id for s in root.walk()} == {root.trace_id}
    # sequential siblings inside the root: the rest is the root's self time
    edges = [root.t0_ns] + [t for c in root.children
                            for t in (c.t0_ns, c.t1_ns)] + [root.t1_ns]
    assert edges == sorted(edges)
    covered = sum(c.t1_ns - c.t0_ns for c in root.children)
    assert 0 < covered <= root.t1_ns - root.t0_ns
    assert all(s.device_ms is None for s in root.walk())   # a CPU device


def test_spans_are_annotations_inside_the_callers_record_function(
        index, tmp_path):
    ex = texec.SharedBatchExecutor("cpu")
    _call(ex, index)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            _call(ex, index)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    caller = next(e for e in marks if e["name"] == "caller")
    c0, c1 = caller["ts"], caller["ts"] + caller["dur"]
    ours = [e for e in marks if e["name"].startswith("exec.")]
    names = collections.Counter(e["name"] for e in ours)
    assert names == collections.Counter(
        ["exec.shared"] + [n for n, _f in _expected_children(index, None)])
    for e in ours:
        assert c0 <= e["ts"] and e["ts"] + e["dur"] <= c1, e["name"]
    root = next(e for e in ours if e["name"] == "exec.shared")
    for e in ours:
        assert root["ts"] <= e["ts"] <= root["ts"] + root["dur"]


class _Counting:
    """Stands in for `torch.profiler.record_function` or
    `torch.cuda.Event`, counting constructions."""

    made = 0

    def __init__(self, *a, **kw):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_off_opens_no_record_function_keeps_nothing_makes_no_event(
        index, monkeypatch):
    class Rec(_Counting):
        made = 0

    class Event(_Counting):
        made = 0

    ex = texec.SharedBatchExecutor("cpu")
    _call(ex, index)
    monkeypatch.setattr(torch.profiler, "record_function", Rec)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    kept = trace.kept_spans()
    assert not torch.autograd._profiler_enabled()
    _call(ex, index)
    with trace.span("root"):
        with trace.span("child", device=torch.device("cuda"), n=1):
            pass
    assert Rec.made == 0 and Event.made == 0
    assert [r.trace_id for r in trace.kept_spans()] == \
        [r.trace_id for r in kept]


class _Stream:
    syncs = 0

    def synchronize(self):
        type(self).syncs += 1


def test_uploads_drain_a_cuda_stream_apart_only_while_tracing(monkeypatch):
    """On a CUDA device a traced upload first waits for the stream in an
    `exec.drain` span, so that `exec.upload` times the copies alone;
    untraced, the blocking copies wait by themselves and no drain is
    opened."""
    streams = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: streams.append(dev) or _Stream())
    fake = type("Ex", (), dict(
        device=torch.device("cuda", 0),
        _to_dev=lambda self, a: torch.as_tensor(a)))()
    arrays = (np.zeros(3, np.int32), np.ones((2, 2), np.float32))
    with trace.span("root"):
        texec.SharedBatchExecutor._upload(fake, *arrays)
    assert _Stream.syncs == 0 and streams == []
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("root"):
            got = texec.SharedBatchExecutor._upload(fake, *arrays)
    assert _Stream.syncs == 1 and streams == [torch.device("cuda", 0)]
    root = _newest_root(before)
    assert [(c.name, c.fields) for c in root.children] == [
        ("exec.drain", {}), ("exec.upload", dict(copies=2, bytes=28))]
    assert [g.shape for g in got] == [(3,), (2, 2)]


class _FakeEvent:
    """A timed CUDA event: `elapsed_time` is the gap between the record
    calls' ticks, 1.5 ms a tick."""

    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream):
        assert stream == "stream"
        type(self).clock += 1
        self.at = type(self).clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return 1.5 * (end.at - self.at)


def test_device_spans_time_their_work_with_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("root", batch=2):
            with trace.span("score", device=torch.device("cuda", 0)):
                with trace.span("inner", device="cuda"):
                    pass
            with trace.span("host", device=torch.device("cpu")):
                pass
    root = _newest_root(before)
    score, host = root.children
    # score's events enclose inner's two records: 3 ticks apart
    assert score.device_ms == 4.5 and score.children[0].device_ms == 1.5
    assert host.device_ms is None and root.device_ms is None
    assert score.events is None and root.fields == {"batch": 2}


def test_a_failed_span_times_nothing_and_a_failed_root_is_not_kept(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("root"):
            with pytest.raises(ValueError):
                with trace.span("bad", device="cuda"):
                    raise ValueError("x")
        with pytest.raises(KeyError):
            with trace.span("failed_root"):
                raise KeyError("y")
    root = _newest_root(before)
    assert root.name == "root" and root.children[0].device_ms is None
    assert trace._stack() == []


def test_kept_roots_are_bounded_newest_last(monkeypatch):
    monkeypatch.setattr(trace, "_kept", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"r{i}"):
                with trace.span("c"):
                    pass
    kept = trace.kept_spans()
    assert [r.name for r in kept] == ["r2", "r3", "r4"]
    assert [r.children[0].trace_id for r in kept] == [r.trace_id for r in kept]
    assert len({r.trace_id for r in kept}) == 3


def test_root_goes_to_the_trace_log_with_fields(caplog, monkeypatch):
    with caplog.at_level(logging.DEBUG, logger="oramacore_tpu.trace"):
        with trace.span("request", route="/search"):
            with trace.span("score", index="main") as sp:
                sp.fields["postings"] = 7
    msg = next(r.message for r in caplog.records if "trace:" in r.message)
    lines = msg.splitlines()[1:]
    assert lines[0].startswith("request ") and "route=/search" in lines[0]
    assert lines[1].startswith("  score ") and \
        lines[1].endswith("index=main postings=7")
    caplog.clear()
    monkeypatch.setattr(trace, "SLOW_ROOT_S", 0.0)
    with caplog.at_level(logging.WARNING, logger="oramacore_tpu.trace"):
        with trace.span("slow"):
            pass
    assert any("slow request trace" in r.message for r in caplog.records)


def test_chip_smoke_leaves_span_annotations_out_of_device_time(monkeypatch):
    """Under a profiler the spans' `record_function`s also appear as
    device-side annotation events; `chip_smoke.profile_reading` sums
    kernels only."""
    import chip_smoke

    def event(key, ms, annotation):
        return type("Event", (), dict(
            key=key, count=1, self_device_time_total=ms * 1e3,
            device_type="DeviceType.CUDA", is_user_annotation=annotation))

    class FakeProfile:
        def __init__(self, **kw):
            self.ready, self.steps = kw["on_trace_ready"], 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 2:
                events = [event("score_ranges_accumulate_kernel", 2.0, False),
                          event("exec.score", 2.5, True)]
                self.ready(type("Prof", (), dict(
                    key_averages=lambda s: events))())

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke.time, "sleep", lambda s: None)
    _launched, kernels = chip_smoke.profile_reading(lambda: None)
    assert kernels == [(2.0, 1, "score_ranges_accumulate_kernel")]
