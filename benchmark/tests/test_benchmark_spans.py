"""The span readers on a hand-made kept list: the traced batches are the
newest `n_batches` kept `exec.shared` spans of the cell's kind (text-only
roots interleaved with hybrid ones are left out, older roots too); a
reading is the per-batch mean of the named spans' host or device ms; a
span the program did not keep, device work it did not time, or a
program without kept spans (the parent's) reads None. The program's
trace module is found among its loaded modules by `kept_spans`."""

import sys
import types
from types import SimpleNamespace

import pytest

from benchmark import run, spans

READERS = {
    "plan_ms": (["exec.analyze"], False),
    "pack_ms": (["exec.pack"], False),
    "upload_ms": (["exec.upload"], False),
    "launch_ms": (["exec.score", "exec.tail"], False),
    "wait_ms": (["exec.drain", "exec.download"], False),
    "score_device_ms": (["exec.score"], True),
    "tail_device_ms": (["exec.tail"], True),
}


def sp(name, dur, device=None, children=(), **fields):
    return SimpleNamespace(name=name, dur_ms=dur, device_ms=device,
                           fields=fields, children=list(children))


def batch(hybrid, scale, device=True):
    """One call's spans; every duration a multiple of `scale`."""
    dev = (lambda ms: ms) if device else (lambda ms: None)
    return sp("exec.shared", 130 * scale, batch=4, hybrid=hybrid, children=[
        sp("exec.analyze", 10 * scale, terms=9),
        sp("exec.pack", 2 * scale, lr_class=1024),
        sp("exec.drain", 1 * scale),
        sp("exec.upload", 1 * scale, copies=6),
        sp("exec.score", 3 * scale, dev(40 * scale), lr_class=1024),
        sp("exec.pack", 2 * scale, lr_class=16384),
        sp("exec.drain", 20 * scale),
        sp("exec.upload", 1 * scale, copies=6),
        sp("exec.score", 3 * scale, dev(20 * scale), lr_class=16384),
        sp("exec.pack", 1 * scale),
        sp("exec.drain", 9 * scale),
        sp("exec.upload", 1 * scale, copies=3 if hybrid else 1),
        sp("exec.tail", 4 * scale, dev(8 * scale), k=8),
        sp("exec.download", 70 * scale, bytes=1),
    ])


@pytest.fixture
def program(monkeypatch):
    """The program's trace module, its kept list replaced by `kept`."""
    mod = types.ModuleType("oramacore_tpu_torch.utils.trace")
    mod.kept = []
    mod.kept_spans = lambda: list(mod.kept)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def ctx(n_batches, hybrid):
    return SimpleNamespace(reading=SimpleNamespace(n_batches=n_batches),
                           work={"n_rows": 1000 if hybrid else 0})


def read_all(c):
    return {name: run.load_reader(name).read(c) for name in READERS}


def test_readers_take_the_newest_batches_of_the_cells_kind(program):
    # an older hybrid reading, then the traced one interleaved with the
    # text-only variant's roots; one root wraps its batch span
    program.kept = [batch(True, 9.0), batch(True, 9.0)]
    for s in (1.0, 2.0):
        program.kept += [batch(True, s), batch(False, 5.0)]
    program.kept.append(sp("search", 500.0, children=[batch(True, 3.0)]))
    got = read_all(ctx(3, hybrid=True))
    mean = 2.0        # scales 1, 2, 3
    assert got == pytest.approx({
        "plan_ms": 10 * mean, "pack_ms": 5 * mean, "upload_ms": 3 * mean,
        "launch_ms": 10 * mean, "wait_ms": 100 * mean,
        "score_device_ms": 60 * mean, "tail_device_ms": 8 * mean})
    text = read_all(ctx(2, hybrid=False))
    assert text["plan_ms"] == pytest.approx(50.0)
    assert text["score_device_ms"] == pytest.approx(300.0)


def test_fewer_kept_batches_than_traced_reads_none(program, capsys):
    program.kept = [batch(True, 1.0), batch(False, 1.0)]
    assert set(read_all(ctx(2, hybrid=True)).values()) == {None}
    assert "no 2 kept exec.shared spans" in capsys.readouterr().err


def test_a_missing_span_reads_none_and_is_named(program, capsys):
    b = batch(False, 1.0)
    b.children = [c for c in b.children if c.name != "exec.upload"]
    program.kept = [b]
    got = read_all(ctx(1, hybrid=False))
    assert got["upload_ms"] is None and got["plan_ms"] == pytest.approx(10.0)
    assert "no exec.upload span under exec.shared" in capsys.readouterr().err


def test_no_device_events_reads_none_on_device_metrics(program, capsys):
    program.kept = [batch(False, 1.0, device=False)]
    got = read_all(ctx(1, hybrid=False))
    assert got["score_device_ms"] is None and got["tail_device_ms"] is None
    assert got["launch_ms"] == pytest.approx(10.0)
    assert "timed no device work" in capsys.readouterr().err


def test_a_program_without_kept_spans_reads_none(monkeypatch):
    """The parent commit's trace module has no `kept_spans`: every
    reader gives None and none raises."""
    old = types.ModuleType("oramacore_tpu_torch.utils.trace")
    old.span = lambda name, **fields: None
    monkeypatch.setitem(sys.modules, old.__name__, old)
    assert spans.trace_module() is None
    assert set(read_all(ctx(1, hybrid=False)).values()) == {None}


def test_the_programs_trace_module_is_found():
    import oramacore_tpu_torch.utils.trace as trace

    assert spans.trace_module() is trace


def test_manifest_lists_the_readers():
    m = run.load_json(run.MANIFEST)
    entries = {p["name"]: p for p in m["per_layer"]}
    for name in READERS:
        e = entries[name]
        assert (e["unit"], e["better"], e["moves"]) == ("ms", "lower", "qps")
        assert e["workloads"] == ["cqadup_fulltext", "quora_hybrid"]
