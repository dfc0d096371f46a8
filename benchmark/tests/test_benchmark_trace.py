"""The trace reading on a hand-made trace: busy is the union of device
intervals inside the window span, idle gaps are named by the innermost
host event at their middle, and hand-written kernels are counted by name
(demangled or mangled). The wrappers and their device functions are
found in the program's loaded modules, with no list of the benchmark's."""

import sys
import types

import pytest

from benchmark import system
from benchmark.trace import analyse, profiled_counts

FUNCS = {"score_ranges_accumulate": "score_ranges_accumulate_kernel",
         "score_windows": "score_windows_kernel"}


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_gaps_and_counts():
    events = [
        ev("bench.window", "user_annotation", 0, 100),
        ev("bench.batch", "user_annotation", 0, 80),
        ev("ProfilerStep#1", "user_annotation", -5, 110),
        ev("aten::foo", "cpu_op", 45, 10),
        ev("score_ranges_accumulate_kernel", "kernel", 10, 20),
        ev("_ZN12_GLOBAL__N_130score_ranges_accumulate_kernelILb1EEEv",
           "kernel", 20, 20),
        ev("Memcpy DtoH", "gpu_memcpy", 60, 10),
        ev("late_kernel", "kernel", 150, 10),          # outside the window
    ]
    r = analyse(events, 2, {"score_ranges_accumulate": 2}, FUNCS)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(40e-6)            # [10, 40] and [60, 70]
    assert r.n_kernels == 2
    assert r.profiled["score_ranges_accumulate"] == 2
    gaps = dict((k, v) for k, v in r.idle_gaps)
    assert gaps["bench.batch: host Python"] == pytest.approx(10e-6)
    assert gaps["bench.batch: aten::foo"] == pytest.approx(20e-6)
    assert gaps["between batches: host Python"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_counts_need_the_whole_name():
    got = profiled_counts(["score_ranges_accumulate_kernel_v2",
                           "my_score_windows_kernel", "score_windows_kernel"],
                          FUNCS)
    assert got["score_ranges_accumulate"] == 0
    assert got["score_windows"] == 1


def test_wrappers_found_in_the_program():
    """Every loaded module of the program with `LAUNCHES` is a wrapper;
    today's device functions are named as the CUDA sources name them."""
    import oramacore_tpu_torch.ops.attention  # noqa: F401
    import oramacore_tpu_torch.ops.facet_hist  # noqa: F401
    import oramacore_tpu_torch.ops.gather_windows  # noqa: F401
    import oramacore_tpu_torch.ops.pruned  # noqa: F401
    import oramacore_tpu_torch.ops.score_windows  # noqa: F401

    funcs = system.kernel_functions()
    assert funcs["score_ranges_accumulate"] == "score_ranges_accumulate_kernel"
    assert funcs["rescore_worklist"] == "worklist_tail_kernel"
    assert funcs["encoder_attention_backward_dkv"] == "attention_dkv_kernel"
    wide = profiled_counts(["encoder_attention_kernel",
                            "_Z29encoder_attention_wide_kernelILi5ELi16EEv"],
                           funcs)
    assert wide["encoder_attention"] == 2
    assert set(system.launch_counts()) == set(funcs)
    assert len(funcs) >= 10


def test_new_wrapper_and_renamed_kernel(monkeypatch):
    """A wrapper that a later change adds is found by its `LAUNCHES`, and
    a wrapper's own `KERNELS` names its device function: no edit here."""
    fresh = types.ModuleType("oramacore_tpu_torch.ops.fresh")
    fresh.LAUNCHES = {"fresh_entry": 3, "renamed": 1}
    fresh.KERNELS = {"renamed": "renamed_v2_kernel"}
    monkeypatch.setitem(sys.modules, fresh.__name__, fresh)
    other = types.ModuleType("oramacore_tpu.ops.fresh")   # not the program
    other.LAUNCHES = {"jax_side": 1}
    monkeypatch.setitem(sys.modules, other.__name__, other)

    funcs = system.kernel_functions()
    assert funcs["fresh_entry"] == "fresh_entry_kernel"
    assert funcs["renamed"] == "renamed_v2_kernel"
    assert "jax_side" not in funcs
    assert system.launch_counts()["fresh_entry"] == 3
    got = profiled_counts(["renamed_v2_kernel", "fresh_entry_kernel",
                           "_Z18fresh_entry_kernelv"], funcs)
    assert got["renamed"] == 1 and got["fresh_entry"] == 2
