"""A whole run on the CPU at a small size, with the timed path sound and
with it broken underneath: the harness's look for a card is skipped, the
rest of the run is the run's. Each planted fault must turn `correct`
false; the sound run must keep it true."""

import pytest

from benchmark import faults
from benchmark.tests._small import run_small

CELLS = ["cqadup_fulltext", "quora_hybrid"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out, n_checked = run_small(workload)
    assert out["correct"], out["compared"]
    assert n_checked >= 32
    assert out["compared"]["count_off"]["value"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_is_caught(workload):
    out, _ = run_small(workload, faults.answer_altered(3000))
    assert not out["correct"]
    got = out["compared"]
    assert got["score_err"]["value"] > got["score_err"]["limit"]
    assert got["count_off"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_half_batch_is_caught(workload):
    out, _ = run_small(workload, faults.half_batch)
    assert not out["correct"]
