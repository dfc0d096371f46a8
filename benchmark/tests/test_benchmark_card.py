"""On the card, at a size a test run holds: the sound program is correct,
and the control (its f32 products in TF32) and the planted faults are
not. Run there with

    python3 -m pytest benchmark/tests -q -m card
"""

import pytest

from benchmark import faults, run
from benchmark.tests._small import small

CELLS = ["cqadup_fulltext", "quora_hybrid"]
N_DOCS = 60000


def card_run(workload, wrap=None, seed=2**31 + 11):
    cfg, traffic = small(workload, n_docs=N_DOCS, batch=256)
    return run.run_cell(workload, seed, 1.0, False, device="cuda",
                        cfg_override=cfg, traffic_override=traffic,
                        wrap_search=wrap)[0]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(cuda, workload):
    out = card_run(workload)
    assert out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_tf32_is_not_correct(cuda, workload):
    out = card_run(workload, faults.tf32)
    assert not out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_not_correct(cuda, workload):
    out = card_run(workload, faults.answer_altered(N_DOCS))
    assert not out["correct"], out["compared"]
