"""`utils.gc_pause.gc_paused`: the collector is off inside a pause, on
again after the outermost one, and left off when it was off before."""

import gc
import threading

import pytest

from oramacore_tpu_torch.utils.gc_pause import gc_paused


@pytest.fixture(autouse=True)
def _collector_back_on():
    yield
    gc.enable()


@pytest.mark.parametrize("enabled", [True, False])
def test_pause_restores_the_collector_as_it_found_it(enabled):
    (gc.enable if enabled else gc.disable)()
    with gc_paused():
        assert not gc.isenabled()
        with gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled() is enabled


def test_pause_ends_on_an_exception():
    gc.enable()
    with pytest.raises(RuntimeError):
        with gc_paused():
            raise RuntimeError("step failed")
    assert gc.isenabled()


def test_overlapping_pauses_in_two_threads_share_one():
    gc.enable()
    inside, leave = threading.Event(), threading.Event()

    def other():
        with gc_paused():
            inside.set()
            leave.wait(10)

    t = threading.Thread(target=other)
    with gc_paused():
        t.start()
        assert inside.wait(10)
    # this thread's pause ended first: the other one still holds it off
    assert not gc.isenabled()
    leave.set()
    t.join(10)
    assert gc.isenabled()
