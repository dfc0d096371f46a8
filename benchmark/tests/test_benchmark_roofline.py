"""The roofline's bytes and operations on hand-counted cases."""

import pytest

from benchmark import roofline


def test_bm25_bytes_hand_counted():
    # 1,000 postings at 12 bytes, 4 queries x 10 results x 8 bytes
    assert roofline.bm25_work(1000, 4, 10) == (12_000 + 320, 0.0)


def test_vector_bytes_and_flop_hand_counted():
    # 100 rows + 2 queries of 384 bf16 values; 2 * 2 * 100 * 384 flop
    assert roofline.vector_work(100, 384, 2) == (102 * 384 * 2, 153_600)


def test_bound_picks_the_larger():
    t, which = roofline.bound(3.35e12, 0.0)
    assert (t, which) == (1.0, "bytes")
    t, which = roofline.bound(0.0, 989e12)
    assert (t, which) == (1.0, "flop")


def test_batch_work_adds_both_sides():
    w = {"postings": 1000, "batch": 4, "k": 10, "n_rows": 100, "dim": 384}
    b, f = roofline.batch_work(w, with_vectors=True)
    assert b == 12_000 + 320 + 104 * 384 * 2
    assert f == 2 * 4 * 100 * 384
    assert roofline.batch_work(w, with_vectors=False) == (12_320.0, 0.0)


def test_share():
    assert roofline.share_pct(0.001, 0.1) == pytest.approx(1.0)
