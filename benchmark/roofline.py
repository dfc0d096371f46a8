"""The work a layer must do, from its inputs' shapes, and the least time one
card could take for it.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit (a card set lower runs below them; every share is
printed beside the card's limit). The work counts nothing of what a
kernel of the program happens to read, so a share reads the same work
whatever implements it.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flop_per_s": 989e12,
    "tf32_flop_per_s": 495e12,
    "f32_flop_per_s": 67e12,
}

# a posting as the slab stores what scoring needs of it: doc id (int32),
# tf (f32) and the field length (f32)
POSTING_BYTES = 12
# a result as the caller gets it: doc id (int32) and score (f32)
RESULT_BYTES = 8
BF16_BYTES = 2


def bm25_work(postings: int, batch: int, k: int) -> Tuple[float, float]:
    """(bytes, flop) of dense BM25 over a batch: every posting of the
    batch's distinct terms read once, each query's k results written
    once. Its operations are a few per posting, far below the bytes'
    time, so they count 0."""
    return float(postings * POSTING_BYTES + batch * k * RESULT_BYTES), 0.0


def vector_work(n_rows: int, dim: int, batch: int) -> Tuple[float, float]:
    """(bytes, flop) of exact flat cosine: the n_rows x dim bf16 rows and
    the batch's bf16 query vectors read once, 2 * batch * n_rows * dim
    operations at bf16."""
    return (float((n_rows + batch) * dim * BF16_BYTES),
            2.0 * batch * n_rows * dim)


def bound(bytes_: float, flop: float,
          flop_peak: str = "bf16_flop_per_s") -> Tuple[float, str]:
    """(least seconds, "bytes" or "flop": which of the two bounds it)."""
    t_bytes = bytes_ / PEAKS["hbm_bytes_per_s"]
    t_flop = flop / PEAKS[flop_peak]
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "flop")


def share_pct(bound_s: float, busy_s: float) -> float:
    return 100.0 * bound_s / busy_s


def batch_work(work: Dict[str, float], with_vectors: bool) -> Tuple[float, float]:
    """(bytes, flop) a batch of the traced window must move and compute:
    its BM25 and, with vectors, its flat cosine."""
    b, f = bm25_work(work["postings"], int(work["batch"]), int(work["k"]))
    if with_vectors:
        vb, vf = vector_work(int(work["n_rows"]), int(work["dim"]),
                             int(work["batch"]))
        b, f = b + vb, f + vf
    return b, f
