"""Faults planted under the timed path, and the precision control.

Each is a wrapper of the system's `search(tokens, k, queries, similarity)`
that `run.run_cell(..., wrap_search=...)` and `control.py` put in place.
A sound comparison must come out not correct under each.

- `answer_altered`: every `ALTER_EVERY`-th answer of a batch is altered
  where the executor returns it: its best doc id moves to the next doc and
  its match count grows by one. A sampled check of a few hundred answers
  meets several of them.
- `half_batch`: only the first half of each batch is scored; the second
  half gets the first half's answers.
- `tf32`: the control. The program with its f32 products in TF32, the
  precision below the f32 its configuration states (only on the card).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

ALTER_EVERY = 8


def answer_altered(n_docs: int) -> Callable:
    def wrap(search):
        def altered(tokens, k, queries=None, similarity=None):
            vals, ids, counts = search(tokens, k, queries, similarity)
            vals, ids, counts = vals.copy(), ids.copy(), counts.copy()
            ids[::ALTER_EVERY, 0] = (ids[::ALTER_EVERY, 0] + 1) % n_docs
            counts[::ALTER_EVERY] += 1
            return vals, ids, counts
        return altered
    return wrap


def half_batch(search):
    def half(tokens, k, queries=None, similarity=None):
        h = (len(tokens) + 1) // 2
        q = None if queries is None else queries[:h]
        vals, ids, counts = search(list(tokens[:h]), k, q, similarity)
        idx = np.arange(len(tokens)) % h
        return vals[idx], ids[idx], counts[idx]
    return half


def tf32(search):
    from .system import set_tf32

    def lower(tokens, k, queries=None, similarity=None):
        set_tf32(True)
        try:
            return search(tokens, k, queries, similarity)
        finally:
            set_tf32(False)
    return lower
