"""`gc_paused()`: the cyclic garbage collector held off for a bulk step.

A runtime at a few hundred thousand documents keeps millions of small
Python objects alive (term ranges, doc-id maps). A bulk step that makes
millions more (an insert batch, packing the committed slab) crosses the
collector's thresholds again and again, and each full collection walks
the whole heap: on an 8-core host that was about half of a slab pack and
a third of an insert batch. Nothing these steps make is cyclic garbage,
so the collector waits until the step ends; nested and concurrent pauses
share one, and the collector comes back as the first pause found it."""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_depth = 0
_was_enabled = False


@contextmanager
def gc_paused():
    global _depth, _was_enabled
    with _lock:
        if _depth == 0:
            _was_enabled = gc.isenabled()
            gc.disable()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _was_enabled:
                gc.enable()
