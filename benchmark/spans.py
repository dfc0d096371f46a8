"""Per-batch readings of the program's own spans: what its span tracing
(`utils/trace.py`) kept while the profiler recorded the traced window.

The program's trace module is found among its loaded modules, as
`system.wrapper_modules` finds the wrappers: the module of `PROGRAM`
with a `kept_spans()` function, whose kept roots carry `name`, `fields`,
`children`, `dur_ms` and, for a span that timed its device work with
CUDA events, `device_ms`. The traced batches are the newest
`ctx.reading.n_batches` kept `exec.shared` spans whose `hybrid` field
equals the cell's: a hybrid cell also profiles its batches text only,
for `vector_tail_ms`. A reading is the mean over those batches of the
summed duration of the named spans under each, on the host clock or on
the device. Where the program kept no such span, or timed no device
work (a CPU device, or a program without device events), the reading is
None and the missing name goes to standard error.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

from .system import PROGRAM

BATCH_SPAN = "exec.shared"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def trace_module():
    """The program's loaded module that keeps spans, or None."""
    for name, mod in sorted(list(sys.modules.items())):
        if name.split(".")[0] == PROGRAM and mod is not None \
                and callable(getattr(mod, "kept_spans", None)):
            return mod
    return None


def _walk(sp):
    yield sp
    for c in getattr(sp, "children", ()):
        yield from _walk(c)


def traced_batches(ctx) -> List:
    """The traced window's batch spans, oldest first; [] when the
    program kept fewer than the window's batches."""
    mod = trace_module()
    if mod is None:
        return []
    hybrid = bool(ctx.work.get("n_rows"))
    found = [sp for root in mod.kept_spans() for sp in _walk(root)
             if sp.name == BATCH_SPAN
             and bool(sp.fields.get("hybrid")) == hybrid]
    n = int(ctx.reading.n_batches)
    return found[-n:] if len(found) >= n else []


def per_batch_ms(ctx, names: Iterable[str], device: bool = False
                 ) -> Optional[float]:
    """Mean over the traced batches of the summed ms of the spans named
    `names` under each batch span: host (`dur_ms`) or device
    (`device_ms`)."""
    names = tuple(names)
    batches = traced_batches(ctx)
    if not batches:
        _log(f"spans: no {ctx.reading.n_batches} kept {BATCH_SPAN} spans "
             f"for {'/'.join(names)}")
        return None
    total, seen = 0.0, 0
    for b in batches:
        for sp in _walk(b):
            if sp is b or sp.name not in names:
                continue
            ms = getattr(sp, "device_ms", None) if device else sp.dur_ms
            if ms is None:
                _log(f"spans: {sp.name} timed no device work")
                return None
            total += float(ms)
            seen += 1
    if not seen:
        _log(f"spans: no {'/'.join(names)} span under {BATCH_SPAN}")
        return None
    return total / len(batches)
