"""Span tracing: where a request spent its time.

`span(name, **fields)` context managers build a thread-local tree of
spans per request. When the root closes, the tree goes to the
`oramacore_tpu.trace` logger at DEBUG (one line a span, children nested,
each with its duration and fields), and a slow root (>= `SLOW_ROOT_S`)
goes there at WARNING whatever the level: the operator's triage log.
Fields are the span's counters; a span may add to them while it is open
(`with span(...) as sp: ...; sp.fields.update(...)`).

Tracing is on while a `torch.profiler` records (its active steps, not
its warm-up), judged when a root opens; there is no other switch. A root
opened then, and every span under it, also:

- opens `torch.profiler.record_function(name)` around its block, so it
  lands in the exported trace as a `user_annotation` event on the
  kernels' timeline;
- with `device=` a CUDA device, records a timed CUDA event on that
  device's current stream at each of its edges; the device ms between
  them (`Span.device_ms`) are resolved when the root closes normally,
  which waits for the stream to reach the last event;
- is kept when the root closes: `kept_spans()` gives the newest `KEEP`
  closed roots, each with its children, its start and end
  (`time.perf_counter_ns`) and the `trace_id` every span of the request
  shares.

`tracing()` tells code inside a span whether it is traced, for a step
that only a traced request takes apart (the executor's upload drain).

With tracing off a span costs two clock reads, a list append and the
profiler check; nothing is kept and no event is made.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional

import torch

logger = logging.getLogger("oramacore_tpu.trace")

SLOW_ROOT_S = 1.0
KEEP = 1024

_local = threading.local()
_ids = itertools.count(1)
_kept: Deque["Span"] = deque(maxlen=KEEP)
_kept_lock = threading.Lock()


class Span:
    __slots__ = ("name", "fields", "trace_id", "on", "t0_ns", "t1_ns",
                 "events", "device_ms", "children")

    def __init__(self, name: str, fields: Dict[str, Any], trace_id: int,
                 on: bool):
        self.name = name
        self.fields = fields
        self.trace_id = trace_id
        self.on = on
        self.events = None
        self.device_ms: Optional[float] = None
        self.children: List["Span"] = []
        self.t1_ns = 0
        self.t0_ns = time.perf_counter_ns()

    @property
    def dur_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    def walk(self):
        """This span and every span under it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def render(self, depth: int = 0) -> str:
        f = "".join(
            f" {k}={v}" for k, v in self.fields.items()
        ) if self.fields else ""
        line = f"{'  ' * depth}{self.name} {self.dur_ms:.1f}ms{f}"
        return "\n".join(
            [line] + [c.render(depth + 1) for c in self.children]
        )


def _stack() -> List[Span]:
    s = getattr(_local, "spans", None)
    if s is None:
        s = _local.spans = []
    return s


def _device_events(device) -> Optional[tuple]:
    """(start, end, stream): two timed events on `device`'s current
    stream, the start recorded now; None off a CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, end, stream


def _resolve(root: Span) -> None:
    for sp in root.walk():
        if sp.events is not None:
            start, end, _stream = sp.events
            end.synchronize()
            sp.device_ms = float(start.elapsed_time(end))
            sp.events = None


@contextmanager
def span(name: str, *, device=None, **fields):
    """Instrument a block; nests under the enclosing span of this
    thread. The outermost span emits the whole tree when it closes.
    `device`: the device whose work inside the block is timed with CUDA
    events while tracing is on (no events off a CUDA device)."""
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is None:
        sp = Span(name, fields, next(_ids),
                  torch.autograd._profiler_enabled())
    else:
        sp = Span(name, fields, parent.trace_id, parent.on)
        parent.children.append(sp)
    stack.append(sp)
    rec = None
    if sp.on:
        rec = torch.profiler.record_function(name)
        rec.__enter__()
        sp.events = _device_events(device)
    ok = False
    try:
        yield sp
        if sp.events is not None:
            _start, end, stream = sp.events
            end.record(stream)
        ok = True
    finally:
        if rec is not None:
            rec.__exit__(None, None, None)
        sp.t1_ns = time.perf_counter_ns()
        stack.pop()
        if not ok:
            sp.events = None
        if parent is None:
            if ok and sp.on:
                _resolve(sp)
                with _kept_lock:
                    _kept.append(sp)
            if sp.dur_ms >= SLOW_ROOT_S * 1000:
                logger.warning("slow request trace:\n%s", sp.render())
            elif logger.isEnabledFor(logging.DEBUG):
                logger.debug("trace:\n%s", sp.render())


def tracing() -> bool:
    """Whether this thread's innermost open span is traced."""
    stack = _stack()
    return bool(stack) and stack[-1].on


def kept_spans() -> List[Span]:
    """The closed roots kept while tracing was on, oldest first."""
    with _kept_lock:
        return list(_kept)
