"""Span tracing — the `tracing` #[instrument] analog.

Reference: the reference instruments hot paths with tracing spans
(bin/oramacore.rs:101-155 subscriber, #[instrument] throughout, e.g.
write/index/mod.rs:481) so operators can see WHERE a slow request spent
its time, not just that it was slow.

Python equivalent: `span(name, **fields)` context managers build a
thread-local span tree per request; when the ROOT span closes, the tree
is emitted to the `oramacore_tpu.trace` logger at DEBUG (one structured
line, children nested with durations) and slow roots (>`SLOW_ROOT_S`)
are logged at WARNING regardless of level — the flamegraph substitute
for production triage. Overhead when the logger is disabled and the
root is fast: two perf_counter calls and a list append per span.

The port's copy of `oramacore_tpu/utils/trace.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

logger = logging.getLogger("oramacore_tpu.trace")

SLOW_ROOT_S = 1.0

_local = threading.local()


class Span:
    __slots__ = ("name", "fields", "t0", "dur_ms", "children")

    def __init__(self, name: str, fields: Dict[str, Any]):
        self.name = name
        self.fields = fields
        self.t0 = time.perf_counter()
        self.dur_ms = 0.0
        self.children: List["Span"] = []

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


@contextmanager
def span(name: str, **fields):
    """Instrument a block; nests under the enclosing span of this
    thread. The outermost span emits the whole tree when it closes."""
    stack = _stack()
    sp = Span(name, fields)
    parent = stack[-1] if stack else None
    if parent is not None:
        parent.children.append(sp)
    stack.append(sp)
    try:
        yield sp
    finally:
        sp.dur_ms = (time.perf_counter() - sp.t0) * 1000
        stack.pop()
        if parent is None:
            if sp.dur_ms >= SLOW_ROOT_S * 1000:
                logger.warning("slow request trace:\n%s", sp.render())
            elif logger.isEnabledFor(logging.DEBUG):
                logger.debug("trace:\n%s", sp.render())


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None
