"""Readings of the device from `torch.profiler`, over a steady window of
whole batches.

The profiler keeps device activity whose timestamps fall inside its
window and takes the window's edges on the host's clock, so the profiled
batches start `EDGE_S` after it opens and it closes `EDGE_S` after they
have finished; a traced warm-up step, which the profiler discards, comes
first (without it a profile once dropped kernels late in a long run).

From the exported trace:

- busy: the union of the intervals of every device operation (kernels,
  copies, fills) inside the harness's `bench.window` span, so kernels
  that overlap count once; the window is that span's length;
- each hand-written kernel's count in the profile must equal the count
  its wrapper's `LAUNCHES` took for the same batches, or the reading is
  taken again (at most `TRIES` readings; a run whose readings all miss
  launches fails); the wrappers and their device functions' names come
  from the program (`system.wrapper_modules`, `system.kernel_functions`);
- the breakdown: device time by operation, and the idle gaps by what the
  host was doing at each gap's middle: the innermost host event then
  running, under the harness's own span (`bench.batch`, the executor
  call from token lists to results on the host), or between batches.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

EDGE_S = 0.005
TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
HARNESS_SPANS = ("bench.batch",)
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160

def kernel_patterns(functions: Dict[str, object]) -> Dict[str, "re.Pattern"]:
    """A kernel's name may come demangled or mangled (`<length><name>`);
    an entry may launch one of several device functions (a tuple)."""
    def one(func: str) -> str:
        return rf"(?<![A-Za-z0-9_]){func}(?![A-Za-z0-9_])|{len(func)}{func}"

    return {name: re.compile("|".join(
                one(f) for f in ((funcs,) if isinstance(funcs, str) else funcs)))
            for name, funcs in functions.items()}


def profiled_counts(kernel_names: Sequence[str],
                    functions: Dict[str, object]) -> Dict[str, int]:
    """How often each entry's device function (`functions`: entry ->
    device function or a tuple of them, as the program names them) ran
    in the profile."""
    pats = kernel_patterns(functions)
    return {name: sum(1 for k in kernel_names if pat.search(k))
            for name, pat in pats.items()}


@dataclass
class Reading:
    n_batches: int
    window_s: float
    busy_s: float
    n_kernels: int
    launched: Dict[str, int]
    profiled: Dict[str, int]
    device_ops: List[list]
    idle_gaps: List[list]

    @property
    def busy_ms_per_batch(self) -> float:
        return 1e3 * self.busy_s / self.n_batches


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals, sorted."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _innermost(events: List[tuple], starts: np.ndarray, t: float) -> Optional[str]:
    """Name of the latest-starting event covering t (the innermost one for
    properly nested events): events sorted by start as (ts, end, name)."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - 4096, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def read_trace(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def analyse(events: list, n_batches: int, launched: Dict[str, int],
            functions: Dict[str, object]) -> Reading:
    """The reading of one exported trace of `n_batches` batches; `launched`
    counts each entry's launches, `functions` names its device function."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == "bench.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))]
                   for e in dev]).reshape(-1, 2)
    merged = _union(np.clip(iv, w0, w1))
    busy_us = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0

    by_op: Dict[str, float] = {}
    for e in dev:
        name = str(e.get("name", "?"))[:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + float(e.get("dur", 0)) / 1e6
    kernels = [str(e.get("name", "")) for e in dev if e.get("cat") == "kernel"]

    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
         str(e.get("name", "?"))[:NAME_CHARS])
        for e in xs if e.get("cat") in HOST_CATS
        and e.get("name") not in HARNESS_SPANS + ("bench.window",)
        and not str(e.get("name", "")).startswith("ProfilerStep"))
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
        for e in xs if e.get("name") in HARNESS_SPANS
        and e.get("cat") == "user_annotation")
    h_starts = np.array([h[0] for h in host])
    s_starts = np.array([s[0] for s in spans])
    edges = [w0] + [x for pair in merged.tolist() for x in pair] + [w1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = _innermost(spans, s_starts, mid) if spans else None
        op = _innermost(host, h_starts, mid) if host else None
        label = f"{span or 'between batches'}: {op or 'host Python'}"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6

    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                     [:BREAKDOWN_ENTRIES]]
    return Reading(
        n_batches=n_batches, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        n_kernels=len(kernels), launched=launched,
        profiled=profiled_counts(kernels, functions),
        device_ops=top(by_op), idle_gaps=top(gaps),
    )


def _profile_once(run: Callable, slots: Sequence[int], warm_slot: int,
                  launch_counts: Callable[[], Dict[str, int]],
                  kernel_functions: Callable[[], Dict[str, object]]):
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            run(warm_slot)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(EDGE_S)
            before = launch_counts()
            with record_function("bench.window"):
                for s in slots:
                    with record_function("bench.batch"):
                        run(s)
                torch.cuda.synchronize()
            after = launch_counts()
            time.sleep(EDGE_S)
            prof.step()
        launched = {k: n - before.get(k, 0) for k, n in after.items()}
        return analyse(read_trace(path), len(slots), launched,
                       kernel_functions())
    finally:
        os.unlink(path)


def profile_batches(run: Callable, slots: Sequence[int], warm_slot: int,
                    launch_counts: Callable[[], Dict[str, int]],
                    kernel_functions: Callable[[], Dict[str, object]],
                    log: Callable[[str], None]) -> Reading:
    """A reading whose profiled kernel counts equal the wrappers' counts."""
    for attempt in range(1, TRIES + 1):
        reading = _profile_once(run, slots, warm_slot, launch_counts,
                                kernel_functions)
        off = reading_mismatch(reading)
        if not off:
            return reading
        log(f"trace reading {attempt} of {TRIES} missed launches "
            f"(launched, profiled): {off}; read again")
    raise RuntimeError(
        f"every trace reading missed launches (launched, profiled): {off}; "
        "a device function renamed needs its wrapper's KERNELS "
        "(entry -> device function) beside LAUNCHES")


def reading_mismatch(reading: Reading) -> Dict[str, tuple]:
    prof = reading.profiled
    return {k: (n, prof.get(k, 0)) for k, n in reading.launched.items()
            if n != prof.get(k, 0)}
