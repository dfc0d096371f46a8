"""Benchmarks of the port (counterparts of the repo's `benches/`), and the
two measuring helpers that they and `chip_smoke.py` share."""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them; every device number is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
