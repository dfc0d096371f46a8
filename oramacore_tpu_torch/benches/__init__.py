"""Benchmarks of the port (counterparts of the repo's `benches/`), and the
measuring helpers that they and `chip_smoke.py` share."""

from __future__ import annotations

import subprocess

import torch

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
# sheet): device-memory bandwidth, f32 operations outside the tensor
# cores, and f32 products on the tensor cores as 3xTF32 (three tf32
# products for each f32 one, at the dense TF32 rate of 495 TFLOP/s).
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_TF32X3_OPS_PER_S = 495e12 / 3


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_F32_OPS_PER_S) -> tuple:
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of the bytes the work must move over the memory rate and its
    operations over the peak rate for their type."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def time_graph(fn, reps: int) -> float:
    """Device ms per call of `fn`: one warm-up call, then `fn` captured
    once in a CUDA graph and replayed `reps` times between CUDA events, so
    the host's cost of launching does not count. `fn` launches work on
    the current stream and synchronizes nothing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_cuda(graph.replay, reps)
