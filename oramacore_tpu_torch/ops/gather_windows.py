"""Posting-window gather: the wrapper of `csrc/gather_windows.cu`.

The port of `oramacore_tpu/ops/pallas_gather.py::gather_windows`:
`gather_windows(src, aligned_starts, w=w)` returns `src.dtype[NS, w]` with
row i equal to `src[s_i : s_i + w]`, and `gather_windows_plain` is its
plain PyTorch version.

- `src` is a contiguous 1-D int32 or float32 tensor (the slab's columns
  hold only these; the JAX function takes any 4-byte dtype). Any other
  dtype raises TypeError.
- `aligned_starts` is int32[NS]; the TPU needed multiples of `ALIGN`
  (`align_down` rounds a start down to one). The kernel takes any start,
  at full speed for multiples of 4.
- `w` must be a positive multiple of `ALIGN`; anything else raises
  ValueError, where the JAX function asserts.
- Slots outside `[0, len(src))` read 0, as in `score_windows`. Callers
  pad the slab, so a well-formed call never reaches them.
- The JAX function's `rows_per_program` sized the TPU grid (windows per
  program); the CUDA grid has one block per 1024-word slice of a window,
  so the knob is dropped.

A CPU tensor runs the plain version. A CUDA tensor launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .score_windows import _check, _device_of, _raise_on

ALIGN = 1024  # the TPU's HBM slice alignment for 4-byte 1-D slabs

# Kernel launches, counted only where the kernel is enqueued (never for
# the plain version). Reset with reset_launch_counts.
LAUNCHES = {"gather_windows": 0}

_DTYPES = (torch.int32, torch.float32)

_lib = None


def align_down(start: int) -> int:
    return start & ~(ALIGN - 1)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("gather_windows")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.gather_windows_launch.argtypes = [ptr, i64, ptr, i64, i64, ptr, ptr]
        lib.gather_windows_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_windows_plain(src: torch.Tensor, aligned_starts: torch.Tensor,
                         w: int) -> torch.Tensor:
    """Plain PyTorch version of `gather_windows` (one index gather)."""
    n = src.shape[0]
    idx = aligned_starts.to(torch.int64)[:, None] + torch.arange(
        w, device=src.device, dtype=torch.int64
    )
    inside = (idx >= 0) & (idx < n)
    return src[idx.clamp(0, max(n - 1, 0))].masked_fill(~inside, 0)


def gather_windows(src: torch.Tensor, aligned_starts: torch.Tensor, *,
                   w: int) -> torch.Tensor:
    """Returns `src.dtype[NS, w]` windows `src[s : s + w]`; see the module
    doc."""
    if src.dtype not in _DTYPES:
        raise TypeError(f"src: expected int32 or float32, got {src.dtype}")
    _check(src, "src", src.dtype, 1)
    _check(aligned_starts, "aligned_starts", torch.int32, 1)
    if w <= 0 or w % ALIGN:
        raise ValueError(f"w must be a positive multiple of {ALIGN}, got {w}")
    dev = _device_of((src, aligned_starts))
    if dev.type == "cpu":
        return gather_windows_plain(src, aligned_starts, w)
    if src.data_ptr() % 16:
        raise ValueError("src must start on a 16-byte boundary")
    lib = load_kernels()
    ns = aligned_starts.shape[0]
    out = torch.empty((ns, w), dtype=src.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_windows_launch(
            src.data_ptr(), src.shape[0], aligned_starts.data_ptr(), ns, w,
            out.data_ptr(), stream,
        )
    _raise_on(err, "gather_windows")
    _build.count_launch(LAUNCHES, "gather_windows")
    return out
