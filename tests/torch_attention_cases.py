"""Inputs and results of the wide backward kernels' arithmetic model that
several test files share (`tests/test_torch_attention_wide_split.py` and
`tests/test_torch_attention_wide_drift.py`), each computed once a process:
cached on the inputs that make it (head width, length, seed, passes,
chunking). Callers must not modify what they get."""

from __future__ import annotations

import functools

import torch

from oramacore_tpu_torch.benches import train_bench as tb
from tests.test_torch_attention_grad import _inputs


@functools.lru_cache(maxsize=None)
def wide_inputs(hd: int, L: int, seed: int) -> tuple:
    """(qkv, mask, dctx) as numpy arrays and as tensors, 2 heads of hd
    (`test_torch_attention_grad._inputs`: a full row, partly masked rows
    and a row whose keys are all masked)."""
    arrays = _inputs(hd, L, seed=seed)
    return arrays, tuple(torch.from_numpy(x) for x in arrays)


@functools.lru_cache(maxsize=None)
def wide_reference(hd: int, L: int, seed: int) -> torch.Tensor:
    """`train_bench.backward_reference` (f64) of those inputs."""
    return tb.backward_reference(*wide_inputs(hd, L, seed)[1], 2)


@functools.lru_cache(maxsize=None)
def wide_backward(hd: int, L: int, seed: int, passes: int = 3,
                  chunked: bool = True) -> torch.Tensor:
    """`train_bench.wide_backward_tf32` of those inputs."""
    return tb.wide_backward_tf32(*wide_inputs(hd, L, seed)[1], 2,
                                 passes=passes, chunked=chunked)
