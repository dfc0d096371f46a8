"""The arithmetic of the attention's wide backward kernels (head widths
above 128), on the CPU: `benches/train_bench.wide_backward_tf32` (their
3xTF32 products as chains of tensor-core steps that truncate into their
accumulator, S and dP summed over the head a column chunk at a time, dQ,
dK and dV an 8-row step at a time, IEEE divisions, the row statistics)
against the f64 reference the card uses (`backward_reference`) and
against `jax.vjp` of the attention lines of `bert_forward`
(`flax_encoder.py:97-105`); and the tiling
`ops/attention.wide_backward_tiles_for`, held to the shared-memory budget
and to the instances that `csrc/encoder_attention_backward.cu` compiles.

Tolerances: `train_bench.BWD_TOL` = 5e-5 (rtol and atol) against f64, the
gate the card holds the kernels to; 1e-5 against JAX's f32 vjp, as the
plain version is held (`test_torch_attention_grad.py`). A single tf32
pass must miss the gate: the control that shows it would catch the
kernels using 1xTF32. The emulator's results are cached on their inputs
(`tests/torch_attention_cases.py`), which the drift test
(`test_torch_attention_wide_drift.py`) shares.
"""

import os
import re

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.benches import train_bench as tb
from oramacore_tpu_torch.ops import attention as at
from tests.test_torch_attention_grad import _inputs, _jax_vjp
from tests.torch_attention_cases import (
    wide_backward,
    wide_inputs,
    wide_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "oramacore_tpu_torch", "ops", "csrc",
                      "encoder_attention_backward.cu")
HEADER = os.path.join(os.path.dirname(SOURCE), "attention_wide.cuh")
TOL = 1e-5


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("hd", [136, 160, 256, 320])
@pytest.mark.parametrize("L", [1, 17, 37, 65])
def test_wide_backward_tf32_matches_reference_and_jax(hd, L):
    """Three passes per product: within the card's gate of the f64
    reference and within 1e-5 of JAX's vjp, with a full row, partly masked
    rows and a row whose keys are all masked (P uniform, dS not zero)."""
    (qkv, mask, dctx), (tq, _, _) = wide_inputs(hd, L, 300 + hd + L)
    got = wide_backward(hd, L, 300 + hd + L)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    assert torch.isfinite(got).all()
    ref = wide_reference(hd, L, 300 + hd + L)
    torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)
    np.testing.assert_allclose(got.numpy(), _jax_vjp(qkv, mask, dctx, 2),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hd,L", [(136, 37), (160, 17), (256, 65),
                                  (320, 37)])
def test_wide_backward_single_pass_misses_the_gate(hd, L):
    """The negative control: one tf32 pass per product, on the same
    inputs, is off by more than the gate allows."""
    ref = wide_reference(hd, L, 300 + hd + L)
    got = wide_backward(hd, L, 300 + hd + L, passes=1)
    err = (got.double() - ref).abs() - tb.BWD_TOL * ref.abs()
    assert float(err.max()) > tb.BWD_TOL


def _instances():
    """The chunks the .cu file compiles the wide kernels for."""
    with open(SOURCE) as f:
        src = f.read()
    return {int(m.group(1)) for m in re.finditer(
        r"^\s*WIDE_INSTANCE\((\d+)\)$", src, re.M)}


def _constant(name):
    """A constant of the wide kernels, in the .cu file or in the header it
    shares with the wide forward."""
    src = ""
    for path in (SOURCE, HEADER):
        with open(path) as f:
            src += f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_wide_backward_tiles_fit_and_cover():
    """Every tiling fits 2 blocks an SM in shared memory (227 KB a block
    at most, 228 KB an SM less 1 KB reserved a block), covers every row
    with its row tiles of 16 and every (b, h) with its grid, takes a chunk
    of 32 columns only where it computes no more padded columns than 16
    would, and is an instance the kernels compile (whose WideTile layout
    refuses a launch with another shared-memory size:
    `test_torch_cuda.py`)."""
    compiled = _instances()
    assert compiled == set(at.WIDE_CHUNKS)
    assert _constant("kRows") == at._WIDE_ROWS == 16
    assert 16 * _constant("kWideWarps") == at._WIDE_TILE
    assert 32 * _constant("kWideWarps") == at._WIDE_THREADS
    used = set()
    for hd in (1, 7, 129, 130, 136, 160, 192, 256, 320, 513, 1000):
        for L in range(1, at.MAX_LEN + 1):
            for B, H in ((1, 1), (3, 8), (64, 4), (1024, 8)):
                tl = at.wide_backward_tiles_for(B, H, L, hd)
                assert tl.smem <= 227 * 1024 and tl.blocks_per_sm >= 2
                assert 2 * (tl.smem + 1024) <= 228 * 1024
                assert tl.smem == at.wide_backward_smem(tl.chunk, L)
                assert tl.rows == 16
                assert tl.row_tiles * tl.rows >= L > (tl.row_tiles - 1) \
                    * tl.rows
                assert tl.grid == B * H * tl.row_tiles
                pad = {c: -(-hd // c) * c for c in (16, 32)}
                assert pad[tl.chunk] == min(pad.values())
                used.add(tl.chunk)
    assert used == compiled


def test_wide_backward_smem_is_the_kernels_layout():
    """Two score rows of L rounded up to 128 plus 4 floats for each of 16
    rows, and two ring stages of (2 x 16 + 2 x 128) rows of chunk + 4
    floats: at L = 512 and chunks of 16 that is 112,128 bytes, 2 blocks an
    SM; with chunks of 32, 148,992, one."""
    assert at.wide_backward_smem(16, 512) == 4 * (
        2 * 16 * 516 + 2 * (32 + 256) * 20) == 112_128
    assert at.wide_backward_smem(32, 512) == 148_992
    assert at.wide_backward_smem(32, 65) == 4 * (
        2 * 16 * 132 + 2 * (32 + 256) * 36)
    tl = at.wide_backward_tiles_for(8, 4, 512, 256)
    assert (tl.chunk, tl.smem, tl.blocks_per_sm) == (16, 112_128, 2)


def test_wide_backward_tiles_refuse_what_the_kernels_cannot_run():
    with pytest.raises(ValueError):
        at.wide_backward_tiles_for(1, 1, 16, 0)
    with pytest.raises(ValueError):
        at.wide_backward_tiles_for(1, 1, 513, 256)
    with pytest.raises(ValueError):
        at.wide_backward_tiles_for(1, 1, 0, 256)


def test_wide_launcher_refuses_cpu_tensors():
    """The wide launcher runs CUDA tensors only: a CPU call raises before
    anything is built or launched (the wrapper sends CPU tensors to the
    plain version)."""
    qkv, mask, dctx = _torch(*_inputs(160, 17, seed=1))
    before = dict(at.LAUNCHES)
    with pytest.raises(ValueError):
        at.launch_backward_wide(qkv, mask, dctx, 2)
    with pytest.raises(ValueError):
        at.launch_backward_wide(qkv, mask, dctx, 2, ("dkv",))
    assert at.LAUNCHES == before
