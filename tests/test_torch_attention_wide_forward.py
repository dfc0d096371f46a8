"""The arithmetic of the attention's wide forward kernel (head widths above
128), on the CPU: `benches/attention_bench.wide_attention_tf32` (its
3xTF32 products as chains of tensor-core steps that truncate into their
accumulator, S summed over the head a column chunk at a time, the IEEE
division and the -1e9 bias, the exact softmax, O an 8-key step at a time)
against the f64 reference the card uses (`encoder_bench.
attention_reference`) and against JAX's attention lines of `bert_forward`
(`flax_encoder.py:97-105`, jitted on the CPU as in
`test_torch_attention_split.py`); and the tiling
`ops/attention.wide_tiles_for`, held to the shared-memory budget and to
the constants and instances that `csrc/encoder_attention.cu` and
`csrc/attention_wide.cuh` compile.

Tolerances: `ATTN_TOL` = 1e-5 (rtol and atol) against f64, the gate the
card holds the kernel to, and 1e-5 against JAX's f32 attention. A single
tf32 pass must miss the gate: the control that shows it would catch the
kernel using 1xTF32. Each emulator result is computed once (cached on its
inputs) and shared by the tests that read it.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.benches.attention_bench import (
    ATTN_TOL,
    wide_attention_tf32,
)
from oramacore_tpu_torch.benches.encoder_bench import (
    attention_inputs,
    attention_reference,
)
from oramacore_tpu_torch.ops import attention as at
from tests.test_torch_attention_grad import _inputs
from tests.test_torch_attention_split import _jax_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "oramacore_tpu_torch", "ops", "csrc")
SOURCE = os.path.join(CSRC, "encoder_attention.cu")
HEADER = os.path.join(CSRC, "attention_wide.cuh")

# (hd, L, B, H): 4 batch rows of 2 heads (a full row, partly masked rows
# and a row whose keys are all masked), and one full row at L = 512
CASES = [(hd, L, 4, 2) for hd in (136, 160, 256, 320) for L in (1, 17, 37)]
CASES += [(320, 65, 4, 2), (256, 512, 1, 1)]


@functools.lru_cache(maxsize=None)
def _case(hd, L, B, H):
    """(qkv, mask) of a case, from a seed."""
    if B == 1:
        return attention_inputs(dict(B=B, L=L, H=H, hd=hd, padded=0),
                                400 + hd + L, "cpu")
    qkv, mask, _ = _inputs(hd, L, seed=400 + hd + L, H=H, B=B)
    return torch.from_numpy(qkv), torch.from_numpy(mask)


@functools.lru_cache(maxsize=None)
def _reference(hd, L, B, H):
    qkv, mask = _case(hd, L, B, H)
    return attention_reference(qkv, mask, H)


@functools.lru_cache(maxsize=None)
def _tf32(hd, L, B, H, passes=3, chunked=True):
    qkv, mask = _case(hd, L, B, H)
    return wide_attention_tf32(qkv, mask, H, passes=passes, chunked=chunked)


@pytest.mark.parametrize("hd,L,B,H", CASES)
def test_wide_forward_tf32_matches_reference_and_jax(hd, L, B, H):
    """Three passes per product: within the card's gate of the f64
    reference and within 1e-5 of JAX's attention."""
    qkv, mask = _case(hd, L, B, H)
    got = _tf32(hd, L, B, H)
    assert got.dtype == torch.float32 and got.shape == (B, L, H * hd)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), _reference(hd, L, B, H),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    want = np.asarray(_jax_attention(qkv.numpy(), mask.numpy(), np.zeros(H)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,L,B,H", [(136, 37, 4, 2), (256, 17, 4, 2),
                                      (320, 65, 4, 2), (256, 512, 1, 1)])
def test_wide_forward_single_pass_misses_the_gate(hd, L, B, H):
    """The negative control: one tf32 pass per product, on the same
    inputs, is off by more than the gate allows."""
    ref = _reference(hd, L, B, H)
    got = _tf32(hd, L, B, H, passes=1)
    err = (got.double() - ref).abs() - ATTN_TOL * ref.abs()
    assert float(err.max()) > ATTN_TOL


@pytest.mark.parametrize("hd,L", [(320, 65), (256, 37)])
def test_wide_forward_chunked_sums_over_the_head_drift_less(hd, L):
    """S summed a column chunk at a time from 0 (the kernel) against one
    chain over the whole head on the tensor core: under the emulator's
    truncation model the chunks stay within the gate, and the one chain
    is off by more than twice as much (the card truncates harder than the
    model: see `train_bench.backward_tf32`)."""
    ref = _reference(hd, L, 4, 2)
    errs = {}
    for chunked in (True, False):
        got = _tf32(hd, L, 4, 2, chunked=chunked)
        errs[chunked] = float((got.double() - ref).abs().max())
    torch.testing.assert_close(_tf32(hd, L, 4, 2).double(), ref,
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    assert errs[False] > 2 * errs[True], errs


def _source():
    src = ""
    for path in (SOURCE, HEADER):
        with open(path) as f:
            src += f.read()
    return src


def _instances():
    """The (chunk, rows) pairs the .cu file compiles the wide forward
    for."""
    return {(int(m.group(1)), int(m.group(2))) for m in re.finditer(
        r"^\s*WIDE_FWD_INSTANCE\((\d+), (\d+)\)$", _source(), re.M)}


def _constant(name):
    """The expression a constant of the kernel or its header is set to."""
    return re.search(rf"constexpr int {name} = ([^;]+);",
                     _source()).group(1)


def test_wide_tiles_fit_and_cover():
    """Every tiling fits the blocks an SM its launch bound asks for in
    shared memory (3 of 16 rows, 2 of 32; 227 KB a block at most, 228 KB
    an SM less 1 KB reserved a block), covers every query row with its row
    tiles and every (b, h) with its grid, takes a chunk of 32 columns only
    where it computes no more padded columns than 16 would, and is an
    instance the kernel compiles (whose TileLayout refuses a launch with
    another shared-memory size: `test_torch_cuda.py`)."""
    compiled = _instances()
    assert compiled == {(c, r) for c in at.WIDE_CHUNKS
                        for r in at.WIDE_FWD_ROWS}
    used = set()
    for hd in (1, 7, 129, 132, 136, 160, 192, 256, 320, 513, 1000):
        for L in range(1, at.MAX_LEN + 1):
            for rows in (None, *at.WIDE_FWD_ROWS):
                for B, H in ((1, 1), (3, 8), (1024, 8)):
                    tl = at.wide_tiles_for(B, H, L, hd, rows)
                    blocks = at._WIDE_FWD_BLOCKS[tl.rows]
                    assert rows in (None, tl.rows)
                    assert tl.smem <= 227 * 1024
                    assert tl.blocks_per_sm >= blocks
                    assert blocks * (tl.smem + 1024) <= 228 * 1024
                    assert tl.smem == at.wide_smem(tl.rows, tl.chunk, L)
                    assert tl.row_tiles * tl.rows >= L > (
                        tl.row_tiles - 1) * tl.rows
                    assert tl.grid == B * H * tl.row_tiles
                    pad = {c: -(-hd // c) * c for c in (16, 32)}
                    assert pad[tl.chunk] == min(pad.values())
                    used.add((tl.chunk, tl.rows))
    assert used == compiled


def test_wide_rows_follow_the_grid():
    """32 query rows a block, but 16 at L <= 16 and where 32-row blocks
    would number fewer than the H100's 132 SMs: the choice the card's
    sweep made at encoder_bench.WIDTH_CASES and attention_bench.WIDE_SWEEP
    (B, H, L)."""
    rows = {(B, H, L): at.wide_rows(B, H, L) for B, H, L in (
        (8, 2, 64), (8, 4, 512), (4, 3, 128), (64, 4, 65), (256, 4, 16),
        (128, 4, 32), (48, 4, 100), (16, 4, 256), (33, 4, 32),
        (11, 3, 128))}
    assert rows == {
        (8, 2, 64): 16, (8, 4, 512): 32, (4, 3, 128): 16, (64, 4, 65): 32,
        (256, 4, 16): 16, (128, 4, 32): 32, (48, 4, 100): 32,
        (16, 4, 256): 32, (33, 4, 32): 32, (11, 3, 128): 32}
    assert at.wide_tiles_for(8, 2, 64, 160).rows == 16


def test_wide_forward_smem_is_the_kernels_layout():
    """The constants of the kernel and its header, and its shared memory:
    one score row of L rounded up to 128 plus 4 floats for each of its
    rows, and two ring stages of (rows + 128) rows of chunk + 4 floats;
    at L = 512 and chunks of 32, 74,496 bytes with 16 rows (3 blocks an
    SM) and 112,128 with 32 (2)."""
    assert _constant("kWideWarps") == "8"
    assert _constant("kWideThreads") == "32 * kWideWarps"
    assert _constant("kTile") == "16 * kWideWarps"
    assert (at._WIDE_THREADS, at._WIDE_TILE) == (32 * 8, 16 * 8)
    assert re.search(r"return MT == 1 \? (\d) : (\d);", _source()).groups() \
        == tuple(str(at._WIDE_FWD_BLOCKS[r]) for r in (16, 32))
    assert at.wide_smem(16, 32, 512) == 4 * (
        16 * 516 + 2 * (16 + 128) * 36) == 74_496
    assert at.wide_smem(32, 32, 512) == 4 * (
        32 * 516 + 2 * (32 + 128) * 36) == 112_128
    assert at.wide_smem(32, 16, 65) == 4 * (32 * 132 + 2 * 160 * 20)
    tl = at.wide_tiles_for(8, 4, 512, 256, 32)
    assert (tl.chunk, tl.smem, tl.blocks_per_sm) == (32, 112_128, 2)
    assert at.wide_tiles_for(8, 4, 512, 256, 16).blocks_per_sm == 3


def test_wide_tiles_refuse_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        at.wide_tiles_for(1, 1, 16, 0)
    with pytest.raises(ValueError):
        at.wide_tiles_for(1, 1, 513, 256)
    with pytest.raises(ValueError):
        at.wide_tiles_for(1, 1, 0, 256)
    with pytest.raises(ValueError):
        at.wide_tiles_for(1, 1, 64, 256, rows=64)


def test_wide_forward_launcher_refuses_cpu_tensors():
    """The wide launcher runs CUDA tensors only: a CPU call raises before
    anything is built or launched (the wrapper sends CPU tensors to the
    plain version)."""
    qkv, mask = _case(160, 17, 4, 2)
    before = dict(at.LAUNCHES)
    with pytest.raises(ValueError):
        at.launch_wide(qkv, mask, 2)
    assert at.LAUNCHES == before
