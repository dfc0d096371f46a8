"""The arithmetic of the attention's backward kernels, on the CPU:
`benches/train_bench.backward_tf32` (the kernels' key and query tiles,
their 3xTF32 products as chains of tensor-core steps that truncate into
their accumulator, IEEE divisions, online statistics and delta =
rowsum(P * dP)) against the f64 reference the card uses
(`backward_reference`) and against `jax.vjp` of the attention lines of
`bert_forward` (`flax_encoder.py:97-105`); and the tiling
`ops/attention.backward_tiles_for`, held to the shared-memory and
occupancy budget and to the kernel instances that
`csrc/encoder_attention_backward.cu` compiles.

Tolerances: `train_bench.BWD_TOL` = 5e-5 (rtol and atol) against f64, the
gate the card holds the kernels to; 1e-5 against JAX's f32 vjp, as the
plain version is held (`test_torch_attention_grad.py`). A single tf32
pass must miss the gate: the control that shows it would catch the
kernels using 1xTF32. Running sums of dK and dV on the tensor core (the
first design) drift further than the kernels' per-step sums, though the
emulator's truncation model is milder than the card's.
"""

import os
import re

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.benches import train_bench as tb
from oramacore_tpu_torch.ops import attention as at
from tests.test_torch_attention_grad import _inputs, _jax_vjp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "oramacore_tpu_torch", "ops", "csrc",
                      "encoder_attention_backward.cu")
TOL = 1e-5


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 17, 37, 65])
def test_backward_tf32_matches_reference_and_jax(hd, L):
    """Three passes per product: within the card's gate of the f64
    reference and within 1e-5 of JAX's vjp, with a full row, partly masked
    rows and a row whose keys are all masked (P uniform, dS not zero)."""
    qkv, mask, dctx = _inputs(hd, L, seed=200 + hd + L)
    tq, tm, td = _torch(qkv, mask, dctx)
    got = tb.backward_tf32(tq, tm, td, 2)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    assert torch.isfinite(got).all()
    ref = tb.backward_reference(tq, tm, td, 2)
    torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)
    np.testing.assert_allclose(got.numpy(), _jax_vjp(qkv, mask, dctx, 2),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("label", ["SemanticBase B=64 L=33, 8 padded rows",
                                   "SemanticBase B=32 L=65"])
def test_backward_tf32_at_the_new_cases(label):
    """The two cases where the tiling changes (W switches at L = 32; a
    partial last tile at L = 65), at the card's size, against f64."""
    case = tb.BACKWARD_CASES[label]
    qkv, mask, dctx = tb.backward_inputs(case, 7, "cpu")
    got = tb.backward_tf32(qkv, mask, dctx, case["H"])
    ref = tb.backward_reference(qkv, mask, dctx, case["H"])
    torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                               atol=tb.BWD_TOL)


@pytest.mark.parametrize("hd,L", [(32, 37), (64, 65), (128, 17)])
def test_backward_single_pass_misses_the_gate(hd, L):
    """The negative control: one tf32 pass per product, on the same
    inputs, is off by more than the gate allows."""
    qkv, mask, dctx = _torch(*_inputs(hd, L, seed=200 + hd + L))
    ref = tb.backward_reference(qkv, mask, dctx, 2)
    got = tb.backward_tf32(qkv, mask, dctx, 2, passes=1)
    err = (got.double() - ref).abs() - tb.BWD_TOL * ref.abs()
    assert float(err.max()) > tb.BWD_TOL


@pytest.mark.parametrize("hd", [64, 128])
def test_backward_tf32_running_sums_drift_further(hd):
    """At L = 512 the kernels' design (dK and dV summed per 8-query step
    from 0, then added rounded) against the first design's running sums
    on the tensor core: under the emulator's truncation model both stay
    within the gate and the running sums are off by more than twice as
    much in dK and dV. (The card read 5.14e-5 and 6.6e-6 at BGEBase: the
    model is milder than the card, see `backward_tf32`.)"""
    case = dict(B=1, L=512, H=2, hd=hd, padded=0)
    qkv, mask, dctx = tb.backward_inputs(case, 160, "cpu")
    ref = tb.backward_reference(qkv, mask, dctx, 2)
    D = 2 * hd
    errs = {}
    for acc in ("steps", "running"):
        got = tb.backward_tf32(qkv, mask, dctx, 2, accumulate=acc)
        torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                                   atol=tb.BWD_TOL)
        errs[acc] = float((got.double() - ref)[..., D:].abs().max())
    assert errs["running"] > 2 * errs["steps"], errs


def test_backward_tf32_refuses_other_accumulations():
    qkv, mask, dctx = _torch(*_inputs(32, 16, seed=1))
    with pytest.raises(ValueError):
        tb.backward_tf32(qkv, mask, dctx, 2, accumulate="exact")
    with pytest.raises(ValueError):
        tb.backward_tf32(qkv, mask, dctx, 2, passes=2)


def _instances(kind):
    """{(hd, W, G, T)} the .cu file compiles for `kind` ("DQ" or "DKV")."""
    with open(SOURCE) as f:
        src = f.read()
    return {tuple(int(x) for x in m.groups()) for m in re.finditer(
        rf"^\s*{kind}_INSTANCE\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)}


def test_backward_tiles_fit_and_cover():
    """Every tiling fits 2 blocks an SM in shared memory (227 KB a block
    at most) and registers, covers every row and pair, takes a one-stage
    ring only where one tile covers L, and is an instance the kernels
    compile (whose DqTile / DkvTile layouts refuse a launch with another
    shared-memory size: `test_torch_cuda.py`)."""
    compiled = {"dq": _instances("DQ"), "dkv": _instances("DKV")}
    assert len(compiled["dq"]) == len(compiled["dkv"]) == 12
    used = {"dq": set(), "dkv": set()}
    for hd in at.HEAD_DIMS:
        for L in range(1, at.MAX_LEN + 1):
            for B, H in ((1, 1), (3, 8), (1024, 8)):
                for kind, tl in at.backward_tiles_for(B, H, L, hd).items():
                    W, T, G = tl.warps, tl.tile, tl.pairs
                    assert tl.smem <= 227 * 1024 and tl.blocks_per_sm >= 2
                    assert 32 * W * G <= 128 and T % 16 == 0
                    assert W == 4 or 16 * W >= L
                    assert tl.row_tiles * 16 * W >= L > (tl.row_tiles - 1) \
                        * 16 * W
                    groups, rem = divmod(tl.grid, tl.row_tiles)
                    assert rem == 0 and groups * G >= B * H > (groups - 1) * G
                    assert tl.stages == (1 if T >= L else 2)
                    used[kind].add((hd, W, G, T))
    assert used == compiled


def test_backward_tiles_refuse_what_the_kernels_cannot_run():
    with pytest.raises(ValueError):
        at.backward_tiles_for(1, 1, 16, 8)
    with pytest.raises(ValueError):
        at.backward_tiles_for(1, 1, 513, 32)
