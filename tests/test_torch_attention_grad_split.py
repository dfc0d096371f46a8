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
kernels using 1xTF32. (Running sums of dK and dV on the tensor core, the
first design, drift further than the kernels' per-step sums:
`test_torch_attention_grad_drift.py`.) The emulator's step
(`train_bench._mma`, `_cut_f32`) gives the bits its first form gave.
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


def _trunc_f32_first(x):
    """The emulator's f64 -> f32 rounding toward zero as first written."""
    r = x.to(torch.float32)
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _mma_first(d, a, b, passes):
    """train_bench._mma as first written (on PyTorch's threads as set)."""
    from oramacore_tpu_torch.benches.attention_bench import split_tf32

    ah, al = (x.double() for x in split_tf32(a))
    bh, bl = (x.double() for x in split_tf32(b))
    steps = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k in range(0, a.shape[-1], 8):
        for x, y in steps:
            d = _trunc_f32_first(d.double() + x[..., k:k + 8]
                                 @ y[..., k:k + 8, :])
    return d


def _words(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulator_step_is_bit_for_bit_its_first_form(seed):
    """`_cut_f32` (the mantissa cut, with the rounding of its first form
    where the cut is not that rounding) and `_mma` (on one thread, its
    chain held in f64) give every bit their first forms give: on values
    spread over the whole f64 range (f32 subnormals, values beyond the f32
    range, +-0, +-inf, NaN) and on chains of products of seeded operands
    whose magnitudes span 2^-150 to 2^132 (f32 subnormal and overflowing
    sums), at 1 and 3 passes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=20_000) * np.exp2(rng.uniform(-160, 140, 20_000))
    x = torch.from_numpy(np.concatenate([x, [
        0.0, -0.0, np.inf, -np.inf, np.nan, 3.5e38, -3.41e38, 1e-40,
        -1e-45, 2.0 ** -126, 2.0 ** -126 * (1 - 2.0 ** -30), 2.0 ** -150,
        np.finfo(np.float32).max * (1 + 2.0 ** -30)]]))
    assert torch.equal(_words(tb._cut_f32(x).to(torch.float32)),
                       _words(_trunc_f32_first(x)))
    scale = torch.from_numpy(np.exp2(np.array([-75, -70, -64, 0, 20, 66])
                                     [rng.permutation(6)][:, None, None]))
    a = (torch.from_numpy(rng.normal(size=(6, 16, 24))) * scale).float()
    b = (torch.from_numpy(rng.normal(size=(6, 24, 8))) * scale).float()
    d = (torch.from_numpy(rng.normal(size=(6, 16, 8))) * scale ** 2).float()
    for passes in (1, 3):
        assert torch.equal(_words(tb._mma(d, a, b, passes)),
                           _words(_mma_first(d, a, b, passes)))
