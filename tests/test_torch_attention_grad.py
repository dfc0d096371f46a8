"""The gradient of the port's encoder attention against JAX's autodiff
(CPU): `encoder_attention_backward_plain` against `jax.vjp` of the
attention lines of `bert_forward` (`flax_encoder.py:97-105`) and against
`torch.autograd.grad` through `encoder_attention_plain`, the autograd
Function `EncoderAttention` (gradcheck in f64), the f64 reference that
the card's check uses, and the backward kernels' bound.

Tolerances: rtol and atol 1e-5 in f32 (sums over up to 37 keys in
another order, gradients of magnitude up to about 15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oramacore_tpu_torch.benches import (
    H100_F32_OPS_PER_S,
    H100_TF32X3_OPS_PER_S,
    bound_ms,
)
from oramacore_tpu_torch.benches import train_bench as tb
from oramacore_tpu_torch.ops import attention as at

TOL = 1e-5


def _jax_attention(qkv, mask, n_heads):
    """flax_encoder.py:97-105 on a (B, L, 3D) projection, as there."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_heads
    q = qkv[..., :D].reshape(B, L, n_heads, hd)
    k = qkv[..., D:2 * D].reshape(B, L, n_heads, hd)
    v = qkv[..., 2 * D:].reshape(B, L, n_heads, hd)
    neg = jnp.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    att = jax.nn.softmax(att + neg, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)


def _inputs(hd, L, seed, H=2, B=4):
    """qkv, dctx (f32) and a mask with a full row, partly masked rows and
    (last) a row whose keys are all masked."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * H * hd)).astype(np.float32)
    dctx = rng.normal(size=(B, L, H * hd)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    lens[-1] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return qkv, mask, dctx


def _jax_vjp(qkv, mask, dctx, H):
    return np.asarray(_vjp(jnp.asarray(qkv), jnp.asarray(mask),
                           jnp.asarray(dctx), H))


@jax.jit
def _vjp_jit(qkv, mask, dctx, heads):
    return jax.vjp(lambda x: _jax_attention(x, mask, heads.shape[0]),
                   qkv)[1](dctx)[0]


def _vjp(qkv, mask, dctx, H):
    # the head count travels as a shape, so jit keys on it
    return _vjp_jit(qkv, mask, dctx, jnp.zeros(H))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 37])
def test_backward_plain_matches_jax_vjp(hd, L):
    qkv, mask, dctx = _inputs(hd, L, seed=hd + L)
    want = _jax_vjp(qkv, mask, dctx, 2)
    got = at.encoder_attention_backward_plain(
        torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(dctx),
        2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the wholly masked row: P uniform in f32, so dS is not zero there
    D = 2 * hd
    if L > 1:
        assert np.abs(want[-1, :, :D]).max() > 1e-3
    # on the CPU the wrapper is its plain version
    np.testing.assert_array_equal(at.encoder_attention_backward(
        torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(dctx),
        2).numpy(), got)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 37])
def test_backward_plain_matches_autograd(hd, L):
    qkv, mask, dctx = _inputs(hd, L, seed=100 + hd + L)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = at.encoder_attention_plain(x, torch.from_numpy(mask), 2)
    (want,) = torch.autograd.grad(out, x, torch.from_numpy(dctx))
    got = at.encoder_attention_backward_plain(
        torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(dctx),
        2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_encoder_attention_function_gradcheck():
    """EncoderAttention in f64 at a tiny shape (hd 16, a partly masked
    row): its backward against finite differences."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 3, 3 * 16))).requires_grad_()
    mask = torch.tensor([[1, 1, 1], [1, 1, 0]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x: at.EncoderAttention.apply(x, mask, 1), (qkv,))


def test_encoder_attention_function_on_cpu():
    """Forward equals the plain version; backward equals the plain
    backward with no gradient for the mask; nothing counts as a launch."""
    qkv, mask, dctx = _inputs(32, 16, seed=3)
    before = dict(at.LAUNCHES)
    x = torch.from_numpy(qkv).requires_grad_(True)
    m = torch.from_numpy(mask)
    out = at.EncoderAttention.apply(x, m, 2)
    torch.testing.assert_close(out, at.encoder_attention_plain(x.detach(), m, 2),
                               rtol=0, atol=0)
    out.backward(torch.from_numpy(dctx))
    torch.testing.assert_close(x.grad, at.encoder_attention_backward_plain(
        x.detach(), m, torch.from_numpy(dctx), 2), rtol=0, atol=0)
    assert at.LAUNCHES == before
    with torch.inference_mode():
        assert not at.EncoderAttention.apply(x.detach(), m, 2).requires_grad


def test_backward_refuses_what_it_cannot_run():
    qkv = torch.zeros((2, 16, 3 * 64))
    mask = torch.ones((2, 16), dtype=torch.int32)
    # hd 8 is no longer refused: on the CPU it is the plain version
    torch.testing.assert_close(
        at.encoder_attention_backward(qkv, mask, torch.zeros((2, 16, 64)), 8),
        at.encoder_attention_backward_plain(qkv, mask,
                                            torch.zeros((2, 16, 64)), 8),
        rtol=0, atol=0)
    with pytest.raises(ValueError):       # dctx of another shape
        at.encoder_attention_backward(qkv, mask, torch.zeros((2, 15, 64)), 2)
    with pytest.raises(ValueError):       # the launcher never takes the CPU
        at.launch_backward(qkv, mask, torch.zeros((2, 16, 64)), 2)
    # the plain version takes any head width, as the forward's does
    assert at.encoder_attention_backward_plain(
        qkv, mask, torch.zeros((2, 16, 64)), 8).shape == (2, 16, 192)


@pytest.mark.parametrize("label", ["SemanticBase B=128 L=32, 28 padded rows",
                                   "SemanticBase B=2 L=1, 1 padded row",
                                   "SemanticBase B=16 L=37"])
def test_backward_reference_matches_jax_f32(label):
    """The card's f64 reference (P uniform in batch rows whose keys are
    all masked) against JAX's f32 vjp, padded rows included."""
    case = tb.BACKWARD_CASES[label]
    qkv, mask, dctx = tb.backward_inputs(case, 5, "cpu")
    want = _jax_vjp(qkv.numpy(), mask.numpy(), dctx.numpy(), case["H"])
    got = tb.backward_reference(qkv, mask, dctx, case["H"]).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # in f64 the plain version keeps those rows' scores apart instead
    dead = (mask > 0).sum(dim=1) == 0
    if dead.any() and case["L"] > 1:
        plain = at.encoder_attention_backward_plain(
            qkv.double(), mask, dctx, case["H"]).numpy()
        assert np.abs(plain[dead.numpy()] - want[dead.numpy()]).max() > 1e-3


def test_backward_work():
    # the training call: B=64, L=16, 8 heads of 32
    w = tb.backward_work(64, 16, 8, 32)
    D = 256
    assert w["total"] == (4 * 64 * 16 * (3 * D + D + 3 * D) + 4 * 64 * 16,
                          10 * 64 * 8 * 16 * 16 * 32)
    assert w["dq"][1] + w["dkv"][1] == 14 * 64 * 8 * 16 * 16 * 32
    assert w["dq"][0] == 4 * 64 * 16 * (5 * D + 1) + 16 * 64 * 8 * 16
    assert w["dkv"][0] == 4 * 64 * 16 * (6 * D + 1) + 16 * 64 * 8 * 16
    # BGEBase B=8 L=512: bound by its FLOPs at the 3xTF32 rate the kernels'
    # tensor-core products run at (the FFMA rate the earlier SIMT design ran
    # at gives the longer bound reported beside it)
    bge = tb.backward_work(8, 512, 12, 64)["total"]
    ms, by = bound_ms(*bge, H100_TF32X3_OPS_PER_S)
    assert by == "operations" and abs(ms - 16.106e9 / 165e12 * 1e3) < 1e-4
    ms, by = bound_ms(*bge, H100_F32_OPS_PER_S)
    assert by == "operations" and abs(ms - 16.106e9 / 67e12 * 1e3) < 1e-4
    # the training call and SemanticBase's B=1024 L=64 are bound by their
    # bytes at the 3xTF32 rate
    assert bound_ms(*w["total"], H100_TF32X3_OPS_PER_S)[1] == "bytes"
    assert bound_ms(*tb.backward_work(1024, 64, 8, 32)["total"],
                    H100_TF32X3_OPS_PER_S)[1] == "bytes"


def test_backward_cases_cover_the_widths():
    widths = {c["hd"] for c in tb.BACKWARD_CASES.values()}
    assert widths == set(at.HEAD_DIMS)
    assert {c["L"] for c in tb.BACKWARD_CASES.values()} >= {1, 16, 37, 512}
    assert any(c["padded"] for c in tb.BACKWARD_CASES.values())
