"""The arithmetic of the encoder attention kernel, on the CPU: the tf32
rounding (cvt.rna.tf32.f32) bit for bit, the 3xTF32 split, and the
attention built from it (`benches/attention_bench.attention_tf32`, the
kernel's products, division, bias, online softmax over its key tiles)
against the f64 reference and the JAX encoder's attention.

Tolerance: `ATTN_TOL` = 1e-5 (rtol and atol), the gate the card holds the
kernel to. A single tf32 pass must miss it: that is the control showing
the gate would catch the kernel using 1xTF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from oramacore_tpu_torch.benches.attention_bench import (
    ATTN_TOL,
    attention_tf32,
    split_tf32,
    tf32_rna,
)
from oramacore_tpu_torch.benches.encoder_bench import (
    attention_inputs,
    attention_reference,
)
from oramacore_tpu_torch.ops import attention as at


def _bits(*words):
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32)
                            ).view(torch.float32)


def _words(x):
    return [w & 0xFFFFFFFF for w in x.view(torch.int32).tolist()]


@pytest.mark.parametrize("word,want", [
    (0x3F800000, 0x3F800000),   # 1.0, already tf32
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero (even: 1)
    (0xBF801000, 0xBF802000),   # its negative, away from zero too
    (0x3F800FFF, 0x3F800000),   # just under the tie: down
    (0x3F801001, 0x3F802000),   # just over: up
    (0x3F803000, 0x3F804000),   # a tie whose even neighbour is also up
    (0x3FFFF000, 0x40000000),   # a tie that carries into the exponent
    (0x00001000, 0x00002000),   # the least subnormal tie: up
    (0x00000FFF, 0x00000000),   # a subnormal under half a tf32 ulp: 0
    (0x80000FFF, 0x80000000),   # ... and its negative: -0
    (0x007FF000, 0x00800000),   # the largest subnormal tie: the least normal
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x7F800000, 0x7F800000),   # +inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x7F7FEFFF, 0x7F7FE000),   # near the largest finite: down
])
def test_tf32_rna_bit_for_bit(word, want):
    assert _words(tf32_rna(_bits(word))) == [want]


def test_tf32_rna_keeps_nan_and_ten_mantissa_bits():
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    r = tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # within half a tf32 ulp: 2^-11 of the magnitude
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()


def test_split_is_exact_to_2_pow_minus_22():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=1 << 16).astype(np.float32) * 10)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.abs().double() * 2.0 ** -22).all()
    # and the product of two splits, less its lo * lo, is f32-accurate
    y = x.flip(0)
    yh, yl = split_tf32(y)
    three = (lo.double() * yh.double() + hi.double() * yl.double()
             + hi.double() * yh.double())
    exact = x.double() * y.double()
    assert ((three - exact).abs() <= exact.abs() * 2.0 ** -21).all()


# (B, L, H, hd, padded): L=512 at hd 64 and 32, ragged L (a partial last
# key tile), one key tile, L below 16 and L=1, rows with no key
CASES = [
    (1, 512, 2, 64, 0),
    (1, 512, 2, 32, 0),
    (2, 77, 2, 64, 1),
    (3, 64, 2, 32, 1),
    (4, 32, 2, 32, 1),
    (2, 16, 2, 64, 0),
    (3, 5, 2, 32, 1),
    (2, 1, 2, 32, 1),
]


def _case(B, L, H, hd, padded, seed):
    return attention_inputs(dict(B=B, L=L, H=H, hd=hd, padded=padded), seed,
                            "cpu")


def test_attn_tol_is_the_card_gate():
    assert ATTN_TOL == chip_smoke.ATTN_TOL == 1e-5


@pytest.mark.parametrize("B,L,H,hd,padded", CASES)
def test_three_pass_attention_within_tolerance(B, L, H, hd, padded):
    qkv, mask = _case(B, L, H, hd, padded, 1000 + L + hd)
    ref = attention_reference(qkv, mask, H)
    got = attention_tf32(qkv, mask, H, passes=3)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("B,L,H,hd,padded", [c for c in CASES if c[1] >= 16])
def test_single_pass_attention_misses_tolerance(B, L, H, hd, padded):
    """The negative control: one tf32 pass per product, on the same
    inputs, is off by far more than the gate allows."""
    qkv, mask = _case(B, L, H, hd, padded, 1000 + L + hd)
    ref = attention_reference(qkv, mask, H)
    got = attention_tf32(qkv, mask, H, passes=1)
    err = float((got.double() - ref).abs().max())
    assert err > 10 * ATTN_TOL
    assert not torch.allclose(got.double(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)


@jax.jit
def _jax_attention(qkv, mask, n_heads_marker):
    """flax_encoder.py:97-105 on a (B, L, 3D) projection."""
    H = n_heads_marker.shape[0]
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    q = qkv[..., :D].reshape(B, L, H, hd)
    k = qkv[..., D:2 * D].reshape(B, L, H, hd)
    v = qkv[..., 2 * D:].reshape(B, L, H, hd)
    neg = jnp.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    att = jax.nn.softmax(att + neg, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)


@pytest.mark.parametrize("B,L,H,hd,padded", [
    (1, 512, 2, 64, 0), (2, 77, 2, 64, 1), (3, 64, 2, 32, 1),
    (2, 16, 2, 32, 1)])
def test_three_pass_attention_matches_jax(B, L, H, hd, padded):
    qkv, mask = _case(B, L, H, hd, padded, 2000 + L)
    want = np.asarray(_jax_attention(qkv.numpy(), mask.numpy(), np.zeros(H)))
    got = attention_tf32(qkv, mask, H).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("L,hd", [(512, 64), (77, 32), (16, 32), (1, 64)])
def test_all_masked_row_gets_mean_of_v(L, hd):
    """Every key of the last batch row masked: -1e9 rounds every score to
    one f32, each key weighs 1, and 1 is exact in tf32."""
    H = 2
    qkv, mask = _case(2, L, H, hd, 1, 3000 + L)
    got = attention_tf32(qkv, mask, H)
    D = H * hd
    v_mean = qkv[-1, :, 2 * D:].double().mean(dim=0)
    torch.testing.assert_close(got[-1].double(),
                               v_mean.expand(L, D), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    # a batch row with keys left takes no mean (at L > 1)
    v0_mean = qkv[0, :, 2 * D:].double().mean(dim=0)
    assert L == 1 or not torch.allclose(got[0].double(), v0_mean.expand(L, D),
                                        atol=1e-3)


def test_emulation_walks_the_kernels_key_tiles():
    """At hd 64 the kernel's key tile is 32, at hd 32 it is 64: the online
    softmax across tiles changes nothing beyond rounding."""
    qkv, mask = _case(1, 512, 2, 64, 0, 7)
    assert at.tiles_for(1, 2, 512, 64).key_tile == 32
    assert at.tiles_for(1, 2, 512, 32).key_tile == 64
    ref = attention_reference(qkv, mask, 2)
    torch.testing.assert_close(attention_tf32(qkv, mask, 2).double(), ref,
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def _rn32(v):
    """An exact rational rounded to the nearest f32, ties to even."""
    from fractions import Fraction

    if v == 0:
        return np.float32(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(a, quantum)
    n = int(n)
    if rem / quantum > Fraction(1, 2) or (rem / quantum == Fraction(1, 2)
                                          and n % 2):
        n += 1
    return np.float32(float(n * quantum) * (1 if v > 0 else -1))


def _div_rn(x, d, r):
    """The kernel's div_rn in exact arithmetic: q = RN(x r), then two FMA
    corrections q = RN(q + RN(x - q d) r)."""
    from fractions import Fraction

    F = Fraction
    q = _rn32(F(float(x)) * F(float(r)))
    for _ in range(2):
        e = _rn32(F(float(x)) - F(float(q)) * F(float(d)))
        q = _rn32(F(float(e)) * F(float(r)) + F(float(q)))
    return q


@pytest.mark.parametrize("hd", [32, 64])
def test_kernel_division_is_the_ieee_quotient(hd):
    """The kernel divides each score by f32(sqrt(hd)) as correctly rounded
    f32 (numpy's f32 division): at hd 32 by div_rn from RN(1 / d), at hd 64
    by a product with 0.125. Scores of every magnitude of the normal
    range, products of d (exact quotients) and their neighbours."""
    rng = np.random.default_rng(hd)
    d = np.float32(np.sqrt(hd))
    r = np.float32(1) / d
    x = (rng.normal(size=1500) * 10.0 ** rng.uniform(-30, 30, 1500)
         ).astype(np.float32)
    exact = (np.arange(1, 200, dtype=np.float32) * d).astype(np.float32)
    x = np.concatenate([x, exact, np.nextafter(exact, np.float32(0)),
                        np.nextafter(exact, np.float32(np.inf)),
                        -exact[:50], np.float32([0.0, 1.0, -1.0])])
    want = (x / d).astype(np.float32)
    if hd == 64:
        assert d == 8 and r == 0.125
        np.testing.assert_array_equal(x * r, want)
    else:
        got = np.array([_div_rn(v, d, r) for v in x], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
