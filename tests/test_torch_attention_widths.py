"""Head widths the attention kernels do not take, on the CPU.

`ops/attention.py` routes a head width by shape before any launch
(`route`): a kernel width (16, 32, 64, 128) launches as it is, a width
under 128 is zero-padded to the next kernel width and launched with the
true width's divisor, and a width above 128 is refused on the card
(ValueError before any launch) while a CPU tensor runs the plain
version at any width. Here:

- padding, the plain version at the padded width with the true divisor,
  and slicing give the plain version at the true width (forward and
  backward, hd 8, 48 and 96, within 1e-6), and the padded columns of the
  gradient are zero;
- the wrappers, with the device taken for CUDA, hand the launchers the
  padded tensors and the true divisor (the launchers replaced by the
  plain arithmetic they run), and at hd 160 raise before reaching a
  launcher; CPU tensors at hd 160 run the plain version, counted.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.ops import attention as at

WIDTHS = [8, 48, 96]


def _inputs(hd, seed, H=3, B=4, L=24):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, L, 3 * H * hd)
                                      ).astype(np.float32))
    dctx = torch.from_numpy(rng.normal(size=(B, L, H * hd)).astype(np.float32))
    lens = rng.integers(1, L + 1, B)
    lens[-1] = 0  # a padding row of a power-of-two batch
    mask = torch.from_numpy((np.arange(L)[None, :] < lens[:, None]
                             ).astype(np.int32))
    return qkv, mask, dctx, H


def test_routes_and_padded_widths():
    assert {hd: at.route(hd) for hd in (1, 8, 16, 24, 32, 48, 64, 96, 128,
                                        129, 160, 256)} == {
        1: "padded", 8: "padded", 16: "kernel", 24: "padded", 32: "kernel",
        48: "padded", 64: "kernel", 96: "padded", 128: "kernel",
        129: "refused", 160: "refused", 256: "refused"}
    assert [at.padded_width(hd) for hd in (8, 17, 48, 96, 128, 160)] == [
        16, 32, 64, 128, 128, None]


@pytest.mark.parametrize("hd", WIDTHS)
def test_pad_then_plain_equals_plain_at_the_true_width(hd):
    qkv, mask, _, H = _inputs(hd, seed=hd)
    w = at.padded_width(hd)
    padded = at.pad_heads(qkv, H, hd, w)
    assert padded.shape == (*qkv.shape[:2], 3 * H * w)
    assert padded.is_contiguous()
    torch.testing.assert_close(at.unpad_heads(padded, H, hd, w), qkv,
                               rtol=0, atol=0)
    got = at.unpad_heads(at.encoder_attention_plain(padded, mask, H,
                                                    div_hd=hd), H, hd, w)
    want = at.encoder_attention_plain(qkv, mask, H)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the padded width's own divisor would give another attention
    other = at.unpad_heads(at.encoder_attention_plain(padded, mask, H), H,
                           hd, w)
    assert (other - want).abs().max() > 1e-3


@pytest.mark.parametrize("hd", WIDTHS)
def test_pad_then_plain_backward_equals_plain_at_the_true_width(hd):
    qkv, mask, dctx, H = _inputs(hd, seed=100 + hd)
    w = at.padded_width(hd)
    full = at.encoder_attention_backward_plain(
        at.pad_heads(qkv, H, hd, w), mask, at.pad_heads(dctx, H, hd, w), H,
        div_hd=hd)
    cols = full.reshape(*full.shape[:2], 3, H, w)
    assert cols[..., hd:].abs().max() == 0  # padded dQ, dK, dV columns
    got = at.unpad_heads(full, H, hd, w)
    want = at.encoder_attention_backward_plain(qkv, mask, dctx, H)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _as_if_on_the_card(monkeypatch):
    """The wrappers see a CUDA device; the launchers run the arithmetic
    the kernels run (the plain version at the width and divisor given)
    and record their calls."""
    calls = []

    def launch(qkv, mask, n_heads, mode=0, div_hd=None):
        B, L, D, hd = at.check_shapes(qkv, mask, n_heads)
        calls.append(("forward", hd, div_hd))
        return at.encoder_attention_plain(qkv, mask, n_heads, div_hd=div_hd)

    def launch_backward(qkv, mask, dctx, n_heads, div_hd=None, **kw):
        B, L, D, hd = at.check_shapes(qkv, mask, n_heads)
        calls.append(("backward", hd, div_hd))
        return (at.encoder_attention_backward_plain(
            qkv, mask, dctx, n_heads, div_hd=div_hd), None)

    monkeypatch.setattr(at, "_device_of", lambda ts: torch.device("cuda"))
    monkeypatch.setattr(at, "launch", launch)
    monkeypatch.setattr(at, "launch_backward", launch_backward)
    return calls


@pytest.mark.parametrize("hd", WIDTHS)
def test_wrappers_launch_padded_heads_with_the_true_divisor(hd, monkeypatch):
    qkv, mask, dctx, H = _inputs(hd, seed=200 + hd)
    want = at.encoder_attention_plain(qkv, mask, H)
    want_d = at.encoder_attention_backward_plain(qkv, mask, dctx, H)
    calls = _as_if_on_the_card(monkeypatch)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    torch.testing.assert_close(at.encoder_attention(qkv, mask, H), want,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(at.encoder_attention_backward(qkv, mask, dctx,
                                                             H),
                               want_d, rtol=0, atol=1e-6)
    w = at.padded_width(hd)
    assert calls == [("forward", w, hd), ("backward", w, hd)]
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain


def test_kernel_widths_launch_as_before(monkeypatch):
    qkv, mask, dctx, H = _inputs(32, seed=7)
    calls = _as_if_on_the_card(monkeypatch)
    at.encoder_attention(qkv, mask, H)
    at.encoder_attention_backward(qkv, mask, dctx, H)
    assert calls == [("forward", 32, None), ("backward", 32, None)]


def test_widths_above_128_are_refused_on_the_card_before_any_launch(
        monkeypatch):
    qkv, mask, dctx, H = _inputs(160, seed=160, H=2, L=8)
    calls = _as_if_on_the_card(monkeypatch)
    before = dict(at.LAUNCHES)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    with pytest.raises(ValueError, match="head width 160"):
        at.encoder_attention(qkv, mask, H)
    with pytest.raises(ValueError, match="head width 160"):
        at.encoder_attention_backward(qkv, mask, dctx, H)
    assert calls == [] and at.LAUNCHES == before
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain


def test_widths_above_128_run_the_plain_version_on_cpu_tensors():
    qkv, mask, dctx, H = _inputs(160, seed=161, H=2, L=8)
    before = dict(at.LAUNCHES)
    plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    got = at.encoder_attention(qkv, mask, H)
    got_d = at.encoder_attention_backward(qkv, mask, dctx, H)
    assert at.LAUNCHES == before
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain + 1
    torch.testing.assert_close(got, at.encoder_attention_plain(qkv, mask, H),
                               rtol=0, atol=0)
    torch.testing.assert_close(got_d, at.encoder_attention_backward_plain(
        qkv, mask, dctx, H), rtol=0, atol=0)


def test_autograd_function_takes_the_routes(monkeypatch):
    """EncoderAttention (BertEncoder's attention) reaches the padded
    launches forward and backward."""
    qkv, mask, dctx, H = _inputs(48, seed=48)
    calls = _as_if_on_the_card(monkeypatch)
    x = qkv.clone().requires_grad_(True)
    out = at.EncoderAttention.apply(x, mask, H)
    out.backward(dctx)
    assert calls == [("forward", 64, 48), ("backward", 64, 48)]
    torch.testing.assert_close(x.grad, at.encoder_attention_backward_plain(
        qkv, mask, dctx, H), rtol=0, atol=1e-6)
