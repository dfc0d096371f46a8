"""The narrow backward kernels' sums over the queries at L = 512, on the
CPU: dK and dV summed per 8-query step from 0 and added rounded (the
kernels) against the first design's running sums on the tensor core,
under `benches/train_bench.backward_tf32`'s truncation model, held to the
f64 reference within `train_bench.BWD_TOL` (5e-5, the card's gate). A file
of its own, so that the test runner spreads it apart from
`test_torch_attention_grad_split.py`.
"""

import pytest
import torch

from oramacore_tpu_torch.benches import train_bench as tb


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
