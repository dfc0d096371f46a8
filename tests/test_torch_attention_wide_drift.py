"""The wide backward kernels' sums over the head, on the CPU: S and dP
summed a column chunk at a time from 0 (the kernels) against one chain
over the whole head on the tensor core, under
`benches/train_bench.wide_backward_tf32`'s truncation model, held to the
f64 reference within `train_bench.BWD_TOL` (5e-5, the card's gate). A file
of its own, so that the test runner spreads it apart from
`test_torch_attention_wide_split.py`; the chunked results are the ones
that file's tests compute (`tests/torch_attention_cases.py` caches them).
"""

import pytest
import torch

from oramacore_tpu_torch.benches import train_bench as tb
from tests.torch_attention_cases import wide_backward, wide_reference


@pytest.mark.parametrize("hd", [256, 320])
def test_wide_backward_chunked_sums_over_the_head_drift_less(hd):
    """S and dP summed a column chunk at a time from 0 (the kernels)
    against one chain over the whole head on the tensor core: under the
    emulator's truncation model both stay within the gate here, and the
    whole-head chains are off by more than twice as much (the card
    truncates harder than the model: see `backward_tf32`)."""
    ref = wide_reference(hd, 65, 300 + hd + 65)
    errs = {}
    for chunked in (True, False):
        got = wide_backward(hd, 65, 300 + hd + 65, chunked=chunked)
        torch.testing.assert_close(got.double(), ref, rtol=tb.BWD_TOL,
                                   atol=tb.BWD_TOL)
        errs[chunked] = float((got.double() - ref).abs().max())
    assert errs[False] > 2 * errs[True], errs
