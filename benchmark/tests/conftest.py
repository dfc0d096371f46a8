"""Tests of the benchmark itself. Most run on the CPU at small sizes; the
ones that need the card carry the `card` marker and skip without one,
deciding inside the `cuda` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips on a host without CUDA)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
