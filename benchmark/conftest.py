"""pytest settings for the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker for tests that need a CUDA card,
which skip here with a reason, decided inside the ``card`` fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one; run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own sizes run only there")
    return torch.device("cuda")
