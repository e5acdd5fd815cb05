"""The benchmark's tests. Those marked ``card`` need a CUDA card; the
``card`` fixture decides at run time, inside the test, and skips here."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda:0")
