"""The benchmark's own tests: ``python -m pytest benchmark/``. A test that
needs an NVIDIA card takes the ``card`` fixture, which skips it without
one; whether there is a card is decided there, when the test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
