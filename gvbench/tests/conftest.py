"""Tests of the benchmark. Those marked ``card`` need a CUDA card: each
decides inside itself, through the ``card`` fixture, and skips without
one. On the card: python3 -m pytest gvbench/tests -m card -q"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
