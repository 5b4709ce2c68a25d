"""The benchmark's tests: CPU tests at small sizes; the `cuda` ones run
only where a card is visible (python3 -m pytest benchmark/tests -m cuda
on the chip machine)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")
