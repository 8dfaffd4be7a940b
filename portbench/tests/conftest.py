"""The benchmark's own tests: `python -m pytest portbench/tests -q -p no:cacheprovider`.

Tests that need the card carry the `card` marker, registered here, and
skip without one: the `card` fixture decides, when the test runs."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
