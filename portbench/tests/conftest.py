"""Tests of the benchmark (portbench/). They run on the CPU at the micro
zoo's size; a test that needs the card is marked `card` and skips itself,
deciding inside the test. Run them with

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips itself without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")
