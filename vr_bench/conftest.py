"""pytest settings of the benchmark's own tests (``python -m pytest
vr_bench``): the ``card`` marker for tests that need a CUDA card. Whether
there is one is decided inside the ``card`` fixture, never at import."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)
