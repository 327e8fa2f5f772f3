"""Test configuration of the benchmark's own tests (``benchmark/tests``).

    python -m pytest -p no:cacheprovider benchmark/tests -q

Tests that need a CUDA card carry the ``cuda`` marker and take the ``cuda``
fixture, which skips them where ``torch.cuda.is_available()`` is false; the
rest run on the CPU at tiny sizes.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
