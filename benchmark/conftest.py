"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Run them from the repository root: ``python -m pytest benchmark/tests -q``.
They need no card, nvcc or triton; the tests marked ``card`` need a CUDA
card and skip without one (the check is made inside a fixture, never while
a module is imported).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device of a test marked ``card``; skips without a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
