"""The benchmark's own tests: run them from the root of the repo with

    python -m pytest benchmark/tests -q -n 0

Tests marked ``card`` need an NVIDIA GPU and skip without one; on the card
they run with the same command."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
