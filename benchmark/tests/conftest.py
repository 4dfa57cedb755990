"""Tests of the benchmark harness.  Those that need an NVIDIA card carry the
``card`` marker and skip elsewhere; whether there is a card is decided in
the ``cuda`` fixture, never while a module is imported.  On a card:

    python -m pytest benchmark/tests -m card -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
