"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need a CUDA card (they skip without one).

Run from the root of the checkout:  python -m pytest benchmark/tests -q
On a machine with a card, the card tests alone:
    python -m pytest benchmark/tests -q -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a machine without")


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
