"""The benchmark's CPU tests: `python3 -m pytest benchmark/tests -q` from
the repository root. Tests marked `chip` need a CUDA card: they decide in
the `card` fixture and skip without one (on the card:
`python3 -m pytest benchmark/tests -q -m chip`)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the card's kernels exist "
                    "only there")
    return torch.device("cuda")
