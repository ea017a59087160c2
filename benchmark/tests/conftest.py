"""The benchmark's own tests (CPU, and a few marked `gpu` for the card).

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu     # on a CUDA card
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a frame size that a CPU test run holds
SMALL = {"width": 64, "height": 48}


@pytest.fixture
def cuda():
    """The card, or a skip where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
