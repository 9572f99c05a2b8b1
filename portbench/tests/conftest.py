"""Fixtures of the benchmark's own tests:
``python -m pytest portbench/tests`` (``-m gpu`` on a card)."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)
