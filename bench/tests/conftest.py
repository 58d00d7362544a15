"""Fixtures of the benchmark's tests.  A test that needs the card takes
``cuda_card`` and skips where there is none; nothing is decided at
import."""
from __future__ import annotations

import pytest


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
