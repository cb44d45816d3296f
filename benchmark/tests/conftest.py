"""Fixtures of the benchmark's tests (helpers in tiny.py)."""

from __future__ import annotations

import pytest
import torch

from tiny import make_tiny_bench


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path / "bench")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: "
                    "python -m pytest -m cuda benchmark/tests")
    return torch.device("cuda", 0)
