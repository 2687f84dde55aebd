"""CPU tests of the benchmark: `python -m pytest port_bench/tests -q`.

Tests marked `cuda` run a cell on a card and skip without one."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _float32_without_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
