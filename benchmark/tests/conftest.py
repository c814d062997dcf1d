"""Tests of the benchmark itself. Run with ``python3 -m pytest
benchmark/tests``: on the CPU the harness's drivers run the port at
tiny sizes; the tests marked ``chip`` need a CUDA device and skip
without one (the decision is made inside the ``chip`` fixture)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")
