"""CPU tests of the port's benchmark (``python -m pytest portbench/tests``).

They import the harness from ``portbench/`` and the port from the repo
root; the repo's ``tests/`` suite does not collect them. Tests that need
the card carry the ``gpu`` marker and decide inside a fixture.
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
