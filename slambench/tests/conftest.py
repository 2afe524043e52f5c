"""Tests of the benchmark harness. Run from the root of the repository:

    python -m pytest slambench/tests -q

They import neither JAX nor the JAX package. A test marked `gpu` needs a
CUDA card and skips without one; whether there is one is decided inside
the `cuda` fixture, never while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")
