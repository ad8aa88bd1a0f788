"""Tests of the port's benchmark.  They import neither JAX nor the JAX
package.  ``card``: a test that needs a CUDA card; it skips without one
(decided in the ``card`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the benchmark's tests on the chip)")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def two_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
