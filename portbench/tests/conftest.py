"""Tests of the benchmark harness (``python -m pytest portbench/tests``).

The harness and the reference import from portbench/ and the port from
the repository root. Tests that need a CUDA card carry the ``gpu`` marker
and decide on the card inside the ``card`` fixture."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
for p in (str(REPO), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch

    torch.set_num_threads(2)
