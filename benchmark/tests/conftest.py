"""Tests of the benchmark (benchmark/), run on the CPU:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA card and skip, inside the ``cuda``
fixture, where torch sees none; on the card:

    python -m pytest benchmark/tests -q -m card
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where torch sees none)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch, tmp_path):
    """One torch thread (the plain kernels' many small ops spin every
    core otherwise) and a HOME of the test's own for the index cache."""
    import torch
    torch.set_num_threads(1)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
