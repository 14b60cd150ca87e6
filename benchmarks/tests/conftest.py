"""The benchmark's own tests: `python -m pytest benchmarks/tests -q`.

Tests that need an NVIDIA card carry the `cuda` marker and take the
`cuda_device` fixture, which decides whether there is a card when a test
runs (never while a module is imported) and skips without one.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the kernels have no CPU form); skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs the kernels")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """CPU tests step small models: torch at 2 threads beside other workers."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
