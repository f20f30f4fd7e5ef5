"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need an NVIDIA GPU; the ``card`` fixture decides
when the test runs, never at import, and skips elsewhere."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    """Small CPU runs on few threads, as under several test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)
