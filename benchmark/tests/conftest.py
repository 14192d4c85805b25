"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.

Tests that need a CUDA card carry the `card` marker and skip without
one; whether there is a card is decided inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    """Several test processes side by side: one intra-op thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
