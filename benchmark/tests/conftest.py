"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need the card carry the ``cuda`` marker and skip without one;
whether there is a card is decided inside the test, never at import."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")
    torch.set_num_threads(1)  # the workers share the host's cores


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100 only")
    return torch.device("cuda")
