"""pytest settings of the benchmark's own tests (`python -m pytest
portbench/tests`): the `card` marker for tests that need a CUDA card, and
the fixture that skips them without one (decided when the test runs, never
at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
