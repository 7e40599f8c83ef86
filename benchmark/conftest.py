"""pytest settings of the benchmark's own tests (`benchmark/tests/`).

Tests that need an NVIDIA card carry the `card` marker and the `card`
fixture, which skips them where `torch.cuda.is_available()` is false. The
decision is taken inside the fixture, when the test runs, never at import.
Run them on the card with `python3 -m pytest benchmark/tests -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
