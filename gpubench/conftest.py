"""pytest settings of the benchmark's own tests (`gpubench/tests/`, run with
`python -m pytest gpubench/tests`). Tests that need a CUDA card carry the
`card` marker and take the `card` fixture, which skips them where torch
sees no card; the decision is made when the test runs, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return "cuda"
