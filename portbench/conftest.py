"""pytest settings of the benchmark's tests (``portbench/tests``).

The ``card`` marker names a test that needs a CUDA card; such a test takes
the ``card`` fixture, which decides whether a card is there when the test
runs, never while a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "`python -m pytest portbench/tests -m card`")
    return torch.device("cuda", 0)
