"""The benchmark's own tests: ``python -m pytest gpcbench`` from the root
of the repository.  Tests that need a card carry the ``card`` marker and
take the ``card`` fixture, which skips them where there is none; it
decides when the test runs, never when the module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch
    torch.set_num_threads(2)
