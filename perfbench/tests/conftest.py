"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``
from the repository's root (CPU, a few minutes).  Tests marked ``chip``
need the CUDA card and skip without one; on a machine with the card:
``python3 -m pytest perfbench/tests -q -m chip``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")
