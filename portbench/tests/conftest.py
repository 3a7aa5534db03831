"""The benchmark's own tests: ``python3 -m pytest portbench/tests -q``.
Tests marked ``gpu`` run at the cells' full sizes and need a CUDA card:
``python3 -m pytest portbench/tests -m gpu -q`` on the chip; elsewhere they
skip inside the ``cuda`` fixture."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (the cells' full sizes)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
