"""Tests of the port's benchmark. CPU tests run the harness on the port's CPU
path at small sizes; tests marked ``cuda`` need a card and skip without one
(run them on the card with ``python3 -m pytest port_bench/tests -m cuda``).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port on its CPU path."""
    monkeypatch.setenv("IPT_DEVICE", "cpu")


