"""The benchmark's tests: run from the checkout's root with
``python -m pytest portbench/tests -q``. Tests marked ``cuda`` run a cell
on the card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs on the card")
    return torch.cuda.get_device_name(0)
