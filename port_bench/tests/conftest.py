"""Fixtures of the benchmark's own tests. Whether there is a card is
decided inside a fixture, never while a module is imported."""

import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs at the cell's own size on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    from port_bench.tests import tiny

    tiny.make(tmp_path)
    return tmp_path
