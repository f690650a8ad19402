"""pytest settings of the benchmark's own tests (`pytest lte_bench/tests`):
the `card` marker for tests that need a CUDA device, and the fixture that
finds one or skips."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip with `pytest lte_bench/tests -m card`")
    return torch.device("cuda", 0)
