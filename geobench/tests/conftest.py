"""The benchmark's own tests: ``python -m pytest geobench/tests -q`` from
the root of a checkout (the repository's tier-1 run collects ``tests/``
only).  Tests marked ``gpu`` need a CUDA device; each decides inside the
``cuda`` fixture, never while its module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips where there is none)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
