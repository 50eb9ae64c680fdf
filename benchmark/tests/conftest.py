"""Tests of the benchmark harness (benchmark/). They run on the CPU; those
marked `card` need a CUDA card and skip without one (decided in the
`card` fixture, never at import).

    python3 -m pytest benchmark/tests -q          # on the CPU
    python3 -m pytest benchmark/tests -q -m card  # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # the port's CPU encodes run small torch operations; one thread per
    # test process keeps several pytest-xdist workers from starving each
    # other (the benchmark's runs use one thread too)
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.cuda.get_device_name(0)
