"""CPU tests of the benchmark; tests marked ``card`` need a CUDA device.

Run: ``python -m pytest port_bench/tests -q`` (here, on the CPU: the
``card`` tests skip); on the card the same command runs them too.
Whether there is a card is decided inside the ``card`` fixture, never
while a module is imported.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny():
    """``tiny(name)``: the manifest's cell ``name`` at 54 x 96 with 2
    warm-up frames and 2 synced and 2 profiled frames, for CPU runs."""
    from port_bench import manifest

    def make(name):
        cell = manifest.resolve(name)
        cell.traffic.update(width=96, height=54, warmup_frames=2,
                            trace={"synced_frames": 2, "profiled_frames": 2})
        return cell
    return make
