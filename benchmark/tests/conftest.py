"""Shared set-up of the benchmark's own tests (CPU; those marked `cuda`
skip without a card): the import paths run.py sets, and a Spec whose
traffic is cut to a size the CPU runs in seconds."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from nbench import harness  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips itself without one")


class TinySpec(harness.Spec):
    """BENCHMARK.json as committed, with each traffic mix cut to two small
    groups (the same statistics)."""

    def traffic(self, name):
        t = super().traffic(name)
        t.update(groups=2, members_per_group=2, member_bp=40000,
                 halo_bp=10000, read_len_bp=8000)
        return t


@pytest.fixture
def tiny_spec():
    return TinySpec()


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"
