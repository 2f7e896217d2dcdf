"""Shared set-up of the benchmark's own tests (CPU; those marked `cuda`
skip without a card): the import paths run.py sets, a Spec whose
traffic is cut to a size the CPU runs in seconds, and ultra-long read
lengths for a traffic mix."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from nbench import gen_snp, harness  # noqa: E402


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


@pytest.fixture
def ul_reads():
    """A function that turns a traffic mix into ultra-long ONT reads at
    48x: in place of `read_len_bp`, log-normal lengths with N50 100 kb,
    the longest 1 Mb (Jain et al., Nat. Biotechnol. 36:338, 2018)."""

    def ul(t):
        t = dict(t, read_len_dist={"kind": "lognormal", "n50_bp": 100000,
                                   "sigma": 0.8, "max_bp": 1000000})
        del t["read_len_bp"]
        t["reads_per_mb"] = 48e6 / gen_snp.mean_read_len(t)
        return t

    return ul
