"""The per-layer readers of the port's own spans and counters
(nbench/program.py) on a synthetic trace summary and a filled counter
registry: each number, and None where the run has nothing to read."""

import pytest

from nanocaller_tpu_torch.runtime import metrics
from nbench import harness

SPANS = {"snp.cohorts": 0.012, "snp.wire": 0.02, "snp.copy_in": 0.004,
         "snp.launch": 0.008, "snp.copy_out": 0.06}
COUNTS = {"snp.groups": 8, "snp.h2d_bytes": 8 * 3_400_000,
          "snp.blocking_copies": 8 * 24}
# four groups sent in the traced window
WANT = {"snp.cohorts_ms_per_group": 3.0, "snp.wire_ms_per_group": 5.0,
        "snp.copy_in_ms_per_group": 1.0, "snp.launch_ms_per_group": 2.0,
        "snp.copy_out_ms_per_group": 15.0, "snp.h2d_mb_per_group": 3.4,
        "snp.blocking_copies_per_group": 24.0}


def _ctx(kind="snp_stream", spans=SPANS, traced=True):
    trace = {"spans": {k: [4, v] for k, v in spans.items()},
             "window_s": 1.0, "busy_s": 0.5} if traced else None
    return {"traffic": {"kind": kind}, "trace": trace,
            "traced": {"sent": [0, 1, 2, 0], "units": 4} if traced
            else None}


@pytest.fixture
def registry():
    saved = metrics.counters()
    metrics.reset_counters()
    for name, n in COUNTS.items():
        metrics.count(name, n)
    yield
    metrics.reset_counters()
    for name, n in saved.items():
        metrics.count(name, n)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_numbers(registry, name):
    got = harness.Spec().reader(name)(_ctx())
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_has_nothing_to_read(registry, name):
    read = harness.Spec().reader(name)
    assert read(_ctx(kind="other")) is None
    assert read(_ctx(traced=False)) is None
    if name.endswith("_ms_per_group"):
        # a port that records no such span (an older one)
        assert read(_ctx(spans={})) is None
    else:
        metrics.reset_counters()  # a port that counts nothing
        assert read(_ctx()) is None
