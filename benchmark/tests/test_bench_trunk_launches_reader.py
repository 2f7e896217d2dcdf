"""The reader of kernel K6's launches (snp.trunk_launches_per_group) on a
filled counter registry: the ratio, and None where the run has nothing
to read, the port counting no K6 launch (the CPU, or an older port)
included."""

import pytest

from nanocaller_tpu_torch.runtime import metrics
from nbench import harness

NAME = "snp.trunk_launches_per_group"


def _ctx(kind="snp_stream", traced=True):
    trace = {"spans": {}, "window_s": 1.0, "busy_s": 0.5} if traced \
        else None
    return {"traffic": {"kind": kind}, "trace": trace,
            "traced": {"sent": [0, 1], "units": 2} if traced else None}


@pytest.fixture
def registry():
    saved = metrics.counters()
    metrics.reset_counters()
    yield
    metrics.reset_counters()
    for name, n in saved.items():
        metrics.count(name, n)


@pytest.mark.parametrize("groups,launches,want", [(8, 64, 8.0),
                                                  (1700, 13601, 8.0005882)])
def test_reader_ratio(registry, groups, launches, want):
    metrics.count("snp.groups", groups)
    metrics.count("k6.launches", launches)
    assert harness.Spec().reader(NAME)(_ctx()) == pytest.approx(
        want, rel=1e-7)


def test_reader_has_nothing_to_read(registry):
    read = harness.Spec().reader(NAME)
    # a port that has no K6
    metrics.count("snp.groups", 8)
    metrics.count("snp.cnn_graph_replays", 56)
    assert read(_ctx()) is None
    metrics.count("k6.launches", 64)
    assert read(_ctx(kind="other")) is None
    assert read(_ctx(traced=False)) is None
