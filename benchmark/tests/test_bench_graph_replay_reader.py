"""The reader of the SNP CNN's graph replays
(snp.cnn_graph_replays_per_group) on a filled counter registry: the
ratio, and None where the run has nothing to read, the port counting
no replays (the CPU, or an older port) included."""

import pytest

from nanocaller_tpu_torch.runtime import metrics
from nbench import harness

NAME = "snp.cnn_graph_replays_per_group"


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


@pytest.mark.parametrize("groups,replays,want", [(8, 56, 7.0),
                                                 (6, 9, 1.5)])
def test_reader_ratio(registry, groups, replays, want):
    metrics.count("snp.groups", groups)
    metrics.count("snp.cnn_graph_replays", replays)
    assert harness.Spec().reader(NAME)(_ctx()) == pytest.approx(
        want, rel=1e-12)


def test_reader_has_nothing_to_read(registry):
    read = harness.Spec().reader(NAME)
    # a port that replays no graph
    metrics.count("snp.groups", 8)
    metrics.count("snp.async_copy_backs", 8)
    assert read(_ctx()) is None
    metrics.count("snp.cnn_graph_replays", 56)
    assert read(_ctx(kind="other")) is None
    assert read(_ctx(traced=False)) is None
