"""The SNP CNN's slices on the CPU (snp_caller.cnn_in_slices, _snp_cnn):
rows split into full slices of the batch size and a shorter tail, each
slice's probabilities placed in its own rows, equal bit for bit to the
loop that concatenates each slice's forward. A runner standing in for a
CUDA graph's replay takes exactly the full slices; on the CPU _snp_cnn
runs every slice eagerly and captures no graph."""

import pytest
import torch

from nanocaller_tpu_torch import snp_caller as P
from nanocaller_tpu_torch.runtime import metrics

from torch_threads import _torch_threads  # noqa: F401 (autouse)

BS = 4096
# the benchmark's decode group is 7 full slices and a tail of 2,704 rows
ROWS = [0, 1, BS - 1, BS, BS + 1, 7 * BS + 2704]


@pytest.fixture(scope="module")
def state():
    return P.SnpCallerState.create("ONT-HG002", device="cpu")


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(25)
    n = max(ROWS)
    x = torch.rand((n, 5, 41, 5), generator=g) * 2 - 1
    ref = torch.nn.functional.one_hot(
        torch.randint(0, 4, (n,), generator=g), 4).float()
    return x, ref


def _forward(state, ploidy):
    _dev, model, hap_model = state.replicas[0]
    if ploidy == "haploid":
        return hap_model
    return lambda xs, rs: model(xs, rs)[0][:, :, 1]


def _loop(forward, x, ref, bs):
    """The slices' forwards concatenated, as _snp_cnn ran them before
    they were placed into one tensor."""
    probs = [forward(x[lo:lo + bs], ref[lo:lo + bs])
             for lo in range(0, x.shape[0], bs)]
    return torch.cat(probs) if probs else torch.zeros((0, 4))


def _case(inputs, n):
    x, ref = inputs
    return x[:n], ref[:n]


@pytest.mark.parametrize("n", ROWS)
def test_slices_match_the_loop(state, inputs, n):
    """The CPU route (every slice eager) and a stand-in for the graph's
    replay on the full slices both give the loop's probabilities."""
    x, ref = _case(inputs, n)
    forward = _forward(state, "diploid")
    calls = []

    def full(xs, rs, dst):
        assert len(xs) == len(rs) == len(dst) == BS
        calls.append(xs.data_ptr())
        dst.copy_(forward(xs, rs))

    with torch.inference_mode():
        want = _loop(forward, x, ref, BS)
        got = P._snp_cnn(state.replicas[0], "diploid", x, ref, BS)
        placed = P.cnn_in_slices(x, ref, BS, forward, full)
    for t in (got, placed):
        assert t.shape == (n, 4) and t.dtype == torch.float32
        assert torch.equal(t, want)
    assert calls == [x[lo:].data_ptr() for lo in range(0, n - BS + 1, BS)]


@pytest.mark.parametrize("n", [BS - 1, BS + 1])
def test_haploid_slices_match_the_loop(state, inputs, n):
    x, ref = _case(inputs, n)
    with torch.inference_mode():
        want = _loop(_forward(state, "haploid"), x, ref, BS)
        got = P._snp_cnn(state.replicas[0], "haploid", x, ref, BS)
    assert torch.equal(got, want)


def test_cpu_captures_no_graph(state, inputs):
    """Full slices at both ploidies on the CPU: no graph, no replay."""
    x, ref = _case(inputs, 2 * 64 + 5)
    metrics.reset_counters("snp.cnn_graph_replays")
    with torch.inference_mode():
        for ploidy in ("diploid", "haploid"):
            P._snp_cnn(state.replicas[0], ploidy, x, ref, 64)
    assert all(rep.graphs == {} and rep.pool is None
               for rep in state.replicas)
    assert metrics.counters("snp.cnn_graph_replays") == {}


def test_replicas_carry_their_graphs():
    """A state's replicas unpack as sharding.replicas gives them, and
    each holds graphs of its own."""
    state = P.SnpCallerState.create("ONT-HG002", device="cpu",
                                    devices=["cpu", "cpu"])
    a, b = state.replicas
    assert isinstance(a, P.SnpReplica) and len(a) == 3
    dev, model, hap_model = a
    assert dev == state.device and model is state.model \
        and hap_model is state.hap_model
    assert a.graphs is not b.graphs
