"""The port's spans and counters (runtime/metrics.py) on the CPU: a span
is a shared null context with no profiler running; under torch.profiler
the SNP group path records its five spans, tagged with the group's
number, and the stage timers theirs; the group path counts its copies
to the device as the code makes them."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nanocaller_tpu_torch import snp_caller as P
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.pileup import snp_pileup as K3
from nanocaller_tpu_torch.pileup.snp_features import get_snp_group_payloads
from nanocaller_tpu_torch.runtime import metrics
from nanocaller_tpu_torch.sim import (BASES, make_fixture, random_group_wire,
                                      random_seq)

from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 40_000
MEMBERS = [{"chrom": "chr_t", "start": 1 + i * 20000, "end": (i + 1) * 20000,
            "ploidy": "diploid"} for i in range(2)]
# (seq_type, maxcov): every row normal; maxcov under the fixture's depth,
# so that both members carry deep rows too
GROUPS = {"normal": ("ont", 160), "deep": ("ul_ont", 24)}
SPANS = ("snp.cohorts", "snp.wire", "snp.copy_in", "snp.launch",
         "snp.copy_out")
# the wire's fields (PileupWire), each one copy to the device
WIRE_FIELDS = 18


class Cfg:
    batch_size = 128
    disable_coverage_normalization = False


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tracing")
    ref = random_seq(np.random.default_rng(13), L)  # make_fixture's ref
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(700, L - 700, 650))]
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=13, L=L, depth=30,
                                        read_len=2000, snps=snps,
                                        error_rate=0.01)
    out = {}
    for name, (seq_type, maxcov) in GROUPS.items():
        [gf] = get_snp_group_payloads(BamReader(bam_p), FastaFile(fasta_p),
                                      MEMBERS, seq_type=seq_type,
                                      maxcov=maxcov)
        gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
        out[name] = gf
    deep = [len(sec.deep_idx) for _i, sec in out["deep"].members]
    assert min(deep) > 0 and not any(
        len(sec.deep_idx) for _i, sec in out["normal"].members)
    return out


@pytest.fixture(scope="module")
def state():
    return P.SnpCallerState.create("ONT-HG002", device="cpu")


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_span_is_the_null_context_without_a_profiler(monkeypatch):
    """No profiler: the shared null context, and nothing of the
    profiler's record functions is called."""
    def boom(*_a, **_k):
        raise AssertionError("a record function was opened")

    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    assert metrics.span("snp.cohorts", 3) is metrics.span("x")
    with metrics.span("snp.wire", 3), metrics.Metrics().timer("stage"):
        pass


def test_group_spans_in_the_trace(groups, state, tmp_path):
    """infer_snp_group under the profiler: the five spans, each tagged
    with the group's number (its snp.groups count), snp.copy_out inside
    the finisher's call."""
    gf = groups["deep"]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fin = P.infer_snp_group(state, gf, Cfg(), async_mode=True)
        g = metrics.counters()["snp.groups"]
        with metrics.span("test.finish"):
            fin()
    events = _events(prof, tmp_path)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for name in SPANS:
        assert name in by_name, name
        for e in by_name[name]:
            assert e["args"].get("Concrete Inputs") == [str(g)], (name, e)
    [fin_ev] = by_name["test.finish"]
    a, b = fin_ev["ts"], fin_ev["ts"] + fin_ev["dur"]
    cohorts = 2  # the normal and the deep cohort
    assert len(by_name["snp.copy_out"]) == cohorts
    for e in by_name["snp.copy_out"]:
        assert a <= e["ts"] and e["ts"] + e["dur"] <= b
    # the enqueue's spans follow one another, each before the finisher
    [coh] = by_name["snp.cohorts"]
    for name in ("snp.wire", "snp.copy_in", "snp.launch"):
        for e in by_name[name]:
            assert coh["ts"] + coh["dur"] <= e["ts"] and e["ts"] < a


def test_timer_is_a_span_and_a_sum(tmp_path):
    """A Metrics.timer shows in the trace under its name, and its
    perf_counter seconds still reach as_dict()."""
    m = metrics.Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.timer("snp.infer_decode"):
            torch.ones(64).sum()
    names = [e["name"] for e in _events(prof, tmp_path)]
    assert names.count("snp.infer_decode") == 1
    assert m.as_dict()["timers_s"]["snp.infer_decode"] >= 0
    assert "snp.infer_decode" in m.timers and m.timers["snp.infer_decode"] > 0


def _wire_bytes(gf):
    S, N = len(gf.site_ref), len(gf.read_lo)
    return (4 * 4 * N  # read_lo, read_hi, span_start, order
            + 3 * (S + 1)  # site_ref, site_major, site_minor
            + len(gf.minor_bits)
            + 2 * 4 * (S + 2)  # exc_indptr, hole_indptr
            + 5 * len(gf.exc_rid) + 4 * len(gf.hole_rid)
            + 2 * 4 * (S + 1)  # win_lo, win_hi
            + 2 * 4 * len(gf.nbr_pos)
            + 2 * 7 * 4 * 4)  # bands


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_group_copy_counts(groups, state, case):
    """One group's counters: 18 wire fields less the empty ones (the
    fixture has no holes), plus 5 row arrays for each normal cohort and 6
    (the deep read ids) for each deep one, their bytes, and one blocking
    copy back a part."""
    gf = groups[case]
    # the wire's fields that can be empty: hole_rid, minor_bits, and
    # exc_rid / exc_code, nbr_pos / nbr_union in pairs
    empty = sum(n for f, n in (("hole_rid", 1), ("minor_bits", 1),
                               ("exc_rid", 2), ("nbr_pos", 2))
                if len(getattr(gf, f)) == 0)
    assert empty == 1 and len(gf.hole_rid) == 0
    rows = sum(len(sec) for _i, sec in gf.members)
    deep_rows = sum(len(sec.deep_idx) for _i, sec in gf.members)
    maxcov = GROUPS[case][1]
    n_deep = int(deep_rows > 0)
    parts = 1 + n_deep  # one replica: a launch (and a part) a cohort
    metrics.reset_counters("snp.")
    P.infer_snp_group(state, gf, Cfg())
    copies = WIRE_FIELDS - empty + 5 * (parts - n_deep) + 6 * n_deep
    want_bytes = _wire_bytes(gf) + 20 * rows + 4 * maxcov * deep_rows
    assert metrics.counters("snp.") == {
        "snp.groups": 1, "snp.h2d_bytes": want_bytes,
        "snp.blocking_copies": copies + parts}
    P.infer_snp_group(state, gf, Cfg())
    # the copies to the device: the blocking ones less a copy back a part
    c = metrics.counters("snp.")
    assert c["snp.blocking_copies"] - c["snp.groups"] * parts == 2 * copies


def test_groups_one_ahead_match_the_synchronous_path(groups, state):
    """Two groups interleaved one ahead through the async finishers, as
    call_snps runs them: each finisher is called after the next group's
    launches are queued, and gives the synchronous path's arrays. On the
    CPU no copy back is queued: nothing counts in snp.async_copy_backs,
    and each part's read counts one blocking copy."""
    want = {name: P.infer_snp_group(state, gf, Cfg())
            for name, gf in groups.items()}
    parts = {name: len(P.pileup_cohorts(state, gf, Cfg()))
             for name, gf in groups.items()}
    metrics.reset_counters("snp.")
    order = ["normal", "deep", "normal"]
    got, pending = [], None
    for name in order:
        fin = P.infer_snp_group(state, groups[name], Cfg(), async_mode=True)
        if pending is not None:
            got.append(pending())
        pending = fin
    got.append(pending())
    for name, outs in zip(order, got):
        assert len(outs) == len(want[name])
        for g, w in zip(outs, want[name]):
            assert g.dtype == np.float32 and np.array_equal(g, w)
    c = metrics.counters("snp.")
    assert "snp.async_copy_backs" not in c
    h2d = c["snp.blocking_copies"] - sum(parts[n] for n in order)
    metrics.reset_counters("snp.")
    for name in order:
        P.pileup_cohorts(state, groups[name], Cfg())
    assert metrics.counters("snp.")["snp.blocking_copies"] == h2d


def test_empty_arrays_are_no_copies():
    """A wire without holes sends 17 fields: PyTorch copies nothing for
    the empty hole_rid, so it is no blocking copy, and has no bytes."""
    w, *_ = random_group_wire(np.random.default_rng(5), S=40, N=60, B=3,
                              hole_share=0)
    assert len(w.hole_rid) == 0
    metrics.reset_counters("snp.")
    wire = K3.group_wire(w, "cpu")
    assert metrics.counters("snp.")["snp.blocking_copies"] == \
        WIRE_FIELDS - 1
    assert metrics.counters("snp.")["snp.h2d_bytes"] == sum(
        t.nbytes for t in vars(wire).values() if isinstance(t, torch.Tensor))


def test_registry_prefixes_and_buckets():
    """reset_counters and counters by prefix (a string or a tuple), and a
    kernel's launches and pairs summed over its buckets."""
    saved = metrics.counters()
    try:
        metrics.reset_counters()
        assert metrics.count("k1.launches.192x192") == 1
        metrics.count("k1.launches.64x128", 2)
        metrics.count("k1.pairs.192x192", 900)
        metrics.count("k1.pairs.64x128", 7)
        metrics.count("k3.launches.group", 3)
        metrics.count("k3.launches.chunk")
        assert metrics.total("k1.launches") == 3
        assert metrics.total("k1.pairs") == 907
        assert metrics.total("k3.launches") == 4
        assert metrics.total("k2.launches") == 0
        metrics.reset_counters("k3.launches.chunk")
        assert metrics.counters("k3.") == {"k3.launches.group": 3}
        metrics.reset_counters(("k1.", "k2."))
        assert metrics.counters() == {"k3.launches.group": 3}
        metrics.reset_counters()
        assert metrics.counters() == {}
    finally:
        metrics.reset_counters()
        for name, n in saved.items():
            metrics.count(name, n)


def test_timer_loads_no_torch():
    """A process that never loaded torch (a feature worker) times its
    stages without loading it."""
    code = ("import sys; from nanocaller_tpu_torch.runtime.metrics import "
            "Metrics, span\nm = Metrics()\nwith m.timer('a'), span('b', 1):"
            "\n    pass\nprint('torch' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
