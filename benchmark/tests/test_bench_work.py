"""The operation and byte counts against hand counts, and the trace
reduction on a hand-made trace."""

import json
import os

import numpy as np
import pytest

from nbench import reference, work
from nbench.trace import kernel_seconds, reduce_events

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


# multiply-adds by hand: conv out * H_out * W_out * in * kh * kw
SNP_MACS = (16 * 5 * 41 * 5 * 1 * 5       # conv1_1 (1,5), same padding
            + 16 * 5 * 41 * 5 * 5 * 1     # conv1_2 (5,1)
            + 16 * 5 * 41 * 5 * 5 * 5     # conv1_3 (5,5)
            + 32 * 4 * 20 * 48 * 2 * 3    # conv2 (2,3) stride (1,2)
            + 64 * 3 * 9 * 32 * 2 * 3     # conv3
            + 1728 * 48 + 48 * 16 + 4 * 17 * 2 + 48 * 16 + 24 * 8 + 8 * 2)


def test_cnn_flops_by_hand():
    cfg = _cfg("ont_r941_hg002")
    assert work.cnn_flops(cfg["snp_cnn"]) == 2 * SNP_MACS == 3_455_760


def test_layer_tables_match_the_weight_packs():
    cfg = _cfg("ont_r941_hg002")
    tree, _cov = reference.load_pack(os.path.join(ROOT, cfg["snp_pack"]))
    shapes = work.weight_shapes(cfg["snp_cnn"])
    assert {k: tree[k]["kernel"].shape for k in shapes} == shapes
    assert set(shapes) == set(tree)


def test_k3_bytes_by_hand():
    dims = dict(N=10, S=6, T=3, E=4, H=2, M=5)
    wire = (4 * 10 * 4 + 3 * 7 + 3 + 2 * 4 * 8 + 5 * 4 + 4 * 2 + 2 * 4 * 7
            + 2 * 4 * 5 + 2 * 7 * 4 * 4)
    outs = 3 * (5 * 41 * 5 * 4 + 41 * 4 + 16)
    assert work.k3_bytes(dims, 3, 0) == wire + 3 * 5 * 4 + outs
    assert work.k3_bytes(dims, 3, 8) == wire + 3 * 5 * 4 + 3 * 8 * 4 \
        + 3 * 4 + outs


def test_k3_ops_by_hand():
    need = {"cell_codes": 100, "counted_cells": 40, "selected_columns": 7}
    # M = 5: ceil(log2(6)) = 3 search steps a band end
    sel = 2 * 10 * (2 * 3 * 5 + 12) + 7 * 3
    assert work.k3_ops(need, 2, 10, 5) == 100 * 17 + 40 * 3 + sel


def test_bound_names_what_bounds_it():
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    t, by = work.bound_s(peaks, nbytes=3.35e9, ops=1.0)
    assert by == "bytes" and t == pytest.approx(1e-3)
    t, by = work.bound_s(peaks, nbytes=1.0, ops=peaks["int32_ops_per_s"])
    assert by == "operations" and t == pytest.approx(1.0)


def test_pileup_counts_what_it_needs():
    """reference.snp_pileup's counts on a hand-made group: two reads over
    three sites, one hole, one exception coded 4 (not counted)."""
    import torch

    g = dict(read_lo=np.array([0, 1], np.int32),
             read_hi=np.array([2, 2], np.int32),
             site_ref=np.array([0, 1, 2], np.int8),
             site_major=np.array([0, 1, 2], np.int8),
             site_minor=np.array([3, 3, 3], np.int8),
             minor_bits=np.zeros(1, np.uint8),
             exc_site=np.array([2], np.int32), exc_rid=np.array([1], np.int32),
             exc_code=np.array([4], np.int8),
             hole_site=np.array([1], np.int32),
             hole_rid=np.array([0], np.int32),
             nbr_pos=np.array([100, 300], np.int32),
             nbr_union=np.array([0, 2], np.int32))
    tab = reference.GroupTables(g, "cpu")
    bands = _cfg("ont_r941_hg002")["neighbour_bands"]
    t = lambda *v: torch.tensor(v, dtype=torch.int64)
    x, ref, need = reference.snp_pileup(
        tab, bands, t(1), t(200), t(0), t(2), torch.ones(1))
    # centre site 1: read 0 has a hole there, read 1 covers it (code 1);
    # columns: site 0 (left, read 1 does not cover it), site 2 (right,
    # read 1's exception 4)
    assert need == {"covering_reads": 1, "counted_cells": 1,
                    "counted_reads": 1, "cell_codes": 3,
                    "selected_columns": 2}
    assert float(x[0, 1 + 1, 20, 1]) == -1.0  # flipped at its ref base
    assert torch.equal(ref[0], torch.tensor([0.0, 1.0, 0.0, 0.0]))


def test_trace_reduction_by_hand():
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,
                                     "ts": ts, "dur": dur}
    events = [ev("bench.window", "user_annotation", 0, 100),
              ev("snp.enqueue", "user_annotation", 0, 40),
              ev("snp.finish", "user_annotation", 40, 60),
              ev("snp_pileup_kernel", "kernel", 10, 10),
              ev("conv", "kernel", 15, 15),
              ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 55, 10),
              ev("late", "kernel", 200, 5)]
    s = reduce_events(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["copies_s"] == pytest.approx(10e-6)
    assert kernel_seconds(s, "snp_pileup") == (1, pytest.approx(10e-6))
    # gaps: [65,100) and [30,55) under finish at their midpoints, [0,10)
    # under enqueue
    assert [g[0] for g in s["idle_gaps"]] == ["snp.finish", "snp.finish",
                                              "snp.enqueue"]
    assert s["idle_gaps"][0][1] == pytest.approx(35e-6)
    assert reduce_events(events[1:]) is None
