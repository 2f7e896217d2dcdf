"""The port against the plain reference on the CPU at tiny sizes: the
pileup exactly (the port's K3 twin on the CPU against reference.py's
frozen copy over the benchmark's own arrays), the CNN within float32
rounding, and whole runs of the harness that come out correct."""

import numpy as np
import pytest
import torch

from nbench import harness, reference

SEED = 2**32 + 99


def _snp_kind(spec, **cfg_over):
    wl = spec.workload("ont_snp_stream")
    cfg = dict(spec.config(wl["config"]), **cfg_over)
    t = spec.traffic(wl["traffic"])
    t.update(hole_share=0.02)  # the traffic has none; cover the hole CSR
    return spec.kind("snp_stream")(cfg, t, SEED, "cpu", spec.root)


@pytest.mark.parametrize("maxcov", [160, 12])
def test_pileup_equals_the_port_twin(tiny_spec, maxcov):
    """maxcov 12 makes most rows deep (sampled read ids): the tiny
    traffic reads at about 19x."""
    from nanocaller_tpu_torch.pileup.snp_pileup import snp_pileup
    from nanocaller_tpu_torch.snp_caller import pileup_cohorts

    kind = _snp_kind(tiny_spec, maxcov=maxcov)
    deep_rows = 0
    for k, g in enumerate(kind.groups):
        gf = kind.inputs[k]
        tab = reference.GroupTables(g, "cpu")
        for ploidy, deep, args, mis, js, _r in pileup_cohorts(
                kind.state, gf, kind.pcfg):
            x, _soc, ref = snp_pileup(*args)
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)
            rows = [(kind.groups[k]["members"][mi], j)
                    for mi, j in zip(mis, js)]
            rids = None
            if deep:
                deep_rows += len(rows)
                rids = torch.stack([torch.as_tensor(
                    m["deep_rids"][np.searchsorted(m["deep_idx"], j)])
                    for m, j in rows])
            x2, ref2, _need = reference.snp_pileup(
                tab, kind.cfg["neighbour_bands"],
                t([m["cand_site"][j] for m, j in rows]),
                t([m["cand_pos32"][j] for m, j in rows]),
                t([m["nbr_lo"] for m, _j in rows]),
                t([m["nbr_hi"] for m, _j in rows]), args[5], rids)
            assert torch.equal(x, x2)
            assert torch.equal(ref, ref2)
    assert (deep_rows > 0) == (maxcov == 12)


def test_snp_cnn_matches_the_port_model(tiny_spec):
    kind = _snp_kind(tiny_spec)
    tree, _cov = reference.load_pack(
        tiny_spec.root + "/" + kind.cfg["snp_pack"])
    p = reference.to_device(tree, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 5, 41, 5, generator=g)
    ref = torch.nn.functional.one_hot(torch.randint(0, 4, (64,),
                                                    generator=g), 4).float()
    with torch.inference_mode():
        port = kind.state.model(x, ref)[0][:, :, 1]
        plain = reference.snp_cnn(p, x, ref)
    assert float((port - plain).abs().max()) < 1e-5


def test_snp_run_is_correct(tiny_spec):
    import time

    res, checks, _notes = harness.run(tiny_spec, "ont_snp_stream", SEED, 0.5,
                                     0, "cpu", time.perf_counter())
    value, limit = checks["snp_prob_gap"]
    assert res["correct"] and value < 1e-5 < limit
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"snp_sites_per_s", "setup_s"}
    assert res["device"]["platform"] == "cpu"
