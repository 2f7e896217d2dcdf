"""A group of ultra-long ONT reads through the port's SNP path
(infer_snp_group) against the plain reference, under the ont cell's
limit. Its read windows outgrow K3's list of 256 reads, so on the card
K3 takes those rows in rounds; on the CPU the port's twin runs. One
group at a 500 kb cut (1,568 rows, 379 reads up to 1 Mb long), the
ul_ont preset's neighbour bands."""

import time

import numpy as np
import pytest

from nbench import gen_snp, harness

# NanoCaller's ul_ont bands (generate_SNP_pileups.py:41-61): [lo, hi)
# offsets from the candidate, how many neighbours, and which end of the
# band they are taken from
UL_BANDS = {
    "left": [[-99999, -50000, 3, "last"], [-50000, -40000, 3, "last"],
             [-40000, -20000, 4, "last"], [-20000, -10000, 3, "last"],
             [-10000, -5000, 3, "last"], [-5000, -2000, 2, "last"],
             [-2000, 0, 2, "first"]],
    "right": [[1, 2001, 2, "last"], [2001, 5001, 2, "first"],
              [5001, 10001, 3, "first"], [10001, 20001, 3, "first"],
              [20001, 40001, 4, "first"], [40001, 50001, 3, "first"],
              [50001, 100000, 3, "first"]]}
SEED = 3  # draws a read that spans the whole cut


class UlSpec(harness.Spec):
    def __init__(self, ul_reads):
        super().__init__()
        self.ul_reads = ul_reads

    def config(self, name):
        return dict(super().config(name), sequencing="ul_ont",
                    neighbour_bands=UL_BANDS)

    def traffic(self, name):
        t = self.ul_reads(super().traffic(name))
        t.update(groups=1, members_per_group=2, member_bp=200000,
                 halo_bp=50000)
        return t


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_ul_group_is_correct(request, ul_reads, device):
    if device == "cuda":
        request.getfixturevalue("cuda_device")
    from nanocaller_tpu_torch.pileup.snp_pileup import read_windows

    spec = UlSpec(ul_reads)
    cfg = spec.config("ont_r941_hg002")
    t = spec.traffic("ont_snp_stream")
    (g,) = gen_snp.make_pool(t, SEED, cfg["maxcov"], cfg["sequencing"])
    S = len(g["site_ref"])
    _order, k0, k1 = read_windows(g["read_lo"], g["read_hi"], S)
    rows = np.concatenate([m["cand_site"] for m in g["members"]])
    assert ((k1 - k0)[rows] > 256).sum() > 100
    res, checks, _notes = harness.run(spec, "ont_snp_stream", SEED, 0.5, 0,
                                     device, time.perf_counter())
    value, limit = checks["snp_prob_gap"]
    assert limit == cfg["limits"]["snp_prob_gap"]
    assert res["correct"] and value <= limit
    assert res["attempted"] and res["attempted"] % gen_snp.rows_of(g) == 0
