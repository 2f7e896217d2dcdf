"""The control on the card: the plain reference computed in TF32 (the
nearest precision below the configuration's float32 with TF32 off), in
the program's place, fails the check that the program passes. One
group of the cell's own traffic (31,376 rows); the benchmark's runs never
run this."""

import time

import pytest

from nbench import harness


class OneGroup(harness.Spec):
    def traffic(self, name):
        t = super().traffic(name)
        t.update(groups=1)
        return t


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3500000001, 3500000002, 3500000003])
def test_control_fails_the_check(cuda_device, seed):
    res, checks, _notes = harness.run(OneGroup(), "ont_snp_stream", seed, 0.5,
                                     0, cuda_device, time.perf_counter(),
                                     control=True)
    control, limit = checks["snp_prob_gap"]
    program, _limit = checks["program_snp_prob_gap"]
    assert program <= limit < control
    assert not res["correct"]
