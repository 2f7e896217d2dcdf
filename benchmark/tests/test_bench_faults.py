"""The check fails a broken timed path: a run on the CPU (the harness's
look for a chip skipped) with a fault planted underneath the port's
entry comes out not correct, once for each fault the SNP cell can have:
half of the batch left out, an answer altered where it is produced (the
CNN's probability, and the pileup K3 builds, on 8 rows of a launch or
on one)."""

import time

import pytest

from nbench import harness


def _half_left_out(cnn):
    def run(replica, ploidy, x, ref, bs):
        probs = cnn(replica, ploidy, x, ref, bs)
        probs[probs.shape[0] // 2:] = 0.0
        return probs
    return "_snp_cnn", run


def _answer_altered(cnn):
    def run(replica, ploidy, x, ref, bs):
        probs = cnn(replica, ploidy, x, ref, bs)
        probs[0, 0] += 0.01
        return probs
    return "_snp_cnn", run


def _pileup_altered(pileup, rows=8):
    def run(*args):
        x, soc, ref = pileup(*args)
        # one more read counted at the centre of a launch's first rows
        x[:rows, 1, 20, 0] += args[5][:rows]
        return x, soc, ref
    return "snp_pileup", run


def _pileup_row_altered(pileup):
    return _pileup_altered(pileup, rows=1)


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered,
                                   _pileup_altered, _pileup_row_altered])
def test_fault_is_not_correct(tiny_spec, monkeypatch, fault):
    from nanocaller_tpu_torch import snp_caller

    name, broken = fault(getattr(snp_caller, name_of(fault)))
    monkeypatch.setattr(snp_caller, name, broken)
    res, checks, _notes = harness.run(tiny_spec, "ont_snp_stream", 77, 0.3, 0,
                                     "cpu", time.perf_counter())
    value, limit = checks["snp_prob_gap"]
    assert not res["correct"] and value > limit


def name_of(fault):
    return "snp_pileup" if fault in (_pileup_altered, _pileup_row_altered) \
        else "_snp_cnn"


def test_sound_run_is_correct(tiny_spec):
    res, _checks, _notes = harness.run(tiny_spec, "ont_snp_stream", 77, 0.3,
                                      0, "cpu", time.perf_counter())
    assert res["correct"]


def test_nothing_compared_is_not_correct(tiny_spec, monkeypatch):
    """A window whose outputs never come back to be kept compares
    nothing, and is not correct for it."""
    from nbench.stream import Stream

    monkeypatch.setattr(Stream, "_keep", lambda self, k, out: None)
    res, checks, _notes = harness.run(tiny_spec, "ont_snp_stream", 77, 0.3,
                                      0, "cpu", time.perf_counter())
    assert checks["snp_prob_gap"][0] == 0.0 and not res["correct"]
