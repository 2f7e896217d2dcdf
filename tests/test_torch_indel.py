"""The port's indel slice against the JAX package on the fixture of
tests/test_indel.py: candidate features (exact), CNN probabilities
(atol 2e-5), and decode / decomposition lines (byte-identical given the
same probabilities)."""

from collections import defaultdict

import numpy as np
import pytest

from nanocaller_tpu import indel_caller as J
from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.io.vcf import VcfRecord as JVcfRecord
from nanocaller_tpu.pileup.indel_features import \
    get_indel_candidates as j_get_indel_candidates
from nanocaller_tpu_torch import indel_caller as P
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.io.vcf import VcfRecord
from nanocaller_tpu_torch.align.batch_nw import BatchAligner
from nanocaller_tpu_torch.pileup.indel_features import (collect_chunk_jobs,
                                                        finish_indel_jobs,
                                                        get_indel_candidates)

from fixtures import make_fixture
from test_decompose_fuzz import mk_rec, random_alt
from torch_threads import _torch_threads  # noqa: F401 (autouse)

KW = dict(seq_type="ont", mincov=4, maxcov=160, ins_t=0.4, del_t=0.6,
          win_size=40, small_win_size=4)
CHUNK = {"chrom": "chr_t", "start": 1, "end": 6000}


@pytest.fixture(scope="module")
def indel_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_indel")
    indels = [
        (1500, "del", 6, "het1"),
        (3000, "ins", "TTTTT", "hom"),
        (4500, "ins", "GATC", "het2"),
    ]
    fasta_p, bam_p, _, _ = make_fixture(
        tmp, depth=36, L=6000, read_len=900, seed=21, snps=[],
        indels=indels, tag_haplotypes=True)
    return fasta_p, bam_p


@pytest.fixture(scope="module")
def batches(indel_fixture):
    fasta_p, bam_p = indel_fixture
    out = {}
    for ploidy in ("diploid", "haploid"):
        want = j_get_indel_candidates(JBamReader(bam_p), JFastaFile(fasta_p),
                                      CHUNK, ploidy=ploidy, **KW)
        got = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p),
                                   CHUNK, ploidy=ploidy, device="cpu", **KW)
        out[ploidy] = (want, got)
    return out


def test_diploid_candidates_identical(batches):
    want, got = batches["diploid"]
    assert len(want) > 0 and got.pos == want.pos
    for k in ("x0", "x1", "x2"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.alleles == want.alleles
    assert got.phase == want.phase


def test_haploid_candidates_identical(batches):
    want, got = batches["haploid"]
    assert len(want) > 0 and got.pos == want.pos
    np.testing.assert_array_equal(got.x, want.x)
    assert got.alleles == want.alleles


def test_tuple_cigars_give_the_same_batches(indel_fixture, batches,
                                            monkeypatch):
    """finish_indel_jobs takes packed run arrays for the MSA round; the
    (op, len) lists of packed=False give the same batches, so the same
    VCFs (tests/test_torch_all.py and test_torch_dag.py hold the packed
    path's VCFs to the JAX CLI's)."""
    fasta_p, bam_p = indel_fixture
    recs = [collect_chunk_jobs(BamReader(bam_p), FastaFile(fasta_p), CHUNK,
                               ploidy=p, **KW)
            for p in ("diploid", "haploid")]
    timers = defaultdict(float)
    packed = finish_indel_jobs(recs, device="cpu", timers=timers)
    assert set(timers) == {"indel.align_finish." + k for k in
                           ("encode", "kernels", "msa", "alleles")}
    seen = []
    orig = BatchAligner.align_many

    def tuples(self, pairs, packed=False):
        seen.append(packed)
        return orig(self, pairs, packed=False)

    monkeypatch.setattr(BatchAligner, "align_many", tuples)
    plain = finish_indel_jobs(recs, device="cpu")
    assert seen == [True, False]  # the MSA round asked for packed runs
    for got, (_, want) in zip((packed, plain), (batches["diploid"],) * 2):
        assert got[0].pos == want.pos and got[0].alleles == want.alleles
        for k in ("x0", "x1", "x2"):
            np.testing.assert_array_equal(getattr(got[0], k),
                                          getattr(want, k))
    for got in (packed, plain):
        np.testing.assert_array_equal(got[1].x, batches["haploid"][1].x)
        assert got[1].alleles == batches["haploid"][1].alleles


def test_probabilities_match(batches):
    jstate = J.IndelCallerState.create("ONT-HG002", mesh=None)
    pstate = P.IndelCallerState.create("ONT-HG002", device="cpu")
    want_b, got_b = batches["diploid"]
    (want,) = J.infer_indel_many(jstate, [want_b])
    (got,) = P.infer_indel_many(pstate, [got_b])
    np.testing.assert_allclose(got, want, atol=2e-5)
    want_b, got_b = batches["haploid"]
    (want,) = J.infer_haploid_indel_many(jstate, [want_b])
    (got,) = P.infer_haploid_indel_many(pstate, [got_b])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_decode_lines_identical(batches):
    want_b, got_b = batches["diploid"]
    rng = np.random.default_rng(8)
    for _ in range(20):
        probs = rng.dirichlet([0.3, 1, 1, 1], size=len(got_b))
        assert (P.decode_diploid_indels(got_b, probs)
                == J.decode_diploid_indels(want_b, probs))
    want_b, got_b = batches["haploid"]
    probs = rng.random(len(got_b))
    assert (P.decode_haploid_indels(got_b, probs)
            == J.decode_haploid_indels(want_b, probs))


@pytest.mark.parametrize("seed", range(12))
def test_decompose_lines_identical(seed):
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(3, 16))
    ref = "".join("ACGT"[int(b)] for b in rng.integers(0, 4, n))
    alt1 = random_alt(rng, ref) or ref + "A"
    alt2 = random_alt(rng, ref) or "T" + ref
    lines = [mk_rec(ref, alt1, gq="21").line(),
             mk_rec(ref, "%s,%s" % (alt1, alt2), gt="1|2", ps="7").line()]
    for line in lines:
        want = [r.line() for r in J.decompose_and_filter(
            [JVcfRecord.parse(line)])]
        got = [r.line() for r in P.decompose_and_filter(
            [VcfRecord.parse(line)])]
        assert got == want
    assert P.primitives_of(ref, alt1) == J.primitives_of(ref, alt1)
