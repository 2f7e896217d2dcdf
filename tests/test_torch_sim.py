"""The port's simulator against the JAX package's from the same seeds:
_inject_hp_slips (the ONT homopolymer-slip error model) on a sequence
rich in homopolymer runs, make_diploid_readset with hp_slip_rate > 0
(reads equal, slips present, and a zero rate that draws nothing),
make_fixture (FASTA, BAM and their indexes byte-equal, and the truth VCF
of its planted SNPs), and the simulate tool's files byte-equal with and
without --hp_profile, on one contig and two."""

import os
import sys

import numpy as np
import pytest

from nanocaller_tpu import sim as J
from nanocaller_tpu_torch import sim as P
from nanocaller_tpu_torch.tools.simulate import main as p_simulate

from torch_threads import _torch_threads  # noqa: F401 (autouse)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
SEEDS = (3, 11)


def _files(d):
    return sorted(f for f in os.listdir(d))


def _same_files(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def _hp_rich(rng):
    """A sequence of 20 bp random fillers between homopolymer runs of
    4-14 bp."""
    parts = []
    for rlen in (4, 6, 8, 10, 12, 14) * 10:
        parts.append(J.random_seq(rng, 20))
        parts.append("ACGT"[int(rng.integers(0, 4))] * rlen)
    return "".join(parts)


@pytest.mark.parametrize("seed", SEEDS)
def test_hp_slips_equal(seed):
    seq = _hp_rich(np.random.default_rng(seed))
    cigar = [("M", 100), ("I", 3), ("M", len(seq) - 103)]
    want = J._inject_hp_slips(np.random.default_rng(seed), seq, cigar, 0.08)
    got = P._inject_hp_slips(np.random.default_rng(seed), seq, cigar, 0.08)
    assert got == want
    assert any(op in ("I", "D") for op, _ in got[1][2:])  # slips happened


@pytest.mark.parametrize("seed", SEEDS)
def test_readset_with_hp_slips_equal(seed):
    rng = np.random.default_rng(seed)
    ref = _hp_rich(rng)
    snps = [(50, "A" if ref[50] != "A" else "C", "het1")]
    indels = [(300, "del", 2, "hom"), (700, "ins", "GG", "het2")]
    kw = dict(snps=snps, indels=indels, depth=20, read_len=400,
              error_rate=0.02, indel_error_rate=0.01, hp_slip_rate=0.05)
    want = J.make_diploid_readset(np.random.default_rng(seed), ref, **kw)
    got = P.make_diploid_readset(np.random.default_rng(seed), ref, **kw)
    assert got == want
    # the slips changed the reads: the same draws without them differ
    kw["hp_slip_rate"] = 0.0
    plain = P.make_diploid_readset(np.random.default_rng(seed), ref, **kw)
    assert plain != got
    assert plain == J.make_diploid_readset(np.random.default_rng(seed), ref,
                                           **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_make_fixture_byte_equal(tmp_path, seed):
    """FASTA, BAM and their indexes byte-equal; a truth VCF of the
    planted SNPs written by each package's writer byte-equal too."""
    dirs = []
    for name, mod in (("jax", J), ("port", P)):
        d = tmp_path / name
        d.mkdir()
        fasta_p, bam_p, ref, snps = mod.make_fixture(
            d, seed=seed, L=6000, depth=20, read_len=700, error_rate=0.03,
            indels=[(2000, "del", 4, "het1"), (4000, "ins", "ACG", "hom")],
            tag_haplotypes=seed % 2 == 1)
        mod.write_truth_vcf(str(d / "truth.vcf.gz"), "chr_t", ref, snps)
        assert os.path.basename(fasta_p) == "ref.fa"
        assert os.path.basename(bam_p) == "reads.bam"
        dirs.append(d)
    _same_files(*dirs)


@pytest.mark.parametrize("flags", [[], ["--hp_profile"],
                                   ["--hp_profile", "--contigs", "2",
                                    "--haplotag"]],
                         ids=["plain", "hp_profile", "hp_two_contigs"])
def test_simulate_tool_byte_equal(tmp_path, flags):
    sys.path.insert(0, TOOLS)
    from simulate import main as j_simulate

    argv = ["--length", "40000", "--depth", "12", "--read_len", "3000",
            "--error_rate", "0.02", "--indel_error_rate", "0.005",
            "--seed", "5", "--hp_spacing", "1500"] + flags
    j_simulate(["--output", str(tmp_path / "jax")] + argv)
    got = p_simulate(["--output", str(tmp_path / "port")] + argv)
    assert [os.path.basename(p) for p in got] == \
        ["ref.fa", "reads.bam", "truth.vcf.gz"]
    _same_files(tmp_path / "jax", tmp_path / "port")
    if "--hp_profile" in flags:
        assert "hp_regions.bed" in _files(tmp_path / "port")
