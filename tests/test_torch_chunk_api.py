"""The port's one-chunk entry points against the JAX package's on the
same ~6 kb fixtures: snp_caller.call_chunk (diploid and haploid, with
dedup_transfer on, the chunk's SnpChunkFeatures on K3's twin, and off,
its dense SnpBatch on K5's twin) and indel_caller.call_indel_chunk
(diploid and haploid, planted het and hom indels; the alignments on the
twins of K1, K2 and K4, JAX's on its host NW). The port's states load
the same weight packs through models/weights.py. The VCF body lines must
be byte-identical, but for the parity bar's rounding cases listed in
ROUNDING_CASES, each within the bar."""

import pytest

from nanocaller_tpu import indel_caller as JI
from nanocaller_tpu import snp_caller as JS
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu_torch import indel_caller as PI
from nanocaller_tpu_torch import snp_caller as PS
from nanocaller_tpu_torch.config import Config as PConfig
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile

from fixtures import make_fixture
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 6000
CHUNK = {"chrom": "chr_t", "start": 1, "end": L}
INDELS = [(1500, "del", 6, "het1"), (3000, "ins", "TTTTT", "hom"),
          (4500, "ins", "GATC", "het2")]
# (ploidy, 1-based POS) of the records whose QUAL may differ: at POS 175
# the haploid record's QUAL (-100 log10(1e-10 + 1 - p)) reads 77.937 from
# JAX and 77.938 from the port, on either SNP path; the probabilities
# that imply them differ by about 4e-6, within the bar
ROUNDING_CASES = {("haploid", 175)}
PARITY_ATOL = 2e-5  # ROADMAP "Parity bar"


def _rounding_cases(ploidy, want, got):
    """The POS of each line pair that differs: only in QUAL, by an
    implied probability within PARITY_ATOL (haploid QUAL is phred x 100,
    diploid x 10)."""
    assert len(got) == len(want)
    scale = 100 if ploidy == "haploid" else 10
    out = set()
    for a, b in zip(want, got):
        if a == b:
            continue
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:5] + fa[6:] == fb[:5] + fb[6:], (a, b)
        dp = abs(10 ** (-float(fa[5]) / scale) - 10 ** (-float(fb[5]) / scale))
        assert dp <= PARITY_ATOL, (a, b, dp)
        out.add((ploidy, int(fa[1])))
    return out


@pytest.fixture(scope="module")
def snp_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunk_api_snp")
    fasta_p, bam_p, _, snps = make_fixture(
        tmp, depth=30, L=L, read_len=800, seed=6, error_rate=0.04)
    return fasta_p, bam_p, snps


@pytest.fixture(scope="module")
def indel_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunk_api_indel")
    fasta_p, bam_p, _, _ = make_fixture(
        tmp, depth=36, L=L, read_len=900, seed=21, snps=[], indels=INDELS,
        tag_haplotypes=True)
    return fasta_p, bam_p


@pytest.fixture(scope="module")
def snp_states():
    return (JS.SnpCallerState.create("ONT-HG002", mesh=None),
            PS.SnpCallerState.create("ONT-HG002", device="cpu"))


@pytest.fixture(scope="module")
def indel_states():
    return (JI.IndelCallerState.create("ONT-HG002", mesh=None),
            PI.IndelCallerState.create("ONT-HG002", device="cpu"))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("ploidy", ["diploid", "haploid"])
def test_call_chunk_lines_identical(snp_fixture, snp_states, ploidy, dedup):
    fasta_p, bam_p, snps = snp_fixture
    jstate, pstate = snp_states
    chunk = dict(CHUNK, ploidy=ploidy)
    kw = dict(bam=bam_p, ref=fasta_p, batch_size=128, dedup_transfer=dedup)
    want = JS.call_chunk(jstate, JBamReader(bam_p), JFastaFile(fasta_p),
                         chunk, JConfig(**kw))
    got = PS.call_chunk(pstate, BamReader(bam_p), FastaFile(fasta_p), chunk,
                        PConfig(device="cpu", **kw))
    assert len(want) > len(snps) // 2
    assert _rounding_cases(ploidy, want, got) <= ROUNDING_CASES
    if ploidy == "diploid":
        called = {int(l.split("\t")[1]) - 1 for l in got
                  if l.split("\t")[6] == "PASS"}
        assert len(called & {p for p, _, _ in snps}) >= len(snps) - 1


@pytest.mark.parametrize("ploidy", ["diploid", "haploid"])
def test_call_indel_chunk_lines_identical(indel_fixture, indel_states,
                                          ploidy):
    fasta_p, bam_p = indel_fixture
    jstate, pstate = indel_states
    chunk = dict(CHUNK, ploidy=ploidy)
    kw = dict(bam=bam_p, ref=fasta_p)
    want = JI.call_indel_chunk(jstate, JBamReader(bam_p), JFastaFile(fasta_p),
                               chunk, JConfig(**kw))
    got = PI.call_indel_chunk(pstate, BamReader(bam_p), FastaFile(fasta_p),
                              chunk, PConfig(device="cpu", **kw))
    assert got == want
    # diploid: records whose REF spans cover two of the planted indels
    spans = [(int(f[1]) - 1, int(f[1]) - 1 + len(f[3]))
             for f in (l.split("\t") for l in got)]
    assert spans
    if ploidy == "diploid":
        assert sum(any(a <= p < b for a, b in spans)
                   for p, _, _, _ in INDELS) >= 2, got


def test_empty_chunk_gives_no_lines(snp_fixture, indel_fixture, snp_states,
                                    indel_states):
    """A chunk with no candidate: both entry points return [], as the JAX
    functions do."""
    chunk = {"chrom": "chr_t", "start": 1001, "end": 1050}
    for (fasta_p, bam_p), (jstate, pstate), j_call, p_call in (
            (snp_fixture[:2], snp_states, JS.call_chunk, PS.call_chunk),
            (indel_fixture, indel_states, JI.call_indel_chunk,
             PI.call_indel_chunk)):
        kw = dict(bam=bam_p, ref=fasta_p)
        assert j_call(jstate, JBamReader(bam_p), JFastaFile(fasta_p), chunk,
                      JConfig(**kw)) == []
        assert p_call(pstate, BamReader(bam_p), FastaFile(fasta_p), chunk,
                      PConfig(device="cpu", **kw)) == []
