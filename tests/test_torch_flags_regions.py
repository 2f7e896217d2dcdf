"""The region flags against the JAX CLI, on three contigs: chr1, a
diploid chrX and a chrM (sim.write_contigs_fixture). `--regions` with
two intervals, one of them partial, and `--bed` with a two-interval BED
at `--mode all --cpu 1`; `--wgs_contigs chr1-22XY` at `--cpu 2` (the
feature workers and the phase→indel DAG), which must skip chrM. All five
VCFs byte-identical or within the parity bar, case by case
(tests/torch_flags.py)."""

import os

import pytest

from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_flags import records, run_both, vcf_path
from torch_threads import _torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_regions")
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp), [("chr1", 40000, 51, 400, 4000, False),
                   ("chrX", 20000, 52, 400, 4000, False),
                   ("chrM", 12000, 53, 400, 4000, True)],
        depth=30, read_len=3000)
    return str(tmp), fasta_p, bam_p


def _spans(tmp, tag):
    """{contig: (first, last) record position} of the final VCF."""
    got = {}
    for c, p in records(vcf_path(os.path.join(tmp, "port_" + tag), "")):
        lo, hi = got.get(c, (p, p))
        got[c] = (min(lo, p), max(hi, p))
    return got


def test_regions_match_jax_cli(fixture):
    run_both(*fixture, "regions",
             ["--cpu", "1", "--regions", "chr1:8001-27000", "chrX"])
    spans = _spans(fixture[0], "regions")
    assert set(spans) == {"chr1", "chrX"}
    assert 8001 <= spans["chr1"][0] and spans["chr1"][1] <= 27000
    assert spans["chrX"][1] > 15000


def test_bed_matches_jax_cli(fixture):
    bed = os.path.join(fixture[0], "two.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t3000\t15000\nchrM\t2000\t9000\n")
    run_both(*fixture, "bed", ["--cpu", "1", "--bed", bed])
    spans = _spans(fixture[0], "bed")
    assert set(spans) == {"chr1", "chrM"}
    assert 3000 <= spans["chr1"][0] and spans["chr1"][1] <= 15000
    assert 2000 <= spans["chrM"][0] and spans["chrM"][1] <= 9000


def test_wgs_contigs_match_jax_cli(fixture):
    run_both(*fixture, "wgs", ["--cpu", "2", "--wgs_contigs", "chr1-22XY"])
    spans = _spans(fixture[0], "wgs")
    assert set(spans) == {"chr1", "chrX"}  # chrM skipped
