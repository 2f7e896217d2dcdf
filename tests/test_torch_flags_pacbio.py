"""The PacBio presets against the JAX CLI at `--mode all --cpu 1`: ccs
(CCS-HG002 packs, neighbour threshold 0.3,0.7, indel deletion threshold
0.4, whatshap-style phasing and imputed indel phase), clr (CLR-HG002,
win_size 10, small_win_size 2), and `--sequencing pacbio` alone (the
ONT packs). pacbio reads 260 bp of reference after a candidate instead
of 160, so the indel pairs fall into the (256|320, 320) buckets of
K1/K2/K4 (their plain twins here). All five VCFs byte-identical or
within the parity bar, case by case (tests/torch_flags.py)."""

import os

import pytest

from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_flags import records, run_both, vcf_bytes, vcf_path
from torch_threads import _torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_pacbio")
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp), [("chr1", 40000, 43, 400, 4000, False)], depth=30,
        read_len=3000)
    return str(tmp), fasta_p, bam_p


@pytest.mark.parametrize("flags", [
    ["--preset", "ccs"], ["--preset", "clr"], ["--sequencing", "pacbio"]],
    ids=["ccs", "clr", "sequencing_pacbio"])
def test_pacbio_matches_jax_cli(fixture, flags, monkeypatch):
    seen = {}
    twin = K.nw_cigar_reference

    def spy(ops, qraw, rraw):
        key = (qraw.shape[1], rraw.shape[1])
        seen[key] = seen.get(key, 0) + 1
        return twin(ops, qraw, rraw)

    monkeypatch.setattr(K, "nw_cigar_reference", spy)
    tag = "_".join(f.lstrip("-") for f in flags)
    cfg, _, _ = run_both(*fixture, tag, flags)
    assert cfg.sequencing == "pacbio"
    if flags[-1] == "clr":
        assert (cfg.win_size, cfg.small_win_size) == (10, 2)
    # the 261 bp reference windows of the MSA round
    assert any(R == 320 and Q >= 256 for Q, R in seen), seen
    out = os.path.join(fixture[0], "port_" + tag)
    assert vcf_bytes(vcf_path(out, "snps")).count(b"\tPASS\t") >= 20
    assert records(vcf_path(out, "indels"))
