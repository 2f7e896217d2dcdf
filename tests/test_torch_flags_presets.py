"""The ONT `--preset`s against the JAX CLI at `--mode all --cpu 1`:
short_ont (neighbour threshold 0.3,0.7, so other neighbour sets for K3),
ul_ont and ul_ont_extreme, on one untagged contig
(sim.write_contigs_fixture); all five VCFs byte-identical or within the
parity bar, case by case (tests/torch_flags.py)."""

import os

import pytest

from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_flags import VCFS, records, run_both, vcf_bytes, vcf_path
from torch_threads import _torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_presets")
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp), [("chr1", 40000, 41, 400, 4000, False)], depth=30,
        read_len=3000)
    return str(tmp), fasta_p, bam_p


@pytest.mark.parametrize("preset", ["short_ont", "ul_ont", "ul_ont_extreme"])
def test_preset_matches_jax_cli(fixture, preset):
    cfg, _, _ = run_both(*fixture, preset, ["--preset", preset])
    assert cfg.sequencing == preset
    if preset == "short_ont":
        assert cfg.neighbor_threshold == "0.3,0.7"
    out = os.path.join(fixture[0], "port_" + preset)
    data = [vcf_bytes(vcf_path(out, n)) for n in VCFS]
    assert data[1].count(b"\tPASS\t") >= 20
    # ul_ont_extreme's bands pick neighbours up to 10 kb away, which 3 kb
    # reads rarely cover, so few of its SNPs pass the phasing's QUAL bar
    if preset != "ul_ont_extreme":
        assert data[2].count(b"|") > 20
    assert records(vcf_path(out, "indels"))
