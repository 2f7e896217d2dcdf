"""`--mode indels --cpu 1` and `--mode snps --cpu 1` end to end: the
port's run(cfg) on the CPU against the JAX package's caller.run, on a
small haplotagged fixture (indels) and on one with planted SNPs (snps).
The decompressed VCF bytes must be identical: indels.vcf.gz, and
unfiltered.snps.vcf.gz with snps.vcf.gz. On these seeds no probability
delta crosses a %.3f / %.4f rounding, so no one-unit allowance is
needed. The phasing modes are in test_torch_all.py."""

import gzip
import json
import os

import numpy as np
import pytest

from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu.io.fasta import write_fasta
from nanocaller_tpu_torch.caller import run
from nanocaller_tpu_torch.cli import config_from_args
from nanocaller_tpu_torch.config import Config

from fixtures import make_diploid_readset, make_fixture, random_seq, write_bam
from torch_threads import _torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(77)
    L = 9000
    ref = random_seq(rng, L)
    indels = [(1800, "del", 5, "het1"), (4200, "ins", "GGTT", "hom"),
              (6600, "del", 3, "het2"), (7700, "ins", "TA", "het1")]
    reads = make_diploid_readset(rng, ref, snps=[], indels=indels, depth=30,
                                 read_len=1100, error_rate=0.02,
                                 indel_error_rate=0.004)
    fasta_p = str(tmp / "ref.fa")
    bam_p = str(tmp / "reads.bam")
    write_fasta(fasta_p, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads, tag_haplotypes=True)
    return str(tmp), fasta_p, bam_p


def _vcf(path):
    with gzip.open(path) as fh:
        return fh.read()


def _kw(fixture, out):
    tmp, fasta_p, bam_p = fixture
    return dict(bam=bam_p, ref=fasta_p, mode="indels", cpu=1,
                output=os.path.join(tmp, out), prefix="p", sample="S",
                suppress_progress=True)


def test_vcf_identical_to_jax_cli(fixture):
    want = j_run(JConfig(**_kw(fixture, "jax")))["indels"]
    got = run(Config(device="cpu", **_kw(fixture, "port")))["indels"]
    data = _vcf(got)
    assert data == _vcf(want)
    assert sum(1 for l in data.splitlines() if not l.startswith(b"#")) >= 2
    # --resume reuses the manifest's shards and reproduces the bytes
    again = run(Config(device="cpu", resume=True, **_kw(fixture, "port")))
    assert _vcf(again["indels"]) == data


def test_cli_flags(fixture):
    tmp, fasta_p, bam_p = fixture
    cfg = config_from_args(["--bam", bam_p, "--ref", fasta_p, "--mode",
                            "indels", "--device", "cpu", "--preset", "ccs"])
    assert cfg.device == "cpu" and cfg.mode == "indels"
    assert cfg.del_threshold == 0.4  # preset applied
    assert config_from_args(["--bam", bam_p, "--ref", fasta_p]).device == "cuda"


@pytest.fixture(scope="module")
def snp_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_snp")
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=13, L=30000, depth=30,
                                        read_len=2000, error_rate=0.03)
    return str(tmp), fasta_p, bam_p


def test_snp_vcfs_identical_to_jax_cli(snp_fixture):
    # batch_size 128 on both sides keeps the JAX package's CPU compile short
    kw = lambda out: dict(_kw(snp_fixture, out), mode="snps", batch_size=128)
    j_run(JConfig(**kw("jax")))
    got = run(Config(device="cpu", **kw("port")))
    names = ("p.unfiltered.snps.vcf.gz", "p.snps.vcf.gz")
    path = lambda out, name: os.path.join(snp_fixture[0], out, name)
    data = [_vcf(path("port", n)) for n in names]
    assert data == [_vcf(path("jax", n)) for n in names]
    assert got["snps"] == path("port", names[1]) and got["indels"] is None
    assert data[1].count(b"\tPASS\t") >= 10
    with open(path("port", "metrics.json")) as fh:
        timers = json.load(fh)["timers_s"]
    assert {"snp_calling", "snp.features", "snp.infer_decode"} <= set(timers)
    # --resume reuses the manifest's shards; a deeper pipeline changes no
    # byte either
    for extra in (dict(resume=True), dict(snp_pipeline_depth=3)):
        run(Config(device="cpu", **kw("port"), **extra))
        assert [_vcf(path("port", n)) for n in names] == data


@pytest.mark.parametrize("change", [
    dict(mode="all", watchdog=5), dict(mode="snps", dedup_transfer=False),
    dict(mode="snps", snp_group_payload=False)],
    ids=["change1", "change3", "change4"])  # the ids they had beside --cpu 2
def test_unported_modes_raise(fixture, change):
    kw = _kw(fixture, "nope")
    kw.update(change)
    with pytest.raises(NotImplementedError):
        run(Config(device="cpu", **kw))
