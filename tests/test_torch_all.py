"""`--mode all --cpu 1` and `--mode snps --phase --cpu 1` end to end: the
port's run(cfg) on the CPU against the JAX package's caller.run on an
untagged fixture (SNPs every 400 bp, a few planted indels), so the
indel stage reads only the haplotags the run's own phasing hands it in
memory. The five VCFs (unfiltered.snps, snps, snps.phased, indels and
the final one) must be byte-identical after gunzip, and the haplotagged
BAM artifacts record-identical (the JAX package writes its artifact
with a native retagger, the port with its Python BAM writer, so the
compressed bytes differ)."""

import gzip
import json
import os

import pytest

from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu_torch.caller import run
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.sim import write_all_fixture

from torch_threads import _torch_threads  # noqa: F401 (autouse)

VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")
ARTIFACT = os.path.join("intermediate_phase_files", "chr_t.phased.bam")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_all")
    fasta_p, bam_p, _, _, _ = write_all_fixture(
        str(tmp), 36000, seed=7, snp_every=400, indel_every=4000, depth=30,
        read_len=3000)
    return str(tmp), fasta_p, bam_p


def _kw(fixture, out, **extra):
    tmp, fasta_p, bam_p = fixture
    # batch_size 128 on both sides keeps the JAX package's CPU compile short
    kw = dict(bam=bam_p, ref=fasta_p, mode="all", cpu=1,
              output=os.path.join(tmp, out), prefix="p", sample="S",
              suppress_progress=True, batch_size=128)
    kw.update(extra)
    return kw


def _vcfs(out_dir, names=VCFS):
    got = []
    for n in names:
        with gzip.open(os.path.join(out_dir, "p.%s.vcf.gz" % n if n
                                    else "p.vcf.gz")) as fh:
            got.append(fh.read())
    return got


def _records(path):
    """Decoded records of a BAM: every field the artifact carries."""
    return [(r.qname, r.flag, r.ref_id, r.pos, r.mapq, list(r.cigar), r.seq,
             bytes(r.qual), list(r.tags.items()))
            for r in BamReader(path).fetch("chr_t")]


@pytest.fixture(scope="module")
def runs(fixture):
    """The JAX CLI's and the port's --mode all on the fixture."""
    j_run(JConfig(**_kw(fixture, "jax")))
    outputs = run(Config(device="cpu", **_kw(fixture, "port")))
    return outputs


def test_all_five_vcfs_identical_to_jax_cli(fixture, runs):
    port, jax = (os.path.join(fixture[0], o) for o in ("port", "jax"))
    data = _vcfs(port)
    assert data == _vcfs(jax)
    assert runs["final"] == os.path.join(port, "p.vcf.gz")
    assert runs["phased_snps"] == os.path.join(port, "p.snps.phased.vcf.gz")
    # the SNPs are phased into blocks, and so are indels, from tags that
    # only the run's phasing gave (the BAM has none)
    assert data[2].count(b"|") > 20 and b":PS" in data[3]
    assert data[4].count(b"\n") > data[2].count(b"\n")


def test_phased_bam_record_identical(fixture, runs):
    got = _records(os.path.join(fixture[0], "port", ARTIFACT))
    assert got == _records(os.path.join(fixture[0], "jax", ARTIFACT))
    tagged = [t for *_, t in got if t]
    assert len(tagged) > len(got) // 2
    assert all([k for k, _ in t] == ["HP", "PS"] for t in tagged)


def test_metrics_carry_phasing_timers(fixture, runs):
    with open(os.path.join(fixture[0], "port", "metrics.json")) as fh:
        timers = json.load(fh)["timers_s"]
    assert {"snp_calling", "phasing", "phase.decode", "phase.mec",
            "phase.haplotag_bam", "indel_calling"} <= set(timers)


@pytest.mark.parametrize("extra", [dict(resume=True),
                                   dict(skip_phased_bam=True)])
def test_resume_and_skip_phased_bam_reproduce_vcfs(fixture, runs, extra):
    out = "port_" + next(iter(extra))
    want = _vcfs(os.path.join(fixture[0], "jax"))
    run(Config(device="cpu", **_kw(fixture, out)))
    artifact = os.path.join(fixture[0], out, ARTIFACT)
    os.remove(artifact)
    run(Config(device="cpu", **_kw(fixture, out, **extra)))
    assert _vcfs(os.path.join(fixture[0], out)) == want
    # --resume rewrites the artifact (phasing reruns); --skip_phased_bam
    # writes none
    assert os.path.exists(artifact) == ("resume" in extra)


@pytest.mark.parametrize("extra", [dict(mode="snps", phase=True),
                                   dict(enable_whatshap=True)])
def test_snps_phase_and_whatshap_match_jax_cli(fixture, runs, extra):
    name = "_".join(str(k) for k in extra)
    names = VCFS if extra.get("mode") != "snps" else VCFS[:3]
    j_run(JConfig(**_kw(fixture, "jax_" + name, **extra)))
    outputs = run(Config(device="cpu", **_kw(fixture, "port_" + name,
                                             **extra)))
    data = _vcfs(os.path.join(fixture[0], "port_" + name), names)
    assert data == _vcfs(os.path.join(fixture[0], "jax_" + name), names)
    assert data[2].count(b"|") > 20
    if "mode" in extra:
        assert outputs["indels"] is None and outputs["final"] is None


def test_profile_writes_a_chrome_trace(fixture):
    run(Config(device="cpu", **_kw(fixture, "port_profile", mode="snps",
                                   profile=True)))
    path = os.path.join(fixture[0], "port_profile", "trace", "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    # the stage's own timer and the group path's spans, on the trace
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"snp_calling", "snp.features", "snp.infer_decode", "snp.cohorts",
            "snp.wire", "snp.copy_in", "snp.launch", "snp.copy_out"} <= spans
