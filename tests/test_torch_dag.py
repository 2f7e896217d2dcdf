"""`--cpu N` end to end on the CPU: the port's run(cfg) at --cpu 2 against
the JAX CLI at --cpu 2 on a two-contig fixture (a diploid chr1 and a
chrX of hom SNPs, run with --haploid_X), so that the per-contig
phase→indel DAG phases chr1 in a worker, copies chrX unphased and
unlocks chrX's indels at once. The five VCFs must agree with the JAX
CLI's byte for byte, except where a probability delta within the parity
bar (2e-5) crosses a printed rounding: each such case is printed and
held to chip_smoke.compare_records' rules. The phased BAM must be
record-identical, two runs byte-identical, and --resume must reproduce
the VCFs. Also `--mode indels|snps` and `snps --phase` at --cpu 2, and
the flags that cross the worker boundary."""

import gzip
import json
import os

import pytest

import chip_smoke
from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu_torch.caller import run
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_threads import _torch_threads  # noqa: F401 (autouse)

VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")
KIND = {"unfiltered.snps": "snp", "snps": "snp", "snps.phased": "snp",
        "indels": "indel", "": "any"}
ARTIFACT = os.path.join("intermediate_phase_files", "chr1.phased.bam")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dag")
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp), [("chr1", 60000, 11, 500, 4000, False),
                   ("chrX", 30000, 12, 500, 4000, True)],
        depth=30, read_len=3000)
    return str(tmp), fasta_p, bam_p


def _kw(fixture, out, **extra):
    tmp, fasta_p, bam_p = fixture
    # batch_size 128 on both sides keeps the JAX package's CPU compile short
    kw = dict(bam=bam_p, ref=fasta_p, mode="all", cpu=2, haploid_X=True,
              output=os.path.join(tmp, out), prefix="p", sample="S",
              suppress_progress=True, batch_size=128)
    kw.update(extra)
    return kw


def _path(fixture, out, name):
    return os.path.join(fixture[0], out, "p.%s.vcf.gz" % name if name
                        else "p.vcf.gz")


def _bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


def _match_jax(fixture, port, jax, names=VCFS):
    """Each VCF byte-identical to the JAX CLI's, or record by record
    within the parity bar; returns the rounding cases, printed."""
    cases = []
    for name in names:
        a, b = _path(fixture, port, name), _path(fixture, jax, name)
        if _bytes(a) == _bytes(b):
            continue
        try:
            _, diffs = chip_smoke.compare_records(a, b, KIND[name])
        except SystemExit:
            pytest.fail("%s differs from the JAX CLI's beyond the parity "
                        "bar" % name)
        cases += [dict(d, vcf=name) for d in diffs]
    for d in cases:
        print("parity-bar case:", d)
    return cases


def _records(path):
    return [(r.qname, r.flag, r.ref_id, r.pos, r.mapq, list(r.cigar), r.seq,
             bytes(r.qual), sorted(r.tags.items()))
            for r in BamReader(path).fetch("chr1")]


@pytest.fixture(scope="module")
def runs(fixture):
    j_run(JConfig(**_kw(fixture, "jax")))
    return run(Config(device="cpu", **_kw(fixture, "port")))


def test_dag_matches_jax_cli(fixture, runs):
    cases = _match_jax(fixture, "port", "jax")
    # only probability-printed fields may differ (compare_records), and
    # only as rounding cases: QUAL/PR/VF of SNPs, QUAL/GQ of indels
    assert all(d["field"] in ("QUAL", "PR", "VF", "GQ") for d in cases)
    data = [_bytes(_path(fixture, "port", n)) for n in VCFS]
    assert data[2].count(b"|") > 20 and b":PS" in data[3]
    assert b"chrX\t" in data[2] and b"chrX\t" in data[4]
    assert runs["final"] == _path(fixture, "port", "")
    got = _records(os.path.join(fixture[0], "port", ARTIFACT))
    assert got == _records(os.path.join(fixture[0], "jax", ARTIFACT))
    assert sum(1 for *_, t in got if t) > len(got) // 2
    assert not os.path.exists(os.path.join(
        fixture[0], "port", "intermediate_phase_files", "chrX.phased.bam"))
    with open(os.path.join(fixture[0], "port", "metrics.json")) as fh:
        metrics = json.load(fh)
    timeline = metrics["stage_timeline"]
    unlocked = [e["t"] for e in timeline if e["stage"] == "indels_unlocked"]
    done = [e["t"] for e in timeline if e["stage"] == "phase_done"]
    assert len(unlocked) == 2 and len(done) == 1
    assert min(unlocked) < max(done)  # chrX's indels ran during phasing
    assert {"phasing", "indel.features_core", "indel.align_finish",
            "indel.infer_decode", "phase.haplotag_bam"} <= \
        set(metrics["timers_s"])


def test_two_runs_and_resume_identical(fixture, runs):
    want = [_bytes(_path(fixture, "port", n)) for n in VCFS]
    run(Config(device="cpu", **_kw(fixture, "port_again")))
    assert [_bytes(_path(fixture, "port_again", n)) for n in VCFS] == want
    # --resume reuses every SNP and indel shard and re-phases
    run(Config(device="cpu", resume=True, **_kw(fixture, "port_again")))
    assert [_bytes(_path(fixture, "port_again", n)) for n in VCFS] == want


@pytest.mark.parametrize("flush_at", [384, 8])
def test_dag_equals_the_serial_run(fixture, runs, monkeypatch, flush_at):
    """--cpu 2 (workers, grouped indel jobs, the DAG) and --cpu 1 (inline)
    give the same bytes, also when a contig's jobs are finished in
    several device passes (flush_at 8, with 20 kb chunks: several a
    contig, one worker group). Chunk-mean coverage normalization depends
    on the chunks, which depend on --cpu, so both runs normalize per
    candidate (as tests/test_scheduler.py does for the JAX package)."""
    import nanocaller_tpu_torch.caller as C

    monkeypatch.setattr(C, "_FLUSH_AT", flush_at)
    if flush_at < 384:
        chunks = C.get_chunks
        monkeypatch.setattr(C, "get_chunks", lambda regions, cpu, **kw: chunks(
            regions, cpu, max_chunk_size=20000))
    got = {}
    for cpu in (1, 2):
        out = "port_serial%d_%d" % (cpu, flush_at)
        run(Config(device="cpu", **_kw(fixture, out, cpu=cpu,
                                       disable_coverage_normalization=True)))
        got[cpu] = [_bytes(_path(fixture, out, n)) for n in VCFS]
    assert got[1] == got[2]
    assert got[2][3].count(b"\n") > 20


@pytest.mark.parametrize("extra", [
    dict(mode="indels"), dict(mode="snps"), dict(mode="snps", phase=True)])
def test_modes_match_jax_cli(fixture, runs, extra):
    names = {"indels": ("indels",), "snps": VCFS[:3] if extra.get("phase")
             else VCFS[:2]}[extra["mode"]]
    tag = "_".join(str(v) for v in extra.values())
    if extra["mode"] == "indels":
        # the indel stage alone reads the input's HP/PS tags: take the
        # DAG's haplotagged chr1 artifact as the input
        extra = dict(extra, bam=os.path.join(fixture[0], "port", ARTIFACT))
    j_run(JConfig(**_kw(fixture, "jax_" + tag, **extra)))
    out = run(Config(device="cpu", **_kw(fixture, "port_" + tag, **extra)))
    _match_jax(fixture, "port_" + tag, "jax_" + tag, names)
    assert out["final"] is None
    if extra["mode"] == "indels":
        data = _bytes(out["indels"])
        assert out["snps"] is None and data.count(b"\nchr1\t") >= 5
        assert b":PS" in data


@pytest.mark.parametrize("extra", [
    dict(impute_indel_phase=True), dict(exclude_bed="bed"),
    dict(enable_whatshap=True), dict(haploid_genome=True),
    dict(phase_qual_score=20.0, mincov=6)])
def test_boundary_flags_match_jax_cli(fixture, runs, extra):
    """The flags the workers read from cfg_kwargs_for_workers, the
    exclude BED init_worker opens and the chunks' ploidy."""
    if "exclude_bed" in extra:
        bed = os.path.join(fixture[0], "exclude.bed")
        with open(bed, "w") as fh:
            fh.write("chr1\t9000\t21000\nchrX\t4000\t9000\n")
        extra = dict(exclude_bed=bed)
    tag = next(iter(extra))
    j_run(JConfig(**_kw(fixture, "jax_" + tag, **extra)))
    run(Config(device="cpu", **_kw(fixture, "port_" + tag, **extra)))
    _match_jax(fixture, "port_" + tag, "jax_" + tag)
    base = _bytes(_path(fixture, "port", ""))
    assert _bytes(_path(fixture, "port_" + tag, "")) != base  # it acted
