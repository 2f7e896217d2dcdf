"""The port's `--cpu N` host layer (nanocaller_tpu_torch/runtime/
{scheduler,workers}.py and the split indel path of
pileup/indel_features.py) on the CPU: the job records the workers build
and finish_indel_jobs, which aligns them in the device owner, against
the JAX package's per-chunk and grouped indel features (exact); the
workers run without importing torch; a killed worker is requeued once
and a second death raises."""

import os
import subprocess
import sys

import numpy as np
import pytest

from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.pileup.indel_features import \
    get_indel_candidates as j_get_indel_candidates
from nanocaller_tpu.pileup.indel_features import \
    get_indel_group_candidates as j_get_indel_group_candidates
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.pileup.engine import decode_reads
from nanocaller_tpu_torch.pileup.indel_features import (
    IndelBatch, collect_chunk_jobs, finish_indel_jobs, get_indel_candidates,
    get_indel_group_candidates)
from nanocaller_tpu_torch.runtime.scheduler import feature_stream

from fixtures import make_fixture
from torch_threads import _torch_threads  # noqa: F401 (autouse)
from torch_worker_tasks import always_crashy_worker, crashy_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 40000
MEMBERS = [{"chrom": "chr_t", "start": s, "end": min(s + 9999, L),
            "ploidy": "diploid"} for s in range(1, L, 10000)]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_workers")
    indels = [(3000, "del", 6, "het1"), (11000, "ins", "TTTT", "hom"),
              (19000, "ins", "GGAGG", "het2"), (27000, "del", 4, "het2"),
              (35000, "ins", "ACAC", "het1")]
    fasta_p, bam_p, _, _ = make_fixture(
        tmp, depth=34, L=L, read_len=2600, seed=21, indels=indels,
        tag_haplotypes=True, error_rate=0.03)
    return str(tmp), fasta_p, bam_p


def assert_batches_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a.pos == b.pos
    fields = ("x0", "x1", "x2") if type(a).__name__ == "IndelBatch" \
        else ("x",)
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.alleles == b.alleles
    if fields != ("x",):
        assert a.phase == b.phase


def test_split_equals_per_chunk_and_finishes_together(fixture):
    """collect_chunk_jobs + finish_indel_jobs on one chunk is
    get_indel_candidates, equal to the JAX package's; one finish over
    three records (a haploid one among them) equals three one-record
    calls, element for element."""
    _tmp, fasta_p, bam_p = fixture
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    chunks = [dict(MEMBERS[0]), dict(MEMBERS[1], ploidy="haploid"),
              dict(MEMBERS[2])]
    recs = [collect_chunk_jobs(bam, fasta, c, ploidy=c["ploidy"])
            for c in chunks]
    together = finish_indel_jobs(recs, device="cpu")
    total = 0
    for c, rec, got in zip(chunks, recs, together):
        alone = finish_indel_jobs([rec], device="cpu")[0]
        assert_batches_equal(got, alone)
        assert_batches_equal(got, get_indel_candidates(
            bam, fasta, c, ploidy=c["ploidy"], device="cpu"))
        assert_batches_equal(got, j_get_indel_candidates(
            JBamReader(bam_p), JFastaFile(fasta_p), c, ploidy=c["ploidy"]))
        total += len(got)
    assert total >= 2


@pytest.mark.parametrize("case", ["diploid", "haploid", "tags"])
def test_grouped_path_matches_jax(fixture, case):
    """The worker's grouped job records, finished in one call, equal the
    JAX package's get_indel_group_candidates on the same BAM."""
    _tmp, fasta_p, bam_p = fixture
    members = [dict(m, ploidy="haploid" if case == "haploid" else "diploid")
               for m in MEMBERS]
    tags = None
    if case == "tags":
        # the phasing's in-memory handoff: haplotags over the BAM's own,
        # here with the haplotypes swapped and one phase set a read
        rw = decode_reads(BamReader(bam_p), "chr_t", 0, L)
        tags = {qn: (3 - int(h), 7 + k % 2)
                for k, (qn, h) in enumerate(zip(rw.qnames, rw.hp)) if h}
    recs = get_indel_group_candidates(BamReader(bam_p), FastaFile(fasta_p),
                                      members, tags=tags)
    assert all(isinstance(r, dict) for r in recs)  # jobs, not batches
    got = finish_indel_jobs(recs, device="cpu")
    want = j_get_indel_group_candidates(JBamReader(bam_p), JFastaFile(fasta_p),
                                        members, tags=tags)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert sum(len(g) for g in got) >= 2
    if case == "tags":
        assert any(p is not None and p >= 7
                   for g in got if isinstance(g, IndelBatch) for p in g.phase)


_ISOLATED = r"""
import sys
sys.path.insert(0, %(repo)r)
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.runtime import workers as W
cfg = Config(bam=%(bam)r, ref=%(fasta)r)
W.init_worker(%(bam)r, %(fasta)r, W.cfg_kwargs_for_workers(cfg), None)
chunks = [{"chrom": "chr_t", "start": 1, "end": 20000, "ploidy": "diploid"},
          {"chrom": "chr_t", "start": 20000, "end": 40000,
           "ploidy": "diploid"}]
_, payloads, _ = W.snp_features_group_worker((0, list(enumerate(chunks))))
assert sum(len(gf) for gf in payloads) > 0
_, info, _ = W.phase_contig_worker((0, dict(
    chrom="chr_t", start=1, end=40000, snp_vcf=%(vcf)r,
    out_vcf=%(out)r + "/p.vcf.gz", lowq_vcf=%(out)r + "/l.vcf.gz",
    tags_path=%(out)r + "/t.tsv", phase_threads=2)))
assert info["n_tags"] > 0
chunks = [dict(c, tags_path=info["tags_path"]) for c in chunks]
_, members, secs, _ = W.indel_features_group_worker(
    (0, list(enumerate(chunks))))
assert sum(len(r["jobs"]) for _, r in members) > 0 and secs > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "nanocaller_tpu"))
assert not bad, bad
print("ok")
"""


def test_workers_never_import_torch(fixture, tmp_path):
    """init_worker and a task of each kind in a fresh interpreter: no
    torch (and no jax) is imported."""
    from nanocaller_tpu_torch.caller import run
    from nanocaller_tpu_torch.config import Config

    tmp, fasta_p, bam_p = fixture
    out = str(tmp_path / "snps")
    snp_vcf = run(Config(bam=bam_p, ref=fasta_p, mode="snps", cpu=1,
                         output=out, prefix="p", sample="S", device="cpu",
                         suppress_progress=True))["snps"]
    script = _ISOLATED % dict(repo=REPO, bam=bam_p, fasta=fasta_p,
                              vcf=snp_vcf, out=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_killed_worker_requeues_and_completes(fixture, tmp_path):
    _tmp, fasta_p, bam_p = fixture
    sentinel = str(tmp_path / "killed_once")
    chunks = [{"val": i} for i in range(8)]
    chunks[3] = {"val": 3, "kill": True, "sentinel": sentinel}
    got = dict(feature_stream(chunks, crashy_worker,
                              (bam_p, fasta_p, {}, None), 2))
    assert got == {i: 2 * i for i in range(8)}
    assert os.path.exists(sentinel)  # the kill really happened


def test_persistent_death_raises_naming_resume(fixture):
    _tmp, fasta_p, bam_p = fixture
    chunks = [{"val": i} for i in range(6)]
    chunks[2] = {"val": 2, "kill": True}
    with pytest.raises(RuntimeError, match="worker died.*--resume"):
        for _ in feature_stream(chunks, always_crashy_worker,
                                (bam_p, fasta_p, {}, None), 2):
            pass


@pytest.mark.parametrize("order", ["in_order", "reversed", "interleaved"])
def test_indel_sink_finishes_every_chunk_in_chunk_order(fixture, tmp_path,
                                                        monkeypatch, order):
    """The device owner's sink takes the workers' job records in any order
    of arrival, finishes each contig's records in chunk order (here two
    at a time, so a late record sets several pending ones going at once)
    and gives every chunk the lines of the inline --cpu 1 path."""
    import nanocaller_tpu_torch.caller as C
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.indel_caller import IndelCallerState
    from nanocaller_tpu_torch.runtime.metrics import Metrics
    from nanocaller_tpu_torch.runtime.scheduler import RunManifest

    _tmp, fasta_p, bam_p = fixture
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    cfg = Config(bam=bam_p, ref=fasta_p, device="cpu")
    state = IndelCallerState.create(cfg.indel_model, device="cpu")
    chunks = [dict(m) for m in MEMBERS]

    def sink(name):
        return C._IndelSink(cfg, state, chunks, RunManifest(
            str(tmp_path / name / "m.json")), Metrics(), None)

    want = sink("inline")
    for i, c in enumerate(chunks):
        want.add_batch(i, get_indel_candidates(bam, fasta, c, device="cpu"))
    recs = [collect_chunk_jobs(bam, fasta, c) for c in chunks]
    arrival = {"in_order": [0, 1, 2, 3], "reversed": [3, 2, 1, 0],
               "interleaved": [1, 3, 0, 2]}[order]
    monkeypatch.setattr(C, "_FLUSH_AT", 2)
    got = sink(order)
    for i in arrival:
        got.add_record(i, recs[i])
    lines = got.chunk_lines()
    assert lines == want.chunk_lines()
    assert sum(len(x) for x in lines) >= 3
