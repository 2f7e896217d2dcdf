"""The port's multi-process and region-sharded runs on the CPU
(nanocaller_tpu_torch/runtime/distributed.py, caller.run, cli.main):

- shard_regions, shard_chunks and merge_host_outputs against the JAX
  package's on region lists with fewer regions than processes, a small
  contig alone (an empty shard), a contig over 400 kb (split sub-contig)
  and haploid regions;
- `--num_shards 2` shard runs plus `--merge_shards` at `--mode all
  --cpu 2` on a two-contig fixture (a diploid chr1, a haploid chrX under
  --haploid_X) against the port's unsharded run, and against the JAX
  CLI's `--num_shards 2` runs and merge;
- two spawned port processes joined by Gloo (`--coordinator
  --num_processes 2 --process_id i`, --device cpu): process 0's merged
  VCFs equal the shard runs' merge byte for byte, both
  metrics.host00i.json hold the summed counters; a single-contig
  fixture leaves process 1 an empty shard and both still exit 0; a
  process that dies makes the other exit non-zero.

Both fixtures keep every run's chunking equal: get_chunks cuts
max(10,000, total / cpu + 1) bp chunks, so a shard's chunks are the
unsharded run's only where that clamps at 10,000 bp, i.e. under 20 kb in
all at --cpu 2. With equal chunks the bodies are equal byte for byte.
The merged headers are not: io/vcf.concat (as the JAX package's) puts
the second shard's ##contig line before #CHROM, after the INFO and
FORMAT lines, where an unsharded run lists both contigs together, so
those headers are held as the same set of lines."""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

import chip_smoke
from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu.runtime import distributed as JD
from nanocaller_tpu_torch import cli
from nanocaller_tpu_torch.runtime import distributed as D
from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")
KIND = {"unfiltered.snps": "snp", "snps": "snp", "snps.phased": "snp",
        "indels": "indel", "": "any"}
# (name, bp, seed, SNP every, indel every, hom SNPs only)
CHR1 = ("chr1", 10_000, 41, 300, 1500, False)
CHRX = ("chrX", 9_500, 42, 300, 1500, True)
# each spawned process: torch import, two feature workers, the run
PROC_TIMEOUT = 240

REGION_CASES = {
    "fewer_regions_than_processes": [("chr1", 1, 900_000, "diploid"),
                                     ("chr2", 1, 300_000, "diploid")],
    "one_small_contig": [("chr1", 1, 150_000, "diploid")],
    "one_contig_over_400kb": [("chr1", 1, 450_000, "diploid")],
    "haploid_regions": [("chr1", 1, 50_000, "diploid"),
                        ("chrX", 1, 700_000, "haploid"),
                        ("chrY", 1, 60_000, "haploid"),
                        ("chr2", 101, 30_000, "diploid")],
}


@pytest.mark.parametrize("case", sorted(REGION_CASES))
@pytest.mark.parametrize("count", [2, 3])
def test_shard_regions_match_jax(case, count):
    regions = REGION_CASES[case]
    got = [D.shard_regions(regions, i, count) for i in range(count)]
    assert got == [JD.shard_regions(regions, i, count) for i in range(count)]
    # every base of every region lands in exactly one shard
    cover = sorted((c, s, e) for shard in got for c, s, e, _ in shard)
    assert sum(e - s + 1 for _, s, e in cover) == \
        sum(e - s + 1 for _, s, e, _ in regions)
    if case == "one_small_contig":
        assert got[1] == []
    if case == "one_contig_over_400kb" and count == 2:
        assert [len(g) for g in got] == [1, 1]


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_chunks_match_jax(count):
    chunks = [{"chrom": "chr1", "start": s, "end": s + 999}
              for s in range(1, 11_000, 1000)]
    for i in range(count):
        assert D.shard_chunks(chunks, i, count) == \
            JD.shard_chunks(chunks, i, count)


def test_single_process_collectives_are_local():
    assert D.initialize(num_processes=1) == (0, 1)
    assert D.allreduce_counts({"a": 2, "b": 0.5}) == {"a": 2, "b": 0.5}
    D.barrier()
    D.shutdown()
    assert D.process_device("cpu", 3) == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        D.process_device("cuda", 1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _argv(fasta_p, bam_p, out, *extra):
    return ["--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu", "2",
            "--haploid_X", "--device", "cpu", "--output", out, "--prefix",
            "p", "--sample", "S", "--suppress_progress_bar", *extra]


def _spawn(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [REPO, env.get("PYTHONPATH", "")] if p)
    # torch's intra-op threads as in this process (torch_threads): two
    # processes with a pool the size of the machine each crowd it out
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return subprocess.Popen(
        [sys.executable, "-m", "nanocaller_tpu_torch.cli", *args], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _two_processes(fasta_p, bam_p, out, bams=None):
    """Both processes of a `--num_processes 2` run → [(rc, output)]."""
    coord = "localhost:%d" % _free_port()
    procs = [_spawn(_argv(fasta_p, (bams or [bam_p, bam_p])[i], out,
                          "--coordinator", coord, "--num_processes", "2",
                          "--process_id", str(i)))
             for i in range(2)]
    res = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=PROC_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a --num_processes 2 process did not end in %d s"
                        % PROC_TIMEOUT)
        res.append((p.returncode, o.decode(errors="replace")))
    return res


def _path(out, name):
    return os.path.join(out, "p.%s.vcf.gz" % name if name else "p.vcf.gz")


def _split(path):
    with gzip.open(path) as fh:
        lines = fh.read().split(b"\n")
    return ([x for x in lines if x.startswith(b"#")],
            [x for x in lines if not x.startswith(b"#")])


def _bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_distributed"))
    fasta_p, bam_p, _, _ = write_contigs_fixture(tmp, [CHR1, CHRX],
                                                 depth=30, read_len=3000)
    return tmp, fasta_p, bam_p


@pytest.fixture(scope="module")
def shard_runs(two_contigs):
    """The port's unsharded run ("one"), its two --num_shards 2 runs and
    --merge_shards ("shards"), and the JAX CLI's ("jax")."""
    tmp, fasta_p, bam_p = two_contigs
    out = {k: os.path.join(tmp, k) for k in ("one", "shards", "jax")}
    cli.main(_argv(fasta_p, bam_p, out["one"]))
    for i in range(2):
        cli.main(_argv(fasta_p, bam_p, out["shards"], "--num_shards", "2",
                       "--shard_index", str(i)))
        # batch_size 128 keeps the JAX package's CPU compile short
        j_run(JConfig(bam=bam_p, ref=fasta_p, mode="all", cpu=2,
                      haploid_X=True, output=out["jax"], prefix="p",
                      sample="S", suppress_progress=True, batch_size=128,
                      num_shards=2, shard_index=i))
    merged = cli.main(_argv(fasta_p, bam_p, out["shards"], "--num_shards",
                            "2", "--merge_shards"))
    assert sorted(merged) == ["final", "indels", "phased_snps", "snps",
                              "unfiltered_snps"]
    JD.merge_host_outputs(out["jax"], "p", 2)
    return out


def test_shard_runs_merge_to_the_unsharded_run(shard_runs):
    for name in VCFS:
        head, body = _split(_path(shard_runs["shards"], name))
        want_head, want_body = _split(_path(shard_runs["one"], name))
        assert body == want_body, name
        assert sorted(head) == sorted(want_head), name
        assert head != want_head  # the merge's ##contig order (docstring)
    _, body = _split(_path(shard_runs["one"], "snps.phased"))
    assert sum(b"|" in x for x in body) > 10
    assert any(x.startswith(b"chrX\t") for x in body)
    for i, contig in enumerate((b"chr1", b"chrX")):
        _, body = _split(os.path.join(shard_runs["shards"],
                                      "p.host%03d.unfiltered.snps.vcf.gz" % i))
        assert {x.split(b"\t")[0] for x in body if x} == {contig}
        assert os.path.isdir(os.path.join(
            shard_runs["shards"], "intermediate_phase_files.host%03d" % i))
        with open(os.path.join(shard_runs["shards"],
                               "metrics.host%03d.json" % i)) as fh:
            assert json.load(fh)["counts"]["snp_chunks"] == 1


def test_shard_runs_match_the_jax_cli(shard_runs):
    cases = []
    for name in VCFS:
        a, b = _path(shard_runs["shards"], name), _path(shard_runs["jax"],
                                                        name)
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
    assert all(d["field"] in ("QUAL", "PR", "VF", "GQ") for d in cases)


def test_two_processes_equal_the_shard_runs(two_contigs, shard_runs):
    tmp, fasta_p, bam_p = two_contigs
    out = os.path.join(tmp, "procs")
    res = _two_processes(fasta_p, bam_p, out)
    for rc, log in res:
        assert rc == 0, log[-3000:]
    for name in VCFS:
        assert _bytes(_path(out, name)) == \
            _bytes(_path(shard_runs["shards"], name)), name
    with open(os.path.join(shard_runs["one"], "metrics.json")) as fh:
        single = json.load(fh)["counts"]
    for i in range(2):
        with open(os.path.join(out, "metrics.host%03d.json" % i)) as fh:
            m = json.load(fh)
        assert m["hosts"] == 2
        assert m["global_counts"] == single
        assert os.path.exists(os.path.join(out, "args.host%03d" % i))


@pytest.fixture(scope="module")
def one_contig(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_distributed_one"))
    fasta_p, bam_p, _, _ = write_contigs_fixture(tmp, [CHR1], depth=30,
                                                 read_len=3000)
    return tmp, fasta_p, bam_p


def test_empty_shard_finishes(one_contig):
    """One 10 kb contig over two processes: shard_regions gives process 1
    nothing; it meets the barrier and the all-reduce and exits 0, and
    process 0's merge is the single-process run's output."""
    tmp, fasta_p, bam_p = one_contig
    cli.main(_argv(fasta_p, bam_p, os.path.join(tmp, "one")))
    out = os.path.join(tmp, "procs")
    res = _two_processes(fasta_p, bam_p, out)
    for rc, log in res:
        assert rc == 0, log[-3000:]
    for name in VCFS:
        assert _bytes(_path(out, name)) == \
            _bytes(_path(os.path.join(tmp, "one"), name)), name
    assert not os.path.exists(os.path.join(out, "p.host001.snps.vcf.gz"))
    with open(os.path.join(out, "metrics.host001.json")) as fh:
        m = json.load(fh)
    assert m["counts"] == {} and m["global_counts"]["snp_chunks"] == 1


def test_a_dead_process_fails_the_run(one_contig, tmp_path):
    """Process 1 fails (its BAM does not exist): process 0 does not finish
    alone, it raises at the barrier and exits non-zero."""
    _tmp, fasta_p, bam_p = one_contig
    missing = str(tmp_path / "missing.bam")
    res = _two_processes(fasta_p, bam_p, str(tmp_path / "procs"),
                         bams=[bam_p, missing])
    assert res[1][0] != 0 and "missing.bam" in res[1][1]
    assert res[0][0] != 0, res[0][1][-3000:]
    assert not os.path.exists(str(tmp_path / "procs" / "p.snps.vcf.gz"))


def test_merge_host_outputs_matches_jax(shard_runs, tmp_path):
    """The port's merge of the shard files equals the JAX package's merge
    of the same files, byte for byte."""
    outs = []
    for tag, merge in (("port", D.merge_host_outputs),
                       ("jax", JD.merge_host_outputs)):
        d = tmp_path / tag
        d.mkdir()
        for f in os.listdir(shard_runs["shards"]):
            if ".host" in f and f.endswith(".vcf.gz"):
                shutil.copy(os.path.join(shard_runs["shards"], f), d / f)
        merged = merge(str(d), "p", 2)
        outs.append({k: _bytes(v) for k, v in merged.items()})
    assert outs[0] == outs[1] and len(outs[0]) == 5
