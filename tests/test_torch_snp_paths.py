"""The per-chunk and dense SNP paths end to end on the CPU: the port's
run(cfg) against the JAX CLI on a two-contig fixture (a diploid chr1 and
a chrX of hom SNPs, run with --haploid_X), under --no_dedup_transfer
(dense batches, kernel K5's twin), --no_snp_group_payload (one
SnpChunkFeatures a member, K3's twin on a chunk wire) and
snp_group_span = -1 (one decode a chunk), at --cpu 1 and --cpu 2: the
SNP VCFs byte-identical to the JAX CLI's with the same flags, except
where a probability delta within the parity bar (2e-5) crosses a printed
rounding (each case printed and held to chip_smoke.compare_records'
rules); the port's group, chunk and dense runs byte-identical to each
other; `--mode all --no_dedup_transfer` (all five VCFs); a chunk over
the group payload caps on its own (the read cap lowered in both
packages), and the same chunk over _TABLE_CELL_CAP too; the workers of
these paths never import torch."""

import gzip
import os
import subprocess
import sys

import pytest

import chip_smoke
from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu.pileup import snp_features as j_sf
from nanocaller_tpu_torch.caller import run
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.pileup import snp_features as p_sf
from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNP_VCFS = ("unfiltered.snps", "snps")
VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")
KIND = {"unfiltered.snps": "snp", "snps": "snp", "snps.phased": "snp",
        "indels": "indel", "": "any"}
# the SNP paths by their Config changes (snp_group_span is an attribute
# both callers read, not a CLI flag)
PATHS = {"group": {}, "dense": dict(dedup_transfer=False),
         "chunk": dict(snp_group_payload=False),
         "span": dict(snp_group_span=-1)}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_snp_paths")
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp), [("chr1", 60000, 11, 500, 4000, False),
                   ("chrX", 30000, 12, 500, 4000, True)],
        depth=30, read_len=3000)
    return str(tmp), fasta_p, bam_p


def _cfg(cls, fixture, out, path, cpu, mode="snps", **extra):
    tmp, fasta_p, bam_p = fixture
    # batch_size 128 on both sides keeps the JAX package's CPU compile short
    kw = dict(bam=bam_p, ref=fasta_p, mode=mode, cpu=cpu, haploid_X=True,
              output=os.path.join(tmp, out), prefix="p", sample="S",
              suppress_progress=True, batch_size=128, **extra)
    span = PATHS[path].get("snp_group_span")
    cfg = cls(**kw, **{k: v for k, v in PATHS[path].items()
                       if k != "snp_group_span"})
    if span is not None:
        cfg.snp_group_span = span
    return cfg


def _path(fixture, out, name):
    return os.path.join(fixture[0], out, "p.%s.vcf.gz" % name if name
                        else "p.vcf.gz")


def _bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


def _match_jax(fixture, port, jax, names):
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
            pytest.fail("%s of %s differs from the JAX CLI's beyond the "
                        "parity bar" % (name, port))
        cases += [dict(d, vcf=name) for d in diffs]
    for d in cases:
        print("parity-bar case (%s):" % port, d)
    assert all(d["field"] in ("QUAL", "PR", "VF", "GQ") for d in cases)
    return cases


_RUNS = {}


def _run_both(fixture, path, cpu):
    """The JAX CLI's and the port's SNP run of a path at a --cpu, once
    per module; returns their output dir names."""
    key = (path, cpu)
    if key not in _RUNS:
        name = "%s_cpu%d" % key
        j_run(_cfg(JConfig, fixture, "jax_" + name, path, cpu))
        run(_cfg(Config, fixture, "port_" + name, path, cpu, device="cpu"))
        _RUNS[key] = ("port_" + name, "jax_" + name)
    return _RUNS[key]


@pytest.mark.parametrize("cpu", [1, 2])
@pytest.mark.parametrize("path", ["dense", "chunk", "span"])
def test_snp_path_matches_jax_cli(fixture, path, cpu):
    port, jax = _run_both(fixture, path, cpu)
    _match_jax(fixture, port, jax, SNP_VCFS)
    data = _bytes(_path(fixture, port, "snps"))
    assert data.count(b"\tPASS\t") >= 40 and b"chrX\t" in data
    # the port's route by path changes no byte of its VCFs
    group, _ = _run_both(fixture, "group", cpu)
    for name in SNP_VCFS:
        assert _bytes(_path(fixture, port, name)) == \
            _bytes(_path(fixture, group, name)), name


def test_all_mode_dense_matches_jax_cli(fixture):
    """--mode all --no_dedup_transfer at --cpu 2: the five VCFs against
    the JAX CLI's with the same flag."""
    j_run(_cfg(JConfig, fixture, "jax_all_dense", "dense", 2, mode="all"))
    out = run(_cfg(Config, fixture, "port_all_dense", "dense", 2,
                   mode="all", device="cpu"))
    _match_jax(fixture, "port_all_dense", "jax_all_dense", VCFS)
    assert out["final"] == _path(fixture, "port_all_dense", "")
    assert _bytes(_path(fixture, "port_all_dense", "snps.phased")) \
        .count(b"|") > 20


def test_chunk_over_caps_on_its_own(fixture, monkeypatch):
    """The read cap lowered under every chunk's decoded reads in both
    packages: every group goes member by member and every member is over
    the caps on its own, so the port sends each as its SnpChunkFeatures
    (the JAX package's fallback); with _TABLE_CELL_CAP lowered too, as
    its dense SnpBatch. Both runs give the JAX package's VCFs and the
    port's uncapped run's bytes."""
    built = []
    real = p_sf.get_snp_group_payloads

    def spy(*a, **k):
        out = real(*a, **k)
        built.extend(out)
        return out

    monkeypatch.setattr(p_sf, "get_snp_group_payloads", spy)
    group, _ = _run_both(fixture, "group", 1)
    for name, table_cap in (("chunk", None), ("dense", 1)):
        for mod in (j_sf, p_sf):
            monkeypatch.setattr(mod, "_GROUP_MAX_READS", 10)
            if table_cap:
                monkeypatch.setattr(mod, "_TABLE_CELL_CAP", table_cap)
        jax_out, port_out = "jax_caps_" + name, "port_caps_" + name
        j_run(_cfg(JConfig, fixture, jax_out, "group", 1))
        built.clear()
        run(_cfg(Config, fixture, port_out, "group", 1, device="cpu"))
        want = p_sf.SnpBatch if table_cap else p_sf.SnpChunkFeatures
        assert len(built) == 2 and all(
            isinstance(p, tuple) and isinstance(p[1], want) for p in built)
        _match_jax(fixture, port_out, jax_out, SNP_VCFS)
        for vcf in SNP_VCFS:
            assert _bytes(_path(fixture, port_out, vcf)) == \
                _bytes(_path(fixture, group, vcf)), vcf


_ISOLATED = r"""
import sys
sys.path.insert(0, %(repo)r)
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.runtime import workers as W
chunks = [{"chrom": "chr1", "start": 1, "end": 30000, "ploidy": "diploid"},
          {"chrom": "chr1", "start": 30000, "end": 60000,
           "ploidy": "diploid"}]
for dedup, group_payload in ((True, False), (False, True)):
    cfg = Config(bam=%(bam)r, ref=%(fasta)r, dedup_transfer=dedup,
                 snp_group_payload=group_payload)
    W.init_worker(%(bam)r, %(fasta)r, W.cfg_kwargs_for_workers(cfg), None)
    _, feats, _ = W.snp_features_worker((0, chunks[0]))
    assert len(feats) > 0
    _, members, _ = W.snp_features_group_worker((0, list(enumerate(chunks))))
    assert [oi for oi, _ in members] == [0, 1]
    assert all(type(f) is type(feats) for _, f in members)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "nanocaller_tpu"))
assert not bad, bad
print("ok")
"""


def test_chunk_workers_never_import_torch(fixture, tmp_path):
    """snp_features_worker and the group worker's per-member branch (both
    payload types) in a fresh interpreter: no torch, no jax."""
    _tmp, fasta_p, bam_p = fixture
    script = _ISOLATED % dict(repo=REPO, bam=bam_p, fasta=fasta_p)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
