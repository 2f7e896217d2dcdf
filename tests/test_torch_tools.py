"""The port's user tools (nanocaller_tpu_torch.tools) against the JAX
package's tools/*.py on the same inputs: vcf_compare's metrics (the
cases of tests/test_tools.py, and the calls of a bench_e2e run) equal,
ensemble's VCF byte-equal, snp_readnames' text equal; and the port's
real_data_eval (`--configs smoke`) and bench_e2e on the CPU, with the
keys tests/test_readiness_kit.py asserts of the JAX tools and SNP
F1 > 0.5; `--device cuda` without a GPU fails as the CLI does."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from nanocaller_tpu_torch.io.fasta import write_fasta
from nanocaller_tpu_torch.io.vcf import VcfRecord, VcfWriter
from nanocaller_tpu_torch.tools import bench_e2e as p_bench
from nanocaller_tpu_torch.tools import ensemble as p_ensemble
from nanocaller_tpu_torch.tools import real_data_eval as p_eval
from nanocaller_tpu_torch.tools import snp_readnames as p_readnames
from nanocaller_tpu_torch.tools import vcf_compare as p_vc
from nanocaller_tpu_torch.tools.simulate import main as p_simulate

from torch_threads import _torch_threads  # noqa: F401 (autouse)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import ensemble as j_ensemble  # noqa: E402
import snp_readnames as j_readnames  # noqa: E402
import vcf_compare as j_vc  # noqa: E402

HDR = ["##fileformat=VCFv4.2", "##contig=<ID=c1>",
       '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
# tests/test_tools.py's haplotype-aware cases run on this contig
REF_C1 = ("ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"
          "TTTTCCCCGGGGAAAATTTTCCCCGGGGAAAATTTTCCCC")
# name → (truth rows, call rows, --ref, --type); a row is (pos, ref, alt,
# qual, gt)
VC_CASES = {
    "metrics": ([(100, "A", "T", 50, "0/1"), (200, "C", "G", 50, "1/1"),
                 (300, "G", "A", 50, "0/1")],
                [(100, "A", "T", 30, "0/1"), (200, "C", "G", 20, "0/1"),
                 (400, "T", "C", 10, "0/1")], False, "all"),
    "type_filter": ([(100, "A", "AT", 50, "0/1")],
                    [(100, "A", "AT", 30, "0/1"), (150, "G", "C", 30, "0/1")],
                    False, "indel"),
    "mnp_vs_two_snps": ([(9, "AC", "TG", 50, "1|0")],
                        [(9, "A", "T", 30, "0/1"), (10, "C", "G", 28, "0/1")],
                        True, "all"),
    "mnp_vs_two_snps_no_ref": ([(9, "AC", "TG", 50, "1|0")],
                               [(9, "A", "T", 30, "0/1"),
                                (10, "C", "G", 28, "0/1")], False, "all"),
    "joined_vs_split": ([(9, "AC", "TG", 50, "1|1")],
                        [(9, "A", "T", 30, "0/1"), (10, "C", "G", 28, "0/1")],
                        True, "all"),
    "indel_anchor_shift": ([(41, "TTT", "T", 50, "0/1")],
                           [(43, "TTC", "C", 30, "0/1")], True, "all"),
    "multiallelic": ([(21, "G", "A,C", 50, "1|2")],
                     [(21, "G", "A", 30, "0|1"), (21, "G", "C", 25, "1|0")],
                     True, "all"),
    "zygosity_mismatch": ([(9, "A", "T", 50, "1/1")],
                          [(9, "A", "T", 30, "0/1")], True, "all"),
    "support_from_weakest": ([(9, "AC", "TG", 50, "1|0")],
                             [(9, "A", "T", 30, "0/1"),
                              (10, "C", "G", 5, "0/1")], True, "snp"),
}


def write_vcf(path, rows):
    with VcfWriter(path, HDR) as w:
        for pos, ref, alt, qual, gt in rows:
            w.write(VcfRecord("c1", pos, ref, alt, str(qual), "PASS",
                              format_="GT", samples=[gt]))
    return path


def _run(main, argv):
    """main(argv)'s return value and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


@pytest.fixture(scope="module")
def sim_fixture(tmp_path_factory):
    """tests/test_readiness_kit.py's fixture, by the port's simulate."""
    wd = str(tmp_path_factory.mktemp("port_kit"))
    p_simulate(["--output", wd, "--length", "60000", "--depth", "30",
                "--read_len", "3000", "--error_rate", "0.02",
                "--indel_error_rate", "0.002", "--seed", "7"])
    return wd


@pytest.mark.parametrize("case", list(VC_CASES))
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "table"])
def test_vcf_compare_equal(tmp_path, case, as_json):
    truth_rows, call_rows, with_ref, vtype = VC_CASES[case]
    argv = ["--calls", write_vcf(str(tmp_path / "c.vcf.gz"), call_rows),
            "--truth", write_vcf(str(tmp_path / "t.vcf.gz"), truth_rows),
            "--type", vtype]
    if with_ref:
        write_fasta(str(tmp_path / "ref.fa"), {"c1": REF_C1})
        argv += ["--ref", str(tmp_path / "ref.fa")]
    if as_json:
        argv.append("--json")
    want = _run(j_vc.main, argv)
    assert _run(p_vc.main, argv) == want
    assert want[0] is not None


def test_vcf_compare_support_and_thresholds(tmp_path):
    """The truth side's support (the weakest supporting call's QUAL) and
    the rows at given thresholds, through the modules' functions."""
    truth_rows, call_rows, _, _ = VC_CASES["support_from_weakest"]
    t = write_vcf(str(tmp_path / "t.vcf.gz"), truth_rows)
    c = write_vcf(str(tmp_path / "c.vcf.gz"), call_rows)
    write_fasta(str(tmp_path / "ref.fa"), {"c1": REF_C1})
    out = []
    for vc, fasta in ((j_vc, "nanocaller_tpu.io.fasta"),
                      (p_vc, "nanocaller_tpu_torch.io.fasta")):
        fa = __import__(fasta, fromlist=["FastaFile"]).FastaFile(
            str(tmp_path / "ref.fa"))
        cv, tv = vc.load_variants(c), vc.load_variants(t)
        vc.match_variants(cv, tv, fa)
        out.append(([v.support for v in tv], [v.matched for v in cv],
                    vc.evaluate(cv, tv, thresholds=[0.0, 10.0])))
    assert out[1] == out[0]
    assert out[1][0] == [5.0]


@pytest.mark.parametrize("min_votes", [None, "1", "3"])
def test_ensemble_byte_equal(tmp_path, min_votes):
    a = write_vcf(str(tmp_path / "a.vcf.gz"),
                  [(100, "A", "T", 40, "0/1"), (200, "C", "G", 10, "1/1")])
    b = write_vcf(str(tmp_path / "b.vcf.gz"),
                  [(100, "A", "T", 35, "0/1"), (300, "G", "A", 20, "0/1"),
                   (400, "T", "C,G", 25, "1/2")])
    c = write_vcf(str(tmp_path / "c.vcf.gz"),
                  [(100, "A", "T", 99, "0/1"), (200, "C", "G", 30, "1/1"),
                   (400, "T", "G", 12, "0|1")])
    outs = []
    for name, mod in (("jax", j_ensemble), ("port", p_ensemble)):
        out = str(tmp_path / ("%s.vcf.gz" % name))
        argv = [a, b, c, "--out", out, "--sample", "E"]
        if min_votes:
            argv += ["--min_votes", min_votes]
        _run(mod.main, argv)
        with open(out, "rb") as fh:
            outs.append(fh.read())
    assert outs[1] == outs[0]


def test_snp_readnames_equal(sim_fixture, tmp_path):
    """Every SNP of the fixture's truth VCF (its indels are skipped)."""
    argv = ["--vcf", os.path.join(sim_fixture, "truth.vcf.gz"),
            "--bam", os.path.join(sim_fixture, "reads.bam")]
    texts = []
    for name, mod in (("jax", j_readnames), ("port", p_readnames)):
        out = str(tmp_path / ("%s.txt" % name))
        mod.main(argv + ["--output", out])
        with open(out) as fh:
            texts.append(fh.read())
    assert texts[1] == texts[0]
    lines = texts[1].splitlines()
    assert len(lines) > 50
    # each SNP has reads behind one of its alleles at least
    assert all(any(len(a.split(":")[1]) for a in l.split("\t")[2:])
               for l in lines)


def _last_json(text):
    return json.loads([l for l in text.splitlines() if l.strip()][-1])


def test_bench_e2e_smoke(sim_fixture):
    _, text = _run(p_bench.main, ["--workdir", sim_fixture, "--mb", "0.06",
                                  "--cpu", "1", "--device", "cpu"])
    out = _last_json(text)
    assert out["device"] == "cpu" and out["wall_s"] > 0
    assert "snp_calling" in out["stages"]
    assert out["counts"].get("snp_candidates", 0) > 0
    assert out["rates"].get("snp_sites_per_s", 0) > 0
    assert out["counts"].get("indel_candidates", 0) > 0
    assert out["results"]["snp"]["f1"] is not None
    assert out["results"]["snp"]["f1"] > 0.5
    # the run's calls, scored by both packages' vcf_compare
    for vtype in ("snp", "indel"):
        argv = ["--calls", os.path.join(sim_fixture, "out", "v.vcf.gz"),
                "--truth", os.path.join(sim_fixture, "truth.vcf.gz"),
                "--ref", os.path.join(sim_fixture, "ref.fa"),
                "--type", vtype, "--json"]
        assert _run(p_vc.main, argv) == _run(j_vc.main, argv)


def test_real_data_eval_smoke(sim_fixture, tmp_path):
    out_dir = str(tmp_path / "eval")
    _, text = _run(p_eval.main, [
        "--bam", os.path.join(sim_fixture, "reads.bam"),
        "--ref", os.path.join(sim_fixture, "ref.fa"),
        "--truth", os.path.join(sim_fixture, "truth.vcf.gz"),
        "--out", out_dir, "--sample", "S", "--cpu", "1",
        "--device", "cpu", "--configs", "smoke"])
    out = _last_json(text)
    assert "smoke" in out
    res = out["smoke"]["results"]
    assert "snp" in res and "indel" in res
    assert res["snp"].get("f1", 0) > 0.5
    assert os.path.exists(os.path.join(out_dir, "smoke", "v.vcf.gz"))
    with open(os.path.join(out_dir, "smoke", "eval_snp.json")) as fh:
        assert json.load(fh) == res["snp"]


@pytest.mark.parametrize("tool", ["real_data_eval", "bench_e2e"])
def test_cuda_without_gpu_fails(sim_fixture, tmp_path, tool):
    """The default device is cuda; without a GPU the CLI's subprocess
    raises, and so does the tool."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    if tool == "real_data_eval":
        main, argv = p_eval.main, [
            "--bam", os.path.join(sim_fixture, "reads.bam"),
            "--ref", os.path.join(sim_fixture, "ref.fa"),
            "--truth", os.path.join(sim_fixture, "truth.vcf.gz"),
            "--out", str(tmp_path / "eval"), "--configs", "smoke"]
    else:
        main, argv = p_bench.main, ["--workdir", sim_fixture, "--mb", "0.06"]
    with pytest.raises(subprocess.CalledProcessError):
        _run(main, argv)
