"""Shared by tests/test_torch_flags_*.py: one set of CLI flags through
the JAX CLI and the port's CLI in-process (each package's
config_from_args, then its caller.run, batch_size 128 on both sides to
keep the JAX package's CPU compile short) on the same fixture. The five
VCFs must be byte-identical, or differ only record by record within the
parity bar (chip_smoke.compare_records), each such case printed."""

import gzip
import os

import pytest

import chip_smoke
from nanocaller_tpu import cli as jcli
from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu_torch import cli
from nanocaller_tpu_torch.caller import run

VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")
KIND = {"unfiltered.snps": "snp", "snps": "snp", "snps.phased": "snp",
        "indels": "indel", "": "any"}


def vcf_path(out_dir, name):
    return os.path.join(out_dir, "p.%s.vcf.gz" % name if name
                        else "p.vcf.gz")


def vcf_bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


def run_both(tmp, fasta_p, bam_p, tag, flags):
    """Both CLIs with `flags` on the fixture; returns (the port's Config,
    its output paths, the parity-bar cases)."""
    argv = lambda out: ["--bam", bam_p, "--ref", fasta_p, "--mode", "all",
                        "--output", os.path.join(tmp, out), "--prefix", "p",
                        "--sample", "S", "--suppress_progress_bar", *flags]
    jcfg = jcli.config_from_args(argv("jax_" + tag))
    pcfg = cli.config_from_args(argv("port_" + tag) + ["--device", "cpu"])
    jcfg.batch_size = pcfg.batch_size = 128
    j_run(jcfg)
    outputs = run(pcfg)
    cases = []
    for name in VCFS:
        a = vcf_path(os.path.join(tmp, "port_" + tag), name)
        b = vcf_path(os.path.join(tmp, "jax_" + tag), name)
        if vcf_bytes(a) == vcf_bytes(b):
            continue
        try:
            _, diffs = chip_smoke.compare_records(a, b, KIND[name])
        except SystemExit:
            pytest.fail("%s %s differs from the JAX CLI's beyond the parity "
                        "bar" % (tag, name))
        cases += [dict(d, vcf=name) for d in diffs]
    for d in cases:
        print("parity-bar case (%s):" % tag, d)
    # only probability-printed fields may differ, as rounding cases
    assert all(d["field"] in ("QUAL", "PR", "VF", "GQ") for d in cases)
    return pcfg, outputs, cases


def records(path):
    """(contig, 1-based pos) of every record of a VCF."""
    return [(f[0].decode(), int(f[1])) for f in
            (l.split(b"\t") for l in vcf_bytes(path).splitlines()
             if l and not l.startswith(b"#"))]
