"""Real-data readiness kit: the validation matrix over one sample.

Given a BAM/CRAM, a truth VCF (e.g. GIAB HG002) and the reference FASTA,
runs the port's CLI (`python -m nanocaller_tpu_torch.cli`) over the
ONT Case Study configurations (NanoCaller's docs/ONT_Case_Study.md:28-68)
and evaluates each with vcf_compare's haplotype-aware matching
(optionally restricted to a GIAB high-confidence BED).

    python -m nanocaller_tpu_torch.tools.real_data_eval \\
        --bam HG002_ont.bam --ref GRCh38.fa \\
        --truth HG002_GRCh38_benchmark.vcf.gz \\
        --truth_bed HG002_GRCh38_benchmark.bed \\
        --out eval_out/ --configs ont_chr22_snps ont_chr22_all

Configs (subset with --configs; default runs the chr22 core set):
  ont_chr22_slice   ONT SNP-only  chr22:20000000-21000000
  ont_chr22_snps    ONT SNP-only  whole chr22 + phasing
  ont_chr22_all     ONT all-mode  whole chr22
  ccs_chr22_all     CCS all-mode  whole chr22
  clr_chr22_snps    CLR SNP-only  whole chr22 (no CLR indel model)
  haploid_chrXYM    --haploid_genome chrY+chrM smoke
  smoke             all-mode over the whole input (synthetic fixtures)

Each config writes <out>/<name>/ with the standard output contract
(PREFIX.snps.vcf.gz etc.) plus eval_<type>.json; a final summary table
and one JSON line aggregate everything. The JAX package's
tools/real_data_eval.py with its flags, but `--device cuda|cpu` (cuda by
default) for its `--platform`: the CLI runs on the card unless asked for
the CPU, and `cuda` without a GPU fails as the CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

from .vcf_compare import main as vc_main

# the directory that holds the nanocaller_tpu_torch package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = {
    "ont_chr22_slice": {
        "mode": "snps", "preset": "ont",
        "regions": "chr22:20000000-21000000", "eval": ["snp"]},
    "ont_chr22_snps": {
        "mode": "snps", "preset": "ont", "regions": "chr22",
        "eval": ["snp"]},
    "ont_chr22_all": {
        "mode": "all", "preset": "ont", "regions": "chr22",
        "eval": ["snp", "indel"]},
    "ccs_chr22_all": {
        "mode": "all", "preset": "ccs", "regions": "chr22",
        "eval": ["snp", "indel"]},
    "clr_chr22_snps": {
        "mode": "snps", "preset": "clr", "regions": "chr22",
        "eval": ["snp"]},
    "haploid_chrXYM": {
        "mode": "snps", "preset": "ont", "regions": "chrY chrM",
        "extra": ["--haploid_genome"], "eval": ["snp"]},
    # whole-input config: no region pin, for synthetic fixtures
    "smoke": {
        "mode": "all", "preset": "ont", "eval": ["snp", "indel"]},
}
DEFAULT = ["ont_chr22_slice", "ont_chr22_snps", "ont_chr22_all"]


def run_cli(cli_args, device):
    """The port's CLI in a subprocess on `device`; returns its wall s.

    A caller that has loaded torch hands the child its intra-op thread
    count (as OMP_NUM_THREADS, unless the environment sets that): a
    caller told to use a few threads must not start a child that takes
    every core. A tool run from a shell has not loaded torch, and its
    child keeps the default pool."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    torch = sys.modules.get("torch")
    if torch is not None and "OMP_NUM_THREADS" not in env:
        env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "nanocaller_tpu_torch.cli",
                    *cli_args, "--device", device], check=True, env=env)
    return time.time() - t0


def best_row(calls, truth, ref, vtype, bed=None):
    """vcf_compare's best-F1 row of calls against truth ({} when none)."""
    argv = ["--calls", calls, "--truth", truth, "--ref", ref,
            "--type", vtype, "--json"]
    if bed:
        argv += ["--bed", bed]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        vc_main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])["best"] or {}


def run_config(name, cfg, args):
    out_dir = os.path.join(args.out, name)
    cli = ["--bam", args.bam, "--ref", args.ref, "--mode", cfg["mode"],
           "--preset", cfg["preset"], "--output", out_dir,
           "--prefix", "v", "--sample", args.sample,
           "--cpu", str(args.cpu)]
    if "regions" in cfg:
        cli += ["--regions"] + cfg["regions"].split()
    cli += cfg.get("extra", [])
    if args.exclude_bed:
        cli += ["--exclude_bed", args.exclude_bed]
    wall = run_cli(cli, args.device)

    results = {}
    calls = os.path.join(
        out_dir, "v.vcf.gz" if cfg["mode"] == "all" else "v.snps.vcf.gz")
    for vtype in cfg["eval"]:
        best = best_row(calls, args.truth, args.ref, vtype, args.truth_bed)
        results[vtype] = best
        with open(os.path.join(out_dir, "eval_%s.json" % vtype), "w") as f:
            json.dump(best or None, f)
    return {"wall_s": round(wall, 1), "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bam", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--truth", required=True,
                    help="GIAB benchmark VCF (e.g. v4.2.1)")
    ap.add_argument("--truth_bed", default=None,
                    help="GIAB high-confidence BED")
    ap.add_argument("--exclude_bed", default=None,
                    help="e.g. hg38 preset (centromere/telomere excl.)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sample", default="HG002")
    ap.add_argument("--cpu", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CLI's torch device (cuda without a GPU "
                         "fails)")
    ap.add_argument("--configs", nargs="*", default=DEFAULT,
                    choices=list(CONFIGS), metavar="CONFIG")
    args = ap.parse_args(argv)

    for p in (args.bam, args.ref, args.truth):
        if not os.path.exists(p):
            sys.exit("missing input: %s" % p)
    os.makedirs(args.out, exist_ok=True)

    summary = {}
    for name in args.configs:
        print(f"== {name} ==", flush=True)
        summary[name] = run_config(name, CONFIGS[name], args)
        for vtype, r in summary[name]["results"].items():
            print(f"  {vtype}: best F1 {r.get('f1')} "
                  f"(P={r.get('precision')} R={r.get('recall')} "
                  f"@QUAL>={r.get('threshold')})  "
                  f"wall {summary[name]['wall_s']}s", flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
