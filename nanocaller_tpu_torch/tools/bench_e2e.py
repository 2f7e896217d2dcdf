"""Reproducible end-to-end run: fixture, `--mode all`, accuracy.

One command: a fixed-seed fixture (tools.simulate), a full `--mode all`
run of the port's CLI (`python -m nanocaller_tpu_torch.cli`) in a
subprocess, the per-stage timers from its metrics.json, and
haplotype-aware F1 against the planted truth (tools.vcf_compare --ref).

    python -m nanocaller_tpu_torch.tools.bench_e2e --mb 20 --depth 45 --cpu 2
    python -m nanocaller_tpu_torch.tools.bench_e2e --mb 20 --hp_profile
    python -m nanocaller_tpu_torch.tools.bench_e2e --mb 1 --device cpu

Prints a human-readable table and ONE final JSON line. Accuracy numbers
are deterministic for a given seed; wall times spread with the host's
load. The JAX package's tools/bench_e2e.py with its flags, but
`--device cuda|cpu` (cuda by default) for its `--platform`: the CLI runs
on the card unless asked for the CPU, and `cuda` without a GPU fails as
the CLI does. `--watchdog SECONDS` passes through to the CLI (stall
supervision, runtime/watchdog.py). It writes no benchmark file and sets
no limit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from .real_data_eval import best_row, run_cli
from .simulate import main as sim_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=20, help="fixture Mb")
    ap.add_argument("--contigs", type=int, default=1,
                    help="split the fixture across N contigs (exercises "
                         "the DAG's cross-contig phase/indel overlap)")
    ap.add_argument("--depth", type=int, default=45)
    ap.add_argument("--error_rate", type=float, default=0.04)
    ap.add_argument("--indel_error_rate", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--cpu", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CLI's torch device (cuda without a GPU "
                         "fails)")
    ap.add_argument("--hp_profile", action="store_true")
    ap.add_argument("--workdir", default=None,
                    help="reuse an existing fixture/work directory "
                         "(default: one under the temporary directory)")
    ap.add_argument("--skip_phased_bam", action="store_true")
    ap.add_argument("--watchdog", type=int, default=0,
                    help="pass through to the CLI: supervise the run and "
                         "resume in a fresh process after a stall")
    args = ap.parse_args(argv)

    wd = args.workdir or os.path.join(
        tempfile.gettempdir(), "bench_e2e_%dmb_s%d%s%s" % (
            int(args.mb), args.seed, "_hp" if args.hp_profile else "",
            "_c%d" % args.contigs if args.contigs > 1 else ""))
    os.makedirs(wd, exist_ok=True)
    fixture_args = [
        "--output", wd, "--length", str(int(args.mb * 1e6)),
        "--depth", str(args.depth), "--error_rate", str(args.error_rate),
        "--indel_error_rate", str(args.indel_error_rate),
        "--contigs", str(args.contigs),
        "--seed", str(args.seed)]
    if args.hp_profile:
        fixture_args.append("--hp_profile")
    bam = os.path.join(wd, "reads.bam")
    if not os.path.exists(bam):
        t0 = time.time()
        sim_main(fixture_args)
        print(f"fixture: {time.time()-t0:.1f}s")
    fasta = os.path.join(wd, "ref.fa")
    truth = os.path.join(wd, "truth.vcf.gz")

    out_dir = os.path.join(wd, "out")
    cli = ["--bam", bam, "--ref", fasta, "--mode", "all",
           "--output", out_dir, "--prefix", "v", "--sample", "S",
           "--cpu", str(args.cpu)]
    if args.skip_phased_bam:
        cli.append("--skip_phased_bam")
    if args.watchdog:
        cli += ["--watchdog", str(args.watchdog)]
    wall = run_cli(cli, args.device)

    stages = {}
    counts = {}
    rates = {}
    mpath = os.path.join(out_dir, "metrics.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        stages = {k: round(v, 2) for k, v in m.get("timers_s", {}).items()}
        counts = m.get("counts", {})
        # candidate throughput per stage; the indel stage is the
        # phase_indel_dag wall when the DAG ran (indel features and
        # inference overlap phasing there)
        if counts.get("snp_candidates") and stages.get("snp_calling"):
            rates["snp_sites_per_s"] = round(
                counts["snp_candidates"] / stages["snp_calling"], 1)
        indel_wall = stages.get("indel_calling") or stages.get(
            "phase_indel_dag")
        if counts.get("indel_candidates") and indel_wall:
            rates["indel_sites_per_s"] = round(
                counts["indel_candidates"] / indel_wall, 1)
    calls = os.path.join(out_dir, "v.vcf.gz")
    rows = {"snp": best_row(calls, truth, fasta, "snp"),
            "indel": best_row(calls, truth, fasta, "indel")}
    if args.hp_profile:
        rows["indel_hp"] = best_row(
            calls, truth, fasta, "indel", os.path.join(wd, "hp_regions.bed"))
        rows["indel_nonhp"] = best_row(
            calls, truth, fasta, "indel",
            os.path.join(wd, "nonhp_regions.bed"))

    print(f"\n== bench_e2e {args.mb:g} Mb @{args.depth}x "
          f"({args.device}, cpu={args.cpu}) ==")
    print(f"wall: {wall:.1f}s   stages: {stages}")
    print(f"counts: {counts}   rates: {rates}")
    for name, r in rows.items():
        print(f"{name:>12}: best F1 {r.get('f1', 0):.4f} "
              f"(P={r.get('precision', 0):.4f} R={r.get('recall', 0):.4f} "
              f"@QUAL>={r.get('threshold')})")
    print(json.dumps({
        "mb": args.mb, "contigs": args.contigs, "depth": args.depth,
        "device": args.device,
        "cpu": args.cpu, "seed": args.seed, "hp_profile": args.hp_profile,
        "wall_s": round(wall, 1), "stages": stages,
        "counts": counts, "rates": rates,
        "results": {k: {kk: r.get(kk) for kk in
                        ("f1", "precision", "recall", "threshold")}
                    for k, r in rows.items()},
    }))


if __name__ == "__main__":
    main()
