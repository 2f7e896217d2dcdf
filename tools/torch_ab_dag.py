#!/usr/bin/env python3
"""The main path of two checkouts of the port on one GPU, in turns.

    python3 tools/torch_ab_dag.py PARENT_DIR [CHANGE_DIR] [--pairs N]

Runs chip_smoke.py's phase 12 (`--mode all --cpu N` on three contigs:
cuda --cpu 1, cuda --cpu N twice, cpu --cpu N, and a profiled cuda
--cpu N run) of each checkout in a fresh process, in the order parent,
change, change, parent (N pairs of that order; CHANGE_DIR defaults to
the checkout this script is in), so that both are measured on the same
card and host. Each checkout builds its own kernels into its own
`_build/`. Prints, per run, one JSON line with the checkout, the walls
and the timers that phase 12 reports, then the nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = """
import sys, tempfile
sys.path.insert(0, %r)
import chip_smoke as S
with tempfile.TemporaryDirectory(prefix="ab_dag_") as tmp:
    S.phase_dag(tmp)
"""

KEYS = ("phase_indel_dag", "indel.align_finish", "indel.features_core",
        "indel.features", "snp_calling", "phasing")


def run_phase12(tree):
    """phase 12 of `tree`'s chip_smoke.py in a fresh process; returns its
    JSON lines by phase name."""
    out = subprocess.run([sys.executable, "-c", RUN % tree], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit("phase 12 of %s failed (%d)" % (tree,
                                                         out.returncode))
    rows = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            rows[d.get("phase")] = d
    return rows


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=here)
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    for name in ["parent", "change", "change", "parent"] * args.pairs:
        rows = run_phase12(trees[name])
        dag, prof = rows["dag"], rows.get("dag_profile", {})
        print(json.dumps({
            "tree": name, "walls_s": dag["walls_s"],
            "timers_s": {run: {k: t[k] for k in KEYS if k in t}
                         for run, t in dag["timers_s"].items()},
            "profiled_wall_s": prof.get("wall_s"),
            "device_busy_s": prof.get("device_busy_s"),
            "device_idle_share": prof.get("device_idle_share")}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
