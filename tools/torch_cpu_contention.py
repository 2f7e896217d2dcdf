#!/usr/bin/env python3
"""The port's CPU twins of K1/K2/K4, and its CLI on `--device cpu`, on an
idle host and on a host whose cores other processes hold.

    python3 tools/torch_cpu_contention.py twin [--trees DIR ...] \\
        [--busy 0 6] [--rounds 3] [--setting default \\
        --setting OMP_WAIT_POLICY=PASSIVE,OMP_NUM_THREADS=4 ...]
    python3 tools/torch_cpu_contention.py bench [--trees DIR ...] \\
        [--busy 0 6] [--rounds 3] --bench "--mb 0.06 --cpu 1" \\
        [--fixture "--length 60000 --depth 30 --read_len 3000 \\
                    --error_rate 0.02 --indel_error_rate 0.002 --seed 7"]

Each TREE is a checkout of the repo (the default: this one), so that two
versions run in turns on one host: round r runs the trees in the given
order when r is even and in reverse when it is odd (A, B, B, A, ...).
For each count in --busy the script first starts that many busy-loop
processes (one `while True: pass` each; none for 0) and stops them after
the count's rounds. Every measurement runs in a fresh child process with
the tree on its PYTHONPATH and the setting's variables in its
environment (every OMP_*, GOMP_* and KMP_* variable of the script's own
environment is dropped, so "default" is what the tree itself chooses):

- `twin`: the child imports nanocaller_tpu_torch before torch, as the
  port's entry points do, then times nw_tb_reference, nw_walk_reference
  and nw_cigar_reference on random pairs at (Q, R) with B pairs (by
  default (192,192) B = 1024, an indel MSA launch; half the pairs a read
  window against its mutated ref window) after one small warm-up call,
  `--reps` times each, and reports the median seconds of each twin with
  the intra-op thread count, the wait policy and os.cpu_count().
- `bench`: the child is `python -m nanocaller_tpu_torch.tools.bench_e2e
  --device cpu --workdir W BENCH`, W one work directory per --bench
  string (the fixture is made once, by the first run's tree: with
  --fixture by nanocaller_tpu_torch.tools.simulate, else by bench_e2e's
  own defaults; one run a tree before the rounds is not counted, so
  that no counted run builds a tree's native library); it reports the CLI's wall (bench_e2e's `wall_s`), the
  child's wall and the `indel.*` stage timers, and the sha256 of the
  five decompressed VCFs, so that two trees' calls can be compared.

Prints one JSON line a measurement, then one JSON line a (busy, tree,
setting) with the medians, for `bench` the count of distinct VCF digest
sets over all counted runs (1: every tree wrote the same bytes), then
the nvidia-smi line where there is one.
`--json FILE` also writes every line to FILE.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VCFS = ("v.unfiltered.snps.vcf.gz", "v.snps.vcf.gz", "v.snps.phased.vcf.gz",
        "v.indels.vcf.gz", "v.vcf.gz")
# the threading variables a child takes only from its setting
DROP = ("OMP_", "GOMP_", "KMP_")

TWIN_CHILD = r"""
import json, os, statistics, sys, time
import nanocaller_tpu_torch  # first, as the port's entry points import it
import numpy as np
import torch
from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.align.batch_nw import encode_pairs, pad_bytes

Q, R, B, reps, seed = (int(a) for a in sys.argv[1:6])
rng = np.random.default_rng(seed)


def mutate(seq):
    out = []
    for c in seq:
        u = rng.random()
        if u < 0.05:
            out.append("ACGT"[rng.integers(0, 4)])
        elif u < 0.075:
            continue
        elif u < 0.1:
            out.append(c + "ACGT"[rng.integers(0, 4)])
        else:
            out.append(c)
    return "".join(out)


def inputs(b):
    pairs = []
    for k in range(b):
        n = int(rng.integers(max(1, R - 40), R + 1))
        ref = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
        qry = (mutate(ref) if k % 2 else
               "".join("ACGT"[x] for x in rng.integers(0, 4, n)))[:Q]
        pairs.append((qry or "A", ref))
    q, r, ql, rl = encode_pairs(pairs, Q, R)
    qraw = pad_bytes([a for a, _ in pairs], Q)[0]
    rraw = pad_bytes([c for _, c in pairs], R)[0]
    return (torch.from_numpy(np.ascontiguousarray(q)),
            torch.from_numpy(np.ascontiguousarray(r)),
            torch.from_numpy(ql.astype(np.int32)),
            torch.from_numpy(rl.astype(np.int32)),
            torch.from_numpy(qraw), torch.from_numpy(rraw))


def run(args):
    q, r, ql, rl, qraw, rraw = args
    times = []
    t0 = time.perf_counter()
    tb = K.nw_tb(q, r, 20, -10, 9, 1)  # BatchAligner's scoring
    times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ops = K.nw_walk(tb, ql, rl, 2 * (Q + R) + 2)
    times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    K.nw_cigar(ops, qraw, rraw)
    times.append(time.perf_counter() - t0)
    return times


run(inputs(8))
args = inputs(B)
rows = [run(args) for _ in range(reps)]
par = torch.__config__.parallel_info().splitlines()
print(json.dumps({
    "nw_tb_s": statistics.median(t[0] for t in rows),
    "nw_walk_s": statistics.median(t[1] for t in rows),
    "nw_cigar_s": statistics.median(t[2] for t in rows),
    "nw_tb_all_s": [t[0] for t in rows],
    "threads": torch.get_num_threads(),
    "wait_policy": os.environ.get("OMP_WAIT_POLICY"),
    "cpu_count": os.cpu_count(),
    "openmp": [ln.strip() for ln in par if "OpenMP" in ln or
               "parallel backend" in ln],
}))
"""


def child_env(tree, setting):
    env = {k: v for k, v in os.environ.items() if not k.startswith(DROP)}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [tree, os.environ.get("PYTHONPATH", "")] if p)
    if setting != "default":
        for kv in setting.split(","):
            k, v = kv.split("=", 1)
            env[k] = v
    return env


def start_busy(n):
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(n)]


def stop_busy(procs):
    for p in procs:
        p.kill()
    for p in procs:
        p.wait()


def vcf_digests(out_dir):
    dig = {}
    for name in VCFS:
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            with gzip.open(path, "rb") as fh:
                dig[name] = hashlib.sha256(fh.read()).hexdigest()[:16]
    return dig


def measure_twin(tree, setting, a):
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-c", TWIN_CHILD, str(a.q), str(a.r), str(a.b),
         str(a.reps), str(a.seed)], env=child_env(tree, setting), cwd=tree,
        capture_output=True, text=True, timeout=a.child_timeout)
    if res.returncode != 0:
        raise RuntimeError("twin child failed (rc %d):\n%s"
                           % (res.returncode, res.stderr[-3000:]))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["child_wall_s"] = time.time() - t0
    return out


def measure_bench(tree, setting, a, wd):
    os.makedirs(wd, exist_ok=True)
    if a.fixture and not os.path.exists(os.path.join(wd, "reads.bam")):
        subprocess.run([sys.executable, "-m",
                        "nanocaller_tpu_torch.tools.simulate", "--output",
                        wd, *a.fixture.split()], check=True, cwd=tree,
                       env=child_env(tree, setting), capture_output=True)
    shutil.rmtree(os.path.join(wd, "out"), ignore_errors=True)
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "nanocaller_tpu_torch.tools.bench_e2e",
         "--device", "cpu", "--workdir", wd, *a.bench.split()],
        env=child_env(tree, setting), cwd=tree, capture_output=True,
        text=True, timeout=a.child_timeout)
    wall = time.time() - t0
    if res.returncode != 0:
        raise RuntimeError("bench child failed (rc %d):\n%s"
                           % (res.returncode, res.stderr[-3000:]))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    return {"cli_wall_s": out["wall_s"], "child_wall_s": wall,
            "stages": {k: v for k, v in out["stages"].items()
                       if k.startswith("indel")},
            "f1_snp": out["results"]["snp"].get("f1"),
            "vcf_sha256": vcf_digests(os.path.join(wd, "out"))}


def smi_line():
    if shutil.which("nvidia-smi") is None:
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return res.stdout.strip() or None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["twin", "bench"])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--busy", type=int, nargs="+", default=[0, 6])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--setting", action="append", default=None,
                    help="'default' or NAME=VALUE[,NAME=VALUE...]; "
                         "repeatable (default: default)")
    ap.add_argument("--q", type=int, default=192)
    ap.add_argument("--r", type=int, default=192)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--bench", default="--mb 0.06 --cpu 1",
                    help="bench_e2e's arguments besides --device and "
                         "--workdir")
    ap.add_argument("--fixture", default=None,
                    help="tools.simulate's arguments besides --output")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--child_timeout", type=float, default=600)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    settings = a.setting or ["default"]
    trees = [os.path.abspath(t) for t in a.trees]
    work = a.workdir or tempfile.mkdtemp(prefix="cpu_contention_")
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    runs = {}
    if a.what == "bench":
        # one run a tree first, not counted: it makes the fixture and
        # builds each tree's native library
        for tree in trees:
            emit({"warmup": True, "tree": tree, **measure_bench(
                tree, settings[0], a, os.path.join(work, "bench"))})
    for busy in a.busy:
        procs = start_busy(busy)
        try:
            time.sleep(1.0 if busy else 0.0)
            for rnd in range(a.rounds):
                order = trees if rnd % 2 == 0 else trees[::-1]
                for tree in order:
                    for setting in settings:
                        if a.what == "twin":
                            m = measure_twin(tree, setting, a)
                        else:
                            m = measure_bench(tree, setting, a,
                                              os.path.join(work, "bench"))
                        row = {"busy": busy, "round": rnd, "tree": tree,
                               "setting": setting, **m}
                        runs.setdefault((busy, tree, setting), []).append(row)
                        emit(row)
        finally:
            stop_busy(procs)
    keys = (["nw_tb_s", "nw_walk_s", "nw_cigar_s", "child_wall_s"]
            if a.what == "twin" else ["cli_wall_s", "child_wall_s"])
    for (busy, tree, setting), rows in runs.items():
        med = {k: statistics.median(r[k] for r in rows) for k in keys}
        if a.what == "bench":
            stages = sorted({s for r in rows for s in r["stages"]})
            med.update({s: statistics.median(r["stages"].get(s, 0.0)
                                             for r in rows) for s in stages})
            med["vcf_sha256_sets"] = len({json.dumps(r["vcf_sha256"],
                                                     sort_keys=True)
                                          for r in rows})
        extra = {k: rows[0][k] for k in ("threads", "wait_policy",
                                          "cpu_count") if k in rows[0]}
        emit({"summary": True, "busy": busy, "tree": tree,
              "setting": setting, "n": len(rows), **extra, "median": med})
    if a.what == "bench":
        # 1 when every run of every tree wrote the same five VCFs
        emit({"vcf_sha256_distinct": len({
            json.dumps(r["vcf_sha256"], sort_keys=True)
            for rows in runs.values() for r in rows})})
    emit({"smi": smi_line(), "python": sys.version.split()[0]})
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as fh:
            for obj in lines:
                fh.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
