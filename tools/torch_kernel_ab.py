#!/usr/bin/env python3
"""K4 nw_cigar and K5 snp_dense_pileup of this checkout against an
earlier version of their two sources, on one GPU.

    python3 tools/torch_kernel_ab.py OLD_CSRC [--reps 10] [--json FILE]

OLD_CSRC is a directory holding the earlier nw_cigar.cu and
snp_dense_pileup.cu (for example `git archive <commit>
nanocaller_tpu_torch/csrc | tar -x -C DIR`). The script builds each of
the four sources into a library of its own with nvcc (the port's flags,
-Xptxas -v, whose register, shared-memory and spill lines it prints),
all four at once, then for each shape below holds both versions exactly
against the plain twin (nw_cigar_reference, snp_dense_pileup_reference)
and times them in turns, old, new, new, old (CUDA events over `reps`
calls behind a spin, chip_smoke.cuda_ms). It prints one JSON line a
shape with both times, the bound (chip_smoke's byte and operation
counts) and the share of it, then the launch floor (a one-cycle spin
kernel timed the same way), then the nvidia-smi line. It exits non-zero
without a GPU or when either version differs from the twin.

K4's shapes: K2's op streams (K1 then K2 of this checkout) on
chip_smoke.nw_inputs at (192,192), (256,192), (256,320) and (512,512)
with B = 1024 (msa scoring) and at chip_smoke.MAIN_LAUNCHES, then the
hand-built edge inputs (sim.cigar_edge_case). K5's: random dense batches
(sim.random_dense_batch) at B = 625, R = 45 (the shape of the
--no_dedup_transfer run's largest batch), B = 4096 at R = 160 and 64,
B = 496 at R = 160 and 48, then the edge inputs (sim.dense_edge_case).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("nw_cigar", "snp_dense_pileup")
K4_BUCKETS = [(192, 192), (256, 192), (256, 320), (512, 512)]
K5_SHAPES = [(625, 45), (4096, 160), (4096, 64), (496, 160), (496, 48)]


def build(sources, out_dir):
    """{(version, name): library path}, one nvcc a source, all started
    together; prints each one's ptxas lines."""
    from nanocaller_tpu_torch.runtime import kernels

    nvcc = kernels._nvcc()
    procs = {}
    for key, src in sources.items():
        lib = os.path.join(out_dir, "%s_%s.so" % key)
        procs[key] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (lib, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (sources[key], out))
        ptxas = [l.strip() for l in out.splitlines()
                 if "ptxas" in l or "stack frame" in l]
        print(json.dumps({"build": "%s %s" % key, "ptxas": ptxas}),
              flush=True)
        libs[key] = lib
    return libs


def load(path, name):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name + "_launch")
    fn.argtypes = ([p] * 5 + [i] * 4 + [p] if name == "nw_cigar"
                   else [p] * 6 + [i, i] + [p] * 3)
    fn.restype = i
    return lib, fn


def cigar_call(fn, ops, qr, rr):
    import torch

    B, T = ops.shape
    Q, R = qr.shape[1], rr.shape[1]
    runs = torch.empty((B, Q + R), dtype=torch.int32, device=ops.device)
    counts = torch.empty(B, dtype=torch.int32, device=ops.device)
    rc = fn(ops.data_ptr(), qr.data_ptr(), rr.data_ptr(), runs.data_ptr(),
            counts.data_ptr(), B, T, Q, R,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("nw_cigar launch failed: cudaError %d" % rc)
    return runs, counts


def dense_call(fn, args):
    import torch

    B, R = args[1].shape
    x = torch.empty((B, 5, 41, 5), dtype=torch.float32, device="cuda")
    ref = torch.empty((B, 4), dtype=torch.float32, device="cuda")
    rc = fn(*(a.data_ptr() for a in args), B, R, x.data_ptr(),
            ref.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("snp_dense_pileup launch failed: cudaError %d"
                           % rc)
    return x, ref


def cigar_diff(got, want):
    """None where K4's output equals the twin's (counts, and each row's
    first counts[b] runs), else the first row that differs."""
    import torch

    runs, counts = got
    w_runs, w_counts = want
    Q_R = runs.shape[1]
    keep = torch.arange(Q_R, device=runs.device)[None, :] < \
        counts.clamp(min=0)[:, None]
    row_bad = (counts != w_counts) | (torch.where(keep, runs, 0) !=
                                      torch.where(keep, w_runs, 0)).any(1)
    if not bool(row_bad.any()):
        return None
    b = int(row_bad.nonzero()[0, 0])
    n = max(int(counts[b]), int(w_counts[b]), 0)
    return {"row": b, "count": int(counts[b]), "twin_count":
            int(w_counts[b]), "runs": runs[b, :min(n, 12)].tolist(),
            "twin_runs": w_runs[b, :min(n, 12)].tolist()}


def dense_diff(got, want):
    import torch

    for name, g, w in zip(("x", "ref"), got, want):
        if not torch.equal(g, w):
            b = int((g != w).reshape(len(g), -1).any(1).nonzero()[0, 0])
            return {"output": name, "row": b,
                    "max_abs_err": float((g - w).abs().max())}
    return None


def in_turns(S, old, new, reps):
    """old, new, new, old: each version's two times and their mean."""
    a1 = S.cuda_ms(old, reps)
    b1 = S.cuda_ms(new, reps)
    b2 = S.cuda_ms(new, reps)
    a2 = S.cuda_ms(old, reps)
    return {"old_ms": (a1 + a2) / 2, "new_ms": (b1 + b2) / 2,
            "old_ms_each": [a1, a2], "new_ms_each": [b1, b2]}


def k4_cases(S, K, rng):
    """(label, ops, qraw, rraw) on the card: K2's streams, then the edge
    inputs."""
    import torch

    from nanocaller_tpu_torch.sim import CIGAR_EDGE_LABELS, cigar_edge_case

    shapes = [("bucket", Q, R, S.B_NW, "msa") for Q, R in K4_BUCKETS] + \
        [("main_path", Q, R, B, s) for Q, R, B, s in S.MAIN_LAUNCHES]
    for label, Q, R, B, sname in shapes:
        q, r, ql, rl, qraw, rraw = S.nw_inputs(rng, B, Q, R)
        tb = K.nw_tb(torch.from_numpy(q).cuda(), torch.from_numpy(r).cuda(),
                     *S.SCORINGS[sname])
        ops = K.nw_walk(tb, torch.from_numpy(ql), torch.from_numpy(rl),
                        2 * (Q + R) + 2)
        del tb
        yield ("%s %dx%d B=%d %s" % (label, Q, R, B, sname), ops,
               torch.from_numpy(qraw).cuda(), torch.from_numpy(rraw).cuda())
    for label in CIGAR_EDGE_LABELS:
        yield ("edge " + label,) + tuple(
            torch.from_numpy(a).cuda() for a in cigar_edge_case(label))


def k5_cases(rng):
    import torch

    from nanocaller_tpu_torch.sim import (DENSE_EDGE_LABELS, dense_edge_case,
                                          random_dense_batch)

    for B, R in K5_SHAPES:
        yield ("random_dense B=%d R=%d" % (B, R),
               [torch.from_numpy(a).cuda()
                for a in random_dense_batch(rng, B, R)])
    for label in DENSE_EDGE_LABELS:
        yield ("edge " + label,
               [torch.from_numpy(a).cuda() for a in dense_edge_case(label)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as S
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.pileup import snp_dense as K5
    from nanocaller_tpu_torch.runtime import kernels

    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    sources = {}
    for name in NAMES:
        sources["old", name] = os.path.join(os.path.abspath(args.old_csrc),
                                            name + ".cu")
        sources["new", name] = os.path.join(HERE, "nanocaller_tpu_torch",
                                            "csrc", name + ".cu")
    ok = True
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        libs = {key: load(path, key[1])
                for key, path in build(sources, tmp).items()}
        kernels.build()
        rng = np.random.default_rng(12)
        with torch.inference_mode():
            for label, ops, qr, rr in k4_cases(S, K, rng):
                want = K.nw_cigar_reference(ops, qr, rr)
                row = {"kernel": "K4_nw_cigar", "inputs": label,
                       "B": ops.shape[0], "T": ops.shape[1],
                       "Q": qr.shape[1], "R": rr.shape[1]}
                for v in ("old", "new"):
                    d = cigar_diff(cigar_call(libs[v, "nw_cigar"][1], ops,
                                              qr, rr), want)
                    row[v + "_exact"] = d is None
                    if d is not None:
                        row[v + "_diff"] = d
                        ok = False
                if label.startswith(("bucket", "main_path")):
                    B, T = ops.shape
                    Q, R = qr.shape[1], rr.shape[1]
                    n_runs = int(want[1].clamp(min=0).sum())
                    nz = int((ops != 0).sum())
                    row.update(in_turns(
                        S, lambda: cigar_call(libs["old", "nw_cigar"][1],
                                              ops, qr, rr),
                        lambda: cigar_call(libs["new", "nw_cigar"][1], ops,
                                           qr, rr), args.reps))
                    row.update(S.bound(B * T + B * (Q + R) + 4 * (n_runs + B),
                                       B * T * S.K4_OPS_PER_BYTE
                                       + nz * S.K4_OPS_PER_OP))
                    row["plain_ms"] = S.cuda_ms(
                        lambda: K.nw_cigar_reference(ops, qr, rr), 1)
                    row["runs"] = n_runs
                    row["share_of_bound"] = row["bound_ms"] / row["new_ms"]
                emit(row)
                del ops, qr, rr, want
            for label, dargs in k5_cases(rng):
                want = K5.snp_dense_pileup_reference(*dargs)
                B, R = dargs[1].shape
                row = {"kernel": "K5_snp_dense_pileup", "inputs": label,
                       "B": B, "R": R}
                for v in ("old", "new"):
                    d = dense_diff(dense_call(libs[v, "snp_dense_pileup"][1],
                                              dargs), want)
                    row[v + "_exact"] = d is None
                    if d is not None:
                        row[v + "_diff"] = d
                        ok = False
                if label.startswith("random_dense"):
                    row.update(in_turns(
                        S, lambda: dense_call(
                            libs["old", "snp_dense_pileup"][1], dargs),
                        lambda: dense_call(
                            libs["new", "snp_dense_pileup"][1], dargs),
                        args.reps))
                    nbytes, ops_n, _, _ = S.k5_work(dargs)
                    row.update(S.bound(nbytes, ops_n))
                    row["plain_ms"] = S.cuda_ms(
                        lambda: K5.snp_dense_pileup_reference(*dargs), 1)
                    row["share_of_bound"] = row["bound_ms"] / row["new_ms"]
                emit(row)
                del dargs, want
        emit({"launch_floor_ms": S.cuda_ms(lambda: torch.cuda._sleep(1),
                                           args.reps)})
    smi = S._smi_line()
    print(smi, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            for obj in lines + [{"nvidia_smi": smi}]:
                fh.write(json.dumps(obj) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
