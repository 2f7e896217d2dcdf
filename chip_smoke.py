#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (nanocaller_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per case:

1. the card (nvidia-smi name and power limit), the nvcc build of the
   kernels from the sources in this checkout (one nvcc per source, all
   started together) and the g++ build of the native host library
   (io/native/ncio.cpp);
2. K1 nw_tb against its plain twin, exactly equal, with kernel, twin
   and bound times: at the buckets (192,192), (256,192), (512,512) with
   B = 1024 and both scoring sets; at the main path's launch shapes
   (MAIN_LAUNCHES); on tie-heavy pairs (homopolymer runs, tandem repeats
   with a unit inserted or deleted, identical sequences) at both scorings;
3. K2 nw_walk against its plain twin on each of those tracebacks,
   exactly equal, timed right after a K1 launch (warm L2, as the main
   path finds it), with the longest walk's step count;
4. the indel CNNs (diploid and haploid packs) on cuda against cpu,
   atol 2e-5, B = 256;
5. the indel slice: a haplotagged fixture (one 500 kb contig, ~30x,
   ONT-like errors, planted het and hom indels) through
   `nanocaller_tpu_torch.cli --mode indels --cpu 1 --device cuda` with
   the launch counters reset just before and read just after, then the
   same command with --device cpu; the two indels.vcf.gz must agree;
   then the cuda run under torch.profiler, with the device time of K1's
   two kernels and K2 on a line of its own;
6. the SNP CNNs (ONT-HG002 and haploid packs) on cuda against cpu,
   atol 2e-5, B = 4096;
7. the SNP slice: one 4.2 Mb contig, 30x, 8 kb reads, 3% substitution
   and 1% indel errors, a planted SNP every 1,000 bp (four two-member
   decode groups and one single) through `--mode snps --cpu 1` on cuda
   (counters reset just before, read just after; one K3 launch a
   cohort, SNP_LAUNCHES in all) and on cpu; both VCFs (unfiltered and
   PASS) must agree; then the cuda run under torch.profiler, with the
   device time of K3, of the CNN's and the other kernels and of the
   copies, and the count of searchsorted launches, which must be 0 (the
   neighbour selection runs inside K3);
8. K3 snp_pileup against its plain twin, exactly equal in all three
   outputs (pileup, column sites, ref one-hot), with kernel, twin and
   bound times and the time of the torch neighbour selection on the same
   rows (`selection_torch_ms`, what the kernel's selection replaced), at
   the launches the main path makes for the slice's first two decode
   groups, for a three-member group of the fixture with maxcov 24 (deep
   rows, clamped windows), for a haploid cohort, and for synthetic
   payloads: holes and dense exceptions; ul_ont bands with clamped
   windows and a read over every site; no neighbour site; one row; rows
   at the first and last site; deep rows with no valid id;
9. the whole pipeline: one untagged 2 Mb contig, 30x, 8 kb reads, 3%
   substitution and 1% indel errors, a planted SNP every 1,000 bp and a
   planted 1-6 bp indel every 5,000 bp, through `--mode all --cpu 1` on
   cuda (all counters reset just before and read just after: K3 once a
   cohort, K1 and K2 on every indel chunk) and on cpu: SNP calling,
   phasing on the host, the indel stage on the phasing's haplotags, the
   final VCF. The five VCFs must agree (SNP and indel rules; the final
   VCF each record by its kind), the high-QUAL set phasing took and its
   phase map must be identical, and the haplotagged BAM artifacts
   record-identical; it prints the largest phase block against the
   trellis's cap-15 limit and the phasing timers; a cuda run with
   --skip_phased_bam must give the same VCF bytes and no artifact; then
   the cuda run under torch.profiler, with the device time of K1, K2,
   K3, the CNNs and the copies. The host work (decode, MSA projection,
   read selection, wMEC trellis, the artifact's retagger) runs on the
   native library;
10. a SNP decode group over the payload caps: the SNP fixture's first
   two-member group through the SNP stage on cuda with the read cap
   lowered between its members' decoded reads and its own, so that each
   member goes as a group of one (one K3 launch a member cohort); the
   VCFs must hold the uncapped run's records (SNP rules);
11. CRAM input: a 500 kb cut of phase 9's fixture written as BAM and, by
   the port's CramWriter, as CRAM, each through `--mode all --cpu 1` on
   cuda: the five VCFs byte-identical, the .phased.cram artifact
   record-identical to the .phased.bam one;
12. the main path, `--mode all --cpu N` (N = min(8, cores)) with
   --haploid_X on three untagged contigs: two diploid 2 Mb contigs and a
   500 kb chrX of hom SNPs (30x, 8 kb reads, phase 9's densities). The
   feature workers (spawned, no torch) build the SNP payloads, phase
   each diploid contig and collect the indel jobs; this process owns the
   card and runs K3, the SNP CNN, finish_indel_jobs (K1 + K2 over every
   pending chunk's pairs) and the indel CNN. Runs: cuda --cpu 1 (wall
   only), cuda --cpu N with the counters reset just before and read
   just after (K1, K2 and K3 must all launch) while nvidia-smi's compute
   apps and the workers' memory maps are polled (no process but this
   one may hold a CUDA context, and no worker may map libcuda), a second
   cuda --cpu N run (byte-identical VCFs), cpu --cpu N (the same chunks;
   the records by phase 9's rules, hiq sets, phase maps and artifacts);
   the cuda --cpu 1 run's records too, by the same rules, where --cpu 1
   and --cpu N cut the same chunks;
   the stage timeline must unlock a contig's indels before the last
   contig is phased; then the cuda --cpu N run under torch.profiler.

Then one JSON line with every kernel's launches (on the main path's
--mode all --cpu N run; each path's own under launches_by_path), error
and times, the nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before that line. Without a GPU, or without
the port's package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper). The int32 rate
# is 132 SMs x 64 INT32 lanes x 1.98 GHz boost: one int32 op per lane and
# clock (the guide's table has no int32 entry).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations the DP needs per cell of K1, one each: the base match
# test (the query code's < 4 test is per row), the substitution select,
# diag = H[j-1] + sub, H - go, V - ge, the V max, the v_ext compare, the
# G max, the came_v compare, G - go, Z - ge, the max that gives Z[j+1]
# (one step of the reference's prefix max), the z_ext compare, the came_z
# compare, the H max, the source select and one 3-input merge of source,
# v_ext and z_ext into the traceback byte
K1_OPS_PER_CELL = 17
# int32 operations per walk step of K2 (a diagonal step), one each: the
# cell address i*(R+1)+j, the state test, the j == 0 and i == 0 tests,
# the source extract, its == 0 test, i - 1, j - 1, the (i | j) != 0 end
# test and the step counter
K2_OPS_PER_STEP = 10
# int32 operations per cell code the pileup needs, one each: the two
# interval compares and their and; the hole row's and the exception row's
# empty test; one binary-search step (mid add and shift, compare,
# select); span_start + s, - lo, the byte index shift, the bit mask, the
# byte shift, the & 1 and the minor/major select; the code < 4 test. It
# needs the centre code of every covering read of a normal row (every
# explicit id of a deep row) and the codes of the other valid columns of
# every read whose centre code counts. How K3 finds the covering reads
# (its read window, which may also hold reads that do not cover the
# centre) is its own cost, not the function's.
K3_OPS_PER_CODE = 17
# int32 operations per counted cell (a code 0-3 of a counted read), one
# each: the counter address (two multiply-adds) and the add
K3_OPS_PER_COUNT = 3
# int32 operations of the neighbour selection, one each. Per step of a
# band end's lower bound in nbr_pos (ceil(log2(M + 1)) steps, two ends a
# band): the mid add and shift, the 64-bit compare (two) and the select.
K3_OPS_PER_SEARCH_STEP = 5
# per band: cand_pos + the two offsets (64-bit, two each), the four
# clamps, i1 - i0, the min with k, the start select, and its step of the
# compaction's prefix sum (five shuffled adds shared by the bands: one)
K3_OPS_PER_BAND = 12
# per selected column: its column index (base + rank), the index clamp
# and the union-site load's address
K3_OPS_PER_COLUMN = 3
# the SNP slice's K3 launches: one diploid cohort for each of its five
# decode groups (no deep row at maxcov 160)
SNP_LAUNCHES = 5
BUCKETS = [(192, 192), (256, 192), (512, 512)]
SCORINGS = {"allele": (20, -10, 9, 1), "msa": (5, -4, 8, 1)}
B_NW = 1024
# (Q, R, B, scoring) of the main path's launches, from BatchAligner on
# this script's fixture: each 100 kb chunk launches (192,192) with ~2,230
# msa pairs, ~120 allele pairs and (64,192) with 56-88 msa pairs
MAIN_LAUNCHES = [(192, 192, 2230, "msa"), (192, 192, 120, "allele"),
                 (64, 192, 64, "msa")]
B_TIE = 256
# about 20 ms of spinning at the H100's clock: longer than the host takes
# to queue one timed loop
SPIN_CYCLES = 40_000_000
FIXTURE_LEN = 500_000
# the SNP slice's contig: at --cpu 1 get_chunks makes nine chunks (eight
# of 500,001 bp), and _group_adjacent's span cap total // 4 = 1,050,000
# bp packs them into four two-member groups and one single
SNP_FIXTURE_LEN = 4_200_000
SNP_CNN_B = 4096
# the pileup's centre column, the candidate site
CENTER_COL = 20
# the port's probability parity bar (ROADMAP "Parity bar"): a printed
# phred value (SNP QUAL, indel QUAL and GQ: -10*log10(eps + q) for a
# probability or complement q) may differ by more than one unit of its
# rounding only where the probabilities it implies differ by at most
# this. Near p = 1 one float32 step of p (6e-8) moves QUAL by one
# 0.001 unit at QUAL 36 and by 2.6 units at QUAL 40.
PARITY_ATOL = 2e-5
# the --mode all fixture: one untagged contig, a SNP every 1,000 bp and
# an indel every 5,000 bp (about 1,300 planted het sites, 1-2 kb apart,
# which 8 kb reads link)
ALL_FIXTURE_LEN = 2_000_000
# the CRAM phase's contig: a 500 kb cut of the --mode all fixture (the
# same seed and densities), run from a BAM and from a CRAM
CRAM_FIXTURE_LEN = 500_000
# the main path's fixture (phase 12): (name, bp, seed, SNP every, indel
# every, hom SNPs only) of each contig, phase 9's densities; chrX is
# haploid under --haploid_X
DAG_CONTIGS = [("chr1", 2_000_000, 3031, 1000, 5000, False),
               ("chr2", 2_000_000, 3032, 1000, 5000, False),
               ("chrX", 500_000, 3033, 1000, 5000, True)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, prep=None, spin=SPIN_CYCLES):
    """Mean device ms of fn() by CUDA events, after one warm-up. A spin
    kernel of `spin` cycles queued first keeps the card busy while the
    host queues the timed calls, so the host's time between launches is
    not counted (give a longer spin to a fn of many small launches).
    With prep, each timed fn() follows an untimed prep() (K2 then reads
    the traceback K1 has just written, from a warm L2, as on the main
    path)."""
    import torch

    fn() if prep is None else (prep(), fn())
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    if prep is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    marks = []
    for _ in range(reps):
        prep()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def _mutate(rng, seq, rate):
    out = []
    for ch, r, b in zip(seq, rng.random(len(seq)),
                        rng.integers(0, 4, len(seq))):
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append("ACGT"[b])
        elif r < rate:
            out.append(ch + "ACGT"[b])
        else:
            out.append(ch)
    return "".join(out)


def nw_inputs(rng, B, Q, R):
    """Half random codes with random lengths, half fixture-like pairs: a
    read window (the ref mutated at 10%) against its ref window."""
    import numpy as np

    from nanocaller_tpu_torch.align.batch_nw import encode_pairs

    q = rng.integers(0, 5, (B, Q)).astype(np.int8)
    r = rng.integers(0, 5, (B, R)).astype(np.int8)
    qlens = rng.integers(1, Q + 1, B).astype(np.int32)
    rlens = rng.integers(1, R + 1, B).astype(np.int32)
    pairs = []
    for _ in range(B // 2, B):
        n = int(rng.integers(max(1, R - 40), R + 1))
        ref = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
        pairs.append((_mutate(rng, ref, 0.1)[:Q], ref))
    fq, fr, fql, frl = encode_pairs(pairs, Q, R)
    q[B // 2:], r[B // 2:], qlens[B // 2:], rlens[B // 2:] = fq, fr, fql, frl
    return q, r, qlens, rlens


def nw_cases(rng):
    """Phase 2-3 inputs: (label, Q, R, B, scoring, inputs)."""
    from nanocaller_tpu_torch.align.batch_nw import encode_pairs
    from nanocaller_tpu_torch.sim import TIE_KINDS, tie_heavy_pairs

    for Q, R in BUCKETS:
        inputs = nw_inputs(rng, B_NW, Q, R)
        for sname in SCORINGS:
            yield "bucket", Q, R, B_NW, sname, inputs
    for Q, R, B, sname in MAIN_LAUNCHES:
        yield "main_path", Q, R, B, sname, nw_inputs(rng, B, Q, R)
    for kind in TIE_KINDS:
        inputs = encode_pairs(tie_heavy_pairs(rng, B_TIE, 192, 192, kind),
                              192, 192)
        for sname in SCORINGS:
            yield "ties_" + kind, 192, 192, B_TIE, sname, inputs


def bound(nbytes, ops):
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def phase_kernels(K, rng):
    """Phases 2 and 3: K1 and K2 against their twins, exact, with times."""
    import torch

    rows = []
    for label, Q, R, B, sname, (q, r, ql, rl) in nw_cases(rng):
        params = SCORINGS[sname]
        qd, rd = torch.from_numpy(q).cuda(), torch.from_numpy(r).cuda()
        ql, rl = torch.from_numpy(ql), torch.from_numpy(rl)
        qld, rld = ql.cuda(), rl.cuda()
        shape = {"inputs": label, "Q": Q, "R": R, "B": B, "scoring": sname}
        tb = K.nw_tb(qd, rd, *params)
        twin = K.nw_tb_reference(qd, rd, *params)
        torch.cuda.synchronize()
        err = int((tb.int() - twin.int()).abs().max())
        if err != 0:
            fail("K1 differs from its twin at %s" % shape)
        del twin
        ms = cuda_ms(lambda: K.nw_tb(qd, rd, *params), 10)
        plain_ms = cuda_ms(lambda: K.nw_tb_reference(qd, rd, *params), 1)
        row = {"phase": "K1_nw_tb", **shape, "exact": True,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **bound(B * (Q + R) + B * (Q + 1) * (R + 1),
                       B * Q * R * K1_OPS_PER_CELL)}
        emit(row)
        rows.append(row)

        T = 2 * (Q + R) + 2
        ops_k = K.nw_walk(tb, ql, rl, T)
        twin_k = K.nw_walk_reference(tb, qld, rld, T)
        torch.cuda.synchronize()
        err = int((ops_k.int() - twin_k.int()).abs().max())
        if err != 0:
            fail("K2 differs from its twin at %s" % shape)
        # every walk's last active step emits, so its active steps
        # (traceback reads) run to its last non-zero op
        nz = (ops_k != 0).int()
        last = torch.where(nz.any(dim=1), T - torch.flip(nz, [1]).argmax(
            dim=1), 0)
        steps, longest = int(last.sum()), int(last.max())
        cur = {}

        def k1():
            cur["tb"] = K.nw_tb(qd, rd, *params)

        ms = cuda_ms(lambda: K.nw_walk(cur["tb"], ql, rl, T), 10, prep=k1)
        plain_ms = cuda_ms(lambda: K.nw_walk_reference(tb, qld, rld, T), 1)
        row = {"phase": "K2_nw_walk", **shape, "exact": True,
               "max_abs_err": err, "steps": steps,
               "longest_walk_steps": longest,
               "ns_per_step_of_longest": ms * 1e6 / max(longest, 1),
               "ms": ms, "plain_ms": plain_ms,
               **bound(B * T + steps + 8 * B, steps * K2_OPS_PER_STEP)}
        emit(row)
        rows.append(row)
        del tb, ops_k, twin_k, cur
    return rows


def phase_models():
    """Phase 4: both indel packs on cuda against cpu, atol 2e-5."""
    import numpy as np
    import torch

    from nanocaller_tpu_torch.models import (HaploidIndelModel, IndelModel,
                                             load_model,
                                             torch_state_dict_from_params)

    rng = np.random.default_rng(4)
    for name, cls, rows in (("ONT-HG002", IndelModel, 15),
                            ("haploid", HaploidIndelModel, 5)):
        params, _ = load_model("indel", name)
        sd = torch_state_dict_from_params(params)
        x = torch.from_numpy(
            (rng.normal(size=(256, rows, 128, 2)) * 0.7).astype(np.float32))
        outs = {}
        for dev in ("cpu", "cuda"):
            m = cls()
            m.load_state_dict(sd)
            m = m.to(dev).eval()
            xd = x.to(dev)
            with torch.inference_mode():
                outs[dev] = m(xd).cpu()
                if dev == "cuda":
                    ms = cuda_ms(lambda: m(xd), 20)
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        emit({"phase": "indel_cnn", "pack": name, "B": 256,
              "max_abs_err": err, "atol": 2e-5, "cuda_forward_ms": ms})
        if not err <= 2e-5:
            fail("indel CNN %s: cuda vs cpu max err %g > 2e-5" % (name, err))


def write_fixture(tmp):
    import numpy as np

    from nanocaller_tpu_torch.io.fasta import write_fasta
    from nanocaller_tpu_torch.sim import make_diploid_readset, random_seq, write_bam

    rng = np.random.default_rng(2024)
    L = FIXTURE_LEN
    ref = random_seq(rng, L)
    indels = []
    for k, p in enumerate(range(1500, L - 1500, 2500)):
        gt = ("het1", "het2", "hom")[k % 3]
        if k % 2:
            indels.append((p, "del", 2 + k % 7, gt))
        else:
            indels.append((p, "ins", "ACGTTG"[: 1 + k % 6], gt))
    reads = make_diploid_readset(rng, ref, snps=[], indels=indels, depth=30,
                                 read_len=2000, error_rate=0.03,
                                 indel_error_rate=0.01)
    fasta_p = os.path.join(tmp, "ref.fa")
    bam_p = os.path.join(tmp, "reads.bam")
    write_fasta(fasta_p, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads, tag_haplotypes=True)
    return fasta_p, bam_p, len(indels), len(reads)


def _records(path):
    with gzip.open(path, "rt") as fh:
        return [l.rstrip("\n").split("\t") for l in fh if not l.startswith("#")]


def _near_phred(what, x, u, v, unit):
    """A phred field's cuda and cpu values u, v: the rounding case
    (None when equal). Past one unit of rounding, the probabilities the
    two values imply must differ by at most PARITY_ATOL; else fail."""
    if u == v:
        return None
    dp = abs(10 ** (-float(u) / 10) - 10 ** (-float(v) / 10))
    if round(abs(float(u) - float(v)), 6) > unit and dp > PARITY_ATOL:
        fail("%s differs by more than one unit at %s:%s: %s vs %s, and the "
             "probabilities differ by %g > %g" % (what, x[0], x[1], u, v, dp,
                                                  PARITY_ATOL))
    return {"pos": int(x[1]), "field": what, "cuda": u, "cpu": v,
            "units": round(abs(float(u) - float(v)) / unit), "implied_dp": dp}


def _indel_record(x, y):
    """One indel record pair: CHROM/POS/REF/ALT, FILTER, INFO, FORMAT and
    every sample field but GQ identical; QUAL and GQ may differ by one
    unit of their %.2f rounding, or more within the parity bar
    (_near_phred). Returns the rounding cases."""
    if x[:5] != y[:5] or x[6:9] != y[6:9]:
        fail("records differ: %s vs %s" % (x, y))
    sx, sy = x[9].split(":"), y[9].split(":")
    if len(sx) != len(sy) or [u for k, u in enumerate(sx) if k != 1] != \
            [v for k, v in enumerate(sy) if k != 1]:
        fail("sample fields differ at %s:%s: %s vs %s"
             % (x[0], x[1], x[9], y[9]))
    cases = (_near_phred(what, x, u, v, 0.01)
             for what, u, v in (("QUAL", x[5], y[5]), ("GQ", sx[1], sy[1])))
    return [d for d in cases if d]


def _snp_record(x, y):
    """One SNP record pair: CHROM/POS/REF/ALT/FILTER/FORMAT, FQ and every
    sample field but VF identical (GT and PS too, where phased); the PR
    and VF values (%.4f) may differ only by one unit of their rounding,
    QUAL (%.3f) by one unit or more within the parity bar (_near_phred).
    Returns the rounding cases."""
    diffs = []

    def near(what, pos, u, v, unit):
        if u == v:
            return
        if round(abs(float(u) - float(v)), 6) > unit:
            fail("%s differs by more than one unit at %s: %s vs %s"
                 % (what, pos, u, v))
        diffs.append({"pos": int(pos), "field": what, "cuda": u, "cpu": v})

    if x[:5] != y[:5] or x[6] != y[6] or x[8] != y[8]:
        fail("records differ: %s vs %s" % (x, y))
    d = _near_phred("QUAL", x, x[5], y[5], 0.001)
    if d:
        diffs.append(d)
    ix, iy = dict(f.split("=") for f in x[7].split(";")), \
        dict(f.split("=") for f in y[7].split(";"))
    if ix["FQ"] != iy["FQ"]:
        fail("FQ differs at %s" % x[1])
    for u, v in zip(ix["PR"].split(","), iy["PR"].split(",")):
        near("PR", x[1], u, v, 0.0001)
    sx, sy = x[9].split(":"), y[9].split(":")
    for k, (u, v) in enumerate(zip(sx, sy)):
        if k == 2:  # VF
            for uu, vv in zip(u.split(","), v.split(",")):
                near("VF", x[1], uu, vv, 0.0001)
        elif u != v:
            fail("sample field %d differs at %s: %s vs %s"
                 % (k, x[1], x[9], y[9]))
    return diffs


def compare_records(a, b, kind):
    """The cuda and cpu VCFs a and b record by record, by the SNP rules
    (kind "snp"), the indel rules ("indel") or, in a VCF of both, each
    record's own ("any": SNP records carry FQ). Returns (records, the
    one-unit rounding cases)."""
    ra, rb = _records(a), _records(b)
    if len(ra) != len(rb):
        fail("%s: cuda VCF has %d records, cpu VCF %d"
             % (os.path.basename(a), len(ra), len(rb)))
    diffs = []
    for x, y in zip(ra, rb):
        snp = kind == "snp" or (kind == "any" and "FQ=" in x[7])
        diffs.extend((_snp_record if snp else _indel_record)(x, y))
    return len(ra), diffs


def phase_slice(K, tmp):
    """Phase 5: the port's CLI on the card (counters reset just before and
    read just after), then on the CPU; the VCFs must agree."""
    from nanocaller_tpu_torch import cli

    t0 = time.perf_counter()
    fasta_p, bam_p, n_planted, n_reads = write_fixture(tmp)
    t_fixture = time.perf_counter() - t0
    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, "out_" + dev)
        argv = ["--bam", bam_p, "--ref", fasta_p, "--mode", "indels",
                "--cpu", "1", "--device", dev, "--output", out,
                "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar"]
        K.reset_counters()
        t0 = time.perf_counter()
        outputs = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = {"NW_TB_LAUNCHES": K.NW_TB_LAUNCHES,
                  "NW_WALK_LAUNCHES": K.NW_WALK_LAUNCHES,
                  "NW_TB_PAIRS": K.NW_TB_PAIRS}
        with open(os.path.join(out, "metrics.json")) as fh:
            metrics = json.load(fh)
        runs[dev] = (outputs["indels"], wall, counts, metrics)
    vcf_cuda, wall, counts, metrics = runs["cuda"]
    if counts["NW_TB_LAUNCHES"] < 1 or counts["NW_WALK_LAUNCHES"] < 1:
        fail("main path launched no kernel: %s" % counts)
    if counts["NW_TB_PAIRS"] < 1000:
        fail("only %d pairs went through K1 (< 1000)" % counts["NW_TB_PAIRS"])
    if metrics["counts"].get("indel_chunks", 0) < 2:
        fail("fixture gave < 2 chunks")
    if runs["cpu"][2]["NW_TB_LAUNCHES"] != 0:
        fail("the cpu run launched a CUDA kernel")
    n_rec, diffs = compare_records(vcf_cuda, runs["cpu"][0], "indel")
    for d in diffs:
        emit({"phase": "slice_rounding_case", **d})
    argv = ["--bam", bam_p, "--ref", fasta_p, "--mode", "indels", "--cpu",
            "1", "--device", "cuda", "--output", os.path.join(tmp, "out_prof"),
            "--prefix", "smoke", "--sample", "S", "--suppress_progress_bar"]
    prof, kern, _ = profile_slice(cli, argv, ("nw_tb_rows_kernel",
                                               "nw_tb_wave_kernel",
                                               "nw_walk_kernel"))
    if n_rec < 1:
        fail("no indel records called")
    emit({"phase": "slice", "contig_bp": FIXTURE_LEN, "reads": n_reads,
          "planted_indels": n_planted, "fixture_s": t_fixture,
          "chunks": metrics["counts"].get("indel_chunks"),
          "candidates": metrics["counts"].get("indel_candidates"),
          "pairs_k1": counts["NW_TB_PAIRS"], "records": n_rec,
          "rounding_cases": len(diffs), "cuda_wall_s": wall,
          "cuda_timers_s": metrics["timers_s"], "cpu_wall_s": runs["cpu"][1],
          "cpu_timers_s": runs["cpu"][3]["timers_s"], **counts})
    emit({"phase": "slice_profile", **prof})
    emit({"phase": "slice_profile_nw_kernels", **kern})
    return counts


def profile_slice(cli, argv, kernel_names):
    """A cuda run once more under torch.profiler: device time by kernel,
    the named kernels' device time, and the device's idle share of the
    run's wall time; and {name: (device us, launches)} of every device
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): the CPU ops that
    # launched them report the same time again
    cuda = torch.autograd.DeviceType.CUDA
    dev = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == cuda and e.self_device_time_total > 0}
    dev_us = {k: us for k, (us, _) in dev.items()}
    busy_s = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    kernels_us = {name: sum(v for k, v in dev_us.items() if name in k)
                  for name in kernel_names}
    return {"wall_s": wall, "device_busy_s": busy_s if dev_us else None,
            "device_idle_share": (1 - busy_s / wall) if dev_us else None,
            "device_us_by_name": {k: v for k, v in top}}, {
                **kernels_us, "sum_us": sum(kernels_us.values())}, dev


def phase_snp_models():
    """Phase 6: the SNP packs on cuda against cpu, atol 2e-5."""
    import numpy as np
    import torch

    from nanocaller_tpu_torch.models import (HaploidSNPModel, SNPModel,
                                             load_model,
                                             torch_state_dict_from_params)

    rng = np.random.default_rng(6)
    B = SNP_CNN_B
    # pileup-like inputs: signed counts scaled as after normalisation
    x = torch.from_numpy(
        (rng.integers(-30, 31, (B, 5, 41, 5)) * 0.8).astype(np.float32))
    x[:, 0] = torch.from_numpy(
        rng.integers(0, 2, (B, 41, 5)).astype(np.float32))
    ref = torch.from_numpy(
        np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)])
    for name, cls in (("ONT-HG002", SNPModel), ("haploid", HaploidSNPModel)):
        params, _ = load_model("snp", name)
        sd = torch_state_dict_from_params(params)
        outs = {}
        for dev in ("cpu", "cuda"):
            m = cls()
            m.load_state_dict(sd)
            m = m.to(dev).eval()
            xd, rd = x.to(dev), ref.to(dev)
            with torch.inference_mode():
                out = m(xd, rd)
                outs[dev] = torch.cat([o.reshape(B, -1) for o in out], 1) \
                    if isinstance(out, tuple) else out
                outs[dev] = outs[dev].cpu()
                if dev == "cuda":
                    ms = cuda_ms(lambda: m(xd, rd), 20)
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        emit({"phase": "snp_cnn", "pack": name, "B": B, "max_abs_err": err,
              "atol": 2e-5, "cuda_forward_ms": ms})
        if not err <= 2e-5:
            fail("SNP CNN %s: cuda vs cpu max err %g > 2e-5" % (name, err))


def write_snp_fixture(tmp):
    import numpy as np

    from nanocaller_tpu_torch.io.fasta import write_fasta
    from nanocaller_tpu_torch.sim import (BASES, make_diploid_readset,
                                          random_seq, write_bam)

    rng = np.random.default_rng(2025)
    L = SNP_FIXTURE_LEN
    ref = random_seq(rng, L)
    snps = []
    for k, p in enumerate(range(500, L - 500, 1000)):
        alt = BASES[(BASES.index(ref[p]) + 1 + k % 3) % 4]  # never the ref
        snps.append((p, alt, ("het1", "het2", "hom")[k % 3]))
    reads = make_diploid_readset(rng, ref, snps=snps, depth=30,
                                 read_len=8000, error_rate=0.03,
                                 indel_error_rate=0.01)
    fasta_p = os.path.join(tmp, "snp_ref.fa")
    bam_p = os.path.join(tmp, "snp_reads.bam")
    write_fasta(fasta_p, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads)
    return fasta_p, bam_p, len(snps), len(reads)


def phase_snp_slice(tmp):
    """Phase 7: the port's CLI `--mode snps --cpu 1` on the card (counters
    reset just before and read just after), then on the CPU; the VCFs
    must agree. Then the cuda run under torch.profiler."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.pileup import snp_pileup as K3

    t0 = time.perf_counter()
    fasta_p, bam_p, n_planted, n_reads = write_snp_fixture(tmp)
    t_fixture = time.perf_counter() - t0

    def argv(dev, out):
        return ["--bam", bam_p, "--ref", fasta_p, "--mode", "snps", "--cpu",
                "1", "--device", dev, "--output", os.path.join(tmp, out),
                "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar"]

    runs = {}
    for dev in ("cuda", "cpu"):
        K.reset_counters()
        K3.reset_counters()
        t0 = time.perf_counter()
        outputs = cli.main(argv(dev, "snp_" + dev))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": K3.SNP_PILEUP_LAUNCHES,
                  "NW_TB_LAUNCHES": K.NW_TB_LAUNCHES}
        with open(os.path.join(tmp, "snp_" + dev, "metrics.json")) as fh:
            metrics = json.load(fh)
        runs[dev] = (outputs["snps"], wall, counts, metrics)
    pass_cuda, wall, counts, metrics = runs["cuda"]
    if counts["SNP_PILEUP_LAUNCHES"] != SNP_LAUNCHES:
        fail("the SNP main path launched K3 %d times, not once a cohort "
             "(%d)" % (counts["SNP_PILEUP_LAUNCHES"], SNP_LAUNCHES))
    if runs["cpu"][2]["SNP_PILEUP_LAUNCHES"] != 0:
        fail("the cpu run launched K3")
    if metrics["counts"].get("snp_chunks", 0) < 2:
        fail("fixture gave < 2 SNP chunks")
    n_pass, d_pass = compare_records(pass_cuda, runs["cpu"][0], "snp")
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    n_all, d_all = compare_records(unf(pass_cuda), unf(runs["cpu"][0]),
                                   "snp")
    if n_pass < n_planted // 2:
        fail("only %d PASS records for %d planted SNPs" % (n_pass, n_planted))
    for d in d_all:
        emit({"phase": "snp_slice_rounding_case", "vcf": "unfiltered", **d})
    for d in d_pass:
        emit({"phase": "snp_slice_rounding_case", "vcf": "pass", **d})
    K3.reset_counters()
    prof, kern, dev = profile_slice(cli, argv("cuda", "snp_prof"),
                                    ("snp_pileup_kernel",))
    # the SNP device time by kind: K3, copies, and the rest (the CNN's
    # cuDNN/cuBLAS and elementwise kernels); no searchsorted may run
    part = lambda *names: [v for k, v in dev.items()
                           if any(n in k for n in names)]
    k3_us = sum(us for us, _ in part("snp_pileup_kernel"))
    copy_us = sum(us for us, _ in part("Memcpy", "Memset"))
    n_search = sum(n for _, n in part("searchsorted"))
    breakdown = {"k3_us": k3_us, "copies_us": copy_us,
                 "cnn_and_other_us": sum(us for us, _ in dev.values())
                 - k3_us - copy_us,
                 "device_launches": sum(n for _, n in dev.values()),
                 "searchsorted_launches": n_search}
    if n_search:
        fail("the profiled SNP run launched searchsorted %d times" % n_search)
    emit({"phase": "snp_slice", "contig_bp": SNP_FIXTURE_LEN,
          "reads": n_reads, "planted_snps": n_planted,
          "fixture_s": t_fixture,
          "chunks": metrics["counts"].get("snp_chunks"),
          "candidates": metrics["counts"].get("snp_candidates"),
          "records_unfiltered": n_all, "records_pass": n_pass,
          "rounding_cases": len(d_all) + len(d_pass), "cuda_wall_s": wall,
          "cuda_timers_s": metrics["timers_s"], "cpu_wall_s": runs["cpu"][1],
          "cpu_timers_s": runs["cpu"][3]["timers_s"], **counts})
    emit({"phase": "snp_slice_profile", **prof})
    emit({"phase": "snp_slice_profile_k3", **kern,
          "launches": K3.SNP_PILEUP_LAUNCHES, **breakdown})
    return counts, fasta_p, bam_p


def k3_cases(fasta_p, bam_p):
    """Phase 8 inputs: (label, snp_pileup args, host payload) at the
    launches the main path makes for the slice's first two decode groups,
    a three-member group with maxcov 24, a haploid member, and synthetic
    payloads (sim.random_group_wire: reads out of start order, clamped
    windows): holes and dense exceptions at a decode group's size; the
    same with ul_ont bands and a read over every site; no neighbour site;
    one row; rows at the first and last site with deep rows, a third of
    them with no valid id."""
    import numpy as np
    import torch

    from nanocaller_tpu_torch.cli import config_from_args
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.pileup import snp_pileup as K3
    from nanocaller_tpu_torch.pileup.snp_features import \
        get_snp_group_payloads
    from nanocaller_tpu_torch.runtime.chunker import (get_chunks,
                                                      get_regions_list)
    from nanocaller_tpu_torch.sim import random_group_wire
    from nanocaller_tpu_torch.snp_caller import (SnpCallerState,
                                                 _group_adjacent,
                                                 pileup_cohorts)

    cfg = config_from_args(["--bam", bam_p, "--ref", fasta_p, "--mode",
                            "snps", "--cpu", "1"])
    state = SnpCallerState.create(cfg.snp_model, device="cuda")
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    chunks = get_chunks(get_regions_list(cfg, bam), cfg.cpu)
    groups = _group_adjacent(chunks, range(len(chunks)), cfg)

    def cohorts(label, members, maxcov, ploidy="diploid"):
        members = [dict(m, ploidy=ploidy) for m in members]
        [gf] = get_snp_group_payloads(
            bam, fasta, members, seq_type=cfg.sequencing, mincov=cfg.mincov,
            maxcov=maxcov, min_allele_freq=cfg.min_allele_freq,
            min_nbr_sites=cfg.min_nbr_sites, threshold=cfg.threshold)
        gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
        for p, deep, args, _mi, _j in pileup_cohorts(state, gf, cfg):
            yield "%s_%s%s" % (label, p, "_deep" if deep else ""), args, gf

    for g in (0, 1):
        yield from cohorts("main_group%d" % (g + 1),
                           [c for _, c in groups[g]], cfg.maxcov)
    three = chunks[:3]
    for label, args, gf in cohorts("three_members", three, 24):
        if not all(sec is not None and len(sec.deep_idx)
                   for _, sec in gf.members):
            fail("a member of the three-member group has no deep row")
        yield label, args, gf
    yield from cohorts("one_member", chunks[:1], cfg.maxcov, "haploid")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    rng = np.random.default_rng(11)
    # about a decode group's size: 1,200 sites, 4,200 reads, 1,100 rows
    for label, kw in (
            ("synthetic_holes_exceptions", dict(S=1200, N=4200, B=1100,
                                                max_span=40)),
            ("synthetic_ul_ont_spanning_read",
             dict(S=1200, N=4200, B=1100, max_span=40, seq_type="ul_ont",
                  span_all=True, exc_share=0.05, hole_share=0.02)),
            ("synthetic_no_neighbours", dict(S=300, N=1000, B=300,
                                             max_span=40, nbr_share=0.0)),
            ("synthetic_one_row", dict(S=300, N=1000, B=1, max_span=40))):
        wire, *rows = random_group_wire(rng, **kw)
        yield label, (K3.group_wire(wire, "cuda"), *map(t, rows), None,
                      None), wire
    # rows at the first and last site (before and after every neighbour)
    # and deep rows, a third with no valid id
    wire, *rows = random_group_wire(rng, S=300, N=1000, B=300, max_span=40)
    cand_site, cand_pos, lo_c, hi_c, norm = rows
    cand_site[:2] = (0, len(wire.site_ref) - 1)
    cand_pos[:2] = (wire.nbr_pos[0] - 1, wire.nbr_pos[-1] + 1)
    lo_c[:2], hi_c[:2] = 0, len(wire.nbr_pos)
    rids = rng.integers(0, len(wire.read_lo), (300, 24)).astype(np.int32)
    n_valid = np.where(rng.random(300) < 1 / 3, 0,
                       rng.integers(1, 25, 300)).astype(np.int32)
    n_valid[:2] = 24
    yield "synthetic_deep_edges", (K3.group_wire(wire, "cuda"),
                                   *map(t, rows), t(rids), t(n_valid)), wire


def k3_work(args, gf, outs):
    """What one K3 launch's outputs needed, counted from this run's
    inputs: the bytes of its inputs and outputs; the (row, read) pairs
    whose centre code it needs (every covering read of a normal row, from
    the host payload gf, or every explicit id of a deep row); the reads
    that counted and their counted cells (rows 1-4, channels 0-3 of x hold
    count * norm, flipped at the ref base; the centre column counts each
    counted read once); the cell codes (the covering reads' centre codes
    and the other valid columns of each counted read); the neighbour
    selection (two lower bounds a band of the row's schedule, its
    band arithmetic, each selected column). K3's own read window
    (scanned_reads: the window's reads for each normal row, from the
    wire's win_lo/win_hi; the explicit ids of a deep row) is printed
    beside them, but its reads that do not cover the centre are not the
    function's work."""
    import math

    import torch

    from nanocaller_tpu_torch.pileup import snp_pileup as K3

    x, soc, ref = outs
    wire, cand_site, cand_pos, lo_c, hi_c, norm, rids, n_valid = args
    if rids is None:
        covering = int(K3.site_depth(gf)[cand_site.cpu().numpy()].sum())
        s = cand_site.long()
        scanned = int((wire.win_hi[s] - wire.win_lo[s]).clamp(min=0).sum())
    else:
        covering = scanned = int(torch.clamp(n_valid, 0,
                                             rids.shape[1]).sum())
    cells = (x[:, 1:, :, :4].abs() / norm[:, None, None, None]).round()
    counted_b = cells[:, :, CENTER_COL].sum(dim=(1, 2))
    other_cols = (soc >= 0).sum(dim=1) - 1
    n_bands = int((wire.bands[..., 2] > 0).sum())
    steps = math.ceil(math.log2(wire.n_nbrs + 1))
    selection_ops = x.shape[0] * n_bands * (
        2 * steps * K3_OPS_PER_SEARCH_STEP + K3_OPS_PER_BAND) \
        + int(other_cols.sum()) * K3_OPS_PER_COLUMN
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts
                            if t is not None)
    return {"scanned_reads": scanned, "covering_reads": covering,
            "counted_reads": int(counted_b.sum()),
            "counted_cells": int(cells.sum()),
            "cell_codes": covering + int((counted_b * other_cols).sum()),
            "selected_columns": int(other_cols.sum()),
            "selection_ops": selection_ops,
            "bytes": nbytes(wire.tensors()) + nbytes(args[1:])
            + nbytes(outs)}


def phase_k3(fasta_p, bam_p, e2e_launches):
    """Phase 8: K3 against its twin on the card, exact, with times."""
    import torch

    from nanocaller_tpu_torch.pileup import snp_pileup as K3

    rows = []
    for label, args, gf in k3_cases(fasta_p, bam_p):
        wire, rids = args[0], args[6]
        outs = K3.snp_pileup(*args)
        twins = K3.snp_pileup_reference(*args)
        torch.cuda.synchronize()
        B = outs[0].shape[0]
        shape = {"inputs": label, "B": B, "N": wire.n_reads,
                 "S": wire.n_sites, "M": wire.n_nbrs,
                 "E": wire.exc_rid.shape[0], "H": wire.hole_rid.shape[0],
                 "deep_width": 0 if rids is None else rids.shape[1]}
        errs = [float((o.float() - w.float()).abs().max()) if o.numel()
                else 0.0 for o, w in zip(outs, twins)]
        if any(e != 0 for e in errs) or not all(
                o.shape == w.shape and o.dtype == w.dtype
                for o, w in zip(outs, twins)):
            fail("K3 differs from its twin at %s (max err x %g, soc %g, "
                 "ref %g)" % (shape, *errs))
        work = k3_work(args, gf, outs)
        ms = cuda_ms(lambda: K3.snp_pileup(*args), 10)
        plain_ms = cuda_ms(lambda: K3.snp_pileup_reference(*args), 1)
        # the torch neighbour selection K3's own replaced, on the same
        # rows (its band table read on the host once, as the schedule
        # was): ~200 small launches a call, ~2 ms of host time, so two
        # calls behind a long spin, which the launch queue holds whole
        bands = wire.bands.cpu()
        sel_ms = cuda_ms(lambda: K3.select_neighbors_clamped(
            args[1], args[2], wire.nbr_pos, wire.nbr_union, bands, args[3],
            args[4]), 2, spin=8 * SPIN_CYCLES)
        row = {"phase": "K3_snp_pileup", **shape, "exact": True,
               "max_abs_err": errs[0], "soc_max_abs_err": errs[1],
               "ref_max_abs_err": errs[2], **work,
               "e2e_launches": e2e_launches, "ms": ms, "plain_ms": plain_ms,
               "selection_torch_ms": sel_ms,
               **bound(work["bytes"], work["cell_codes"] * K3_OPS_PER_CODE
                       + work["counted_cells"] * K3_OPS_PER_COUNT
                       + work["selection_ops"])}
        row["share_of_bound"] = row["bound_ms"] / ms
        emit(row)
        rows.append(row)
        del outs, twins
    return rows


def _vcf_phase_sets(path):
    """The positions of a per-contig phasing VCF's records, and
    {pos: (GT, PS)} of its phased ones."""
    pos, pmap = set(), {}
    for x in _records(path):
        pos.add(int(x[1]))
        keys, vals = x[8].split(":"), x[9].split(":")
        if "PS" in keys:
            pmap[int(x[1])] = (vals[0], vals[keys.index("PS")])
    return pos, pmap


def _alignment_records(path, fasta):
    """Decoded records of a BAM or CRAM: the fields a CRAM round trip
    keeps (=/X read as M), tags as a dict."""
    from nanocaller_tpu_torch.io.bam import open_alignment

    aln = open_alignment(path, fasta=fasta)
    out = []
    for c in aln.references:
        for r in aln.fetch(c):
            cigar = []
            for op, ln in r.cigar:
                op = 0 if op in (7, 8) else op
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))
            out.append((r.qname, r.flag, r.ref_id, r.pos, r.mapq, cigar,
                        r.seq, bytes(r.qual), dict(r.tags)))
    aln.close()
    return out


def phase_all_slice(tmp):
    """Phase 9: the port's CLI `--mode all --cpu 1` on an untagged
    fixture, on the card (all counters reset just before and read just
    after: K3 once a cohort, K1 and K2 on every indel chunk) and on the
    CPU. The five VCFs must agree by the SNP and indel rules, the
    high-QUAL set phasing took and its phase map must be identical (a
    one-unit QUAL rounding that crosses --phase_qual_score is printed and
    fails), and the haplotagged BAM artifacts record-identical. Then the
    cuda run under torch.profiler."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.pileup import snp_pileup as K3
    from nanocaller_tpu_torch.runtime.chunker import (get_chunks,
                                                      get_regions_list)
    from nanocaller_tpu_torch.sim import write_all_fixture
    from nanocaller_tpu_torch.snp_caller import _group_adjacent

    t0 = time.perf_counter()
    fasta_p, bam_p, snps, indels, n_reads = write_all_fixture(
        tmp, ALL_FIXTURE_LEN, seed=2026, snp_every=1000, indel_every=5000,
        depth=30, read_len=8000, error_rate=0.03, indel_error_rate=0.01)
    t_fixture = time.perf_counter() - t0

    def argv(dev, out):
        return ["--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu",
                "1", "--device", dev, "--output", os.path.join(tmp, out),
                "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar"]

    cfg = cli.config_from_args(argv("cuda", "all_cuda"))
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    chunks = get_chunks(get_regions_list(cfg, BamReader(bam_p)), cfg.cpu)
    # one diploid cohort a decode group (no deep row at maxcov 160)
    cohorts = len(_group_adjacent(chunks, range(len(chunks)), cfg))
    runs = {}
    for dev in ("cuda", "cpu"):
        K.reset_counters()
        K3.reset_counters()
        t0 = time.perf_counter()
        outputs = cli.main(argv(dev, "all_" + dev))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": K3.SNP_PILEUP_LAUNCHES,
                  "NW_TB_LAUNCHES": K.NW_TB_LAUNCHES,
                  "NW_WALK_LAUNCHES": K.NW_WALK_LAUNCHES,
                  "NW_TB_PAIRS": K.NW_TB_PAIRS}
        with open(os.path.join(tmp, "all_" + dev, "metrics.json")) as fh:
            metrics = json.load(fh)
        runs[dev] = (outputs, wall, counts, metrics)
    outs, wall, counts, metrics = runs["cuda"]
    n_chunks = metrics["counts"].get("indel_chunks", 0)
    if counts["SNP_PILEUP_LAUNCHES"] != cohorts:
        fail("--mode all launched K3 %d times, not once a cohort (%d)"
             % (counts["SNP_PILEUP_LAUNCHES"], cohorts))
    # every 100 kb chunk of this fixture holds planted indels, so each
    # aligns its candidates' reads through K1 and K2
    if n_chunks < 2 or counts["NW_TB_LAUNCHES"] < n_chunks or \
            counts["NW_WALK_LAUNCHES"] < n_chunks:
        fail("--mode all launched K1 %d and K2 %d times for %d indel chunks"
             % (counts["NW_TB_LAUNCHES"], counts["NW_WALK_LAUNCHES"],
                n_chunks))
    if any(runs["cpu"][2][k] for k in ("SNP_PILEUP_LAUNCHES",
                                       "NW_TB_LAUNCHES")):
        fail("the cpu run launched a CUDA kernel")
    cpu_outs = runs["cpu"][0]
    records, cases = {}, []
    for name, a, b, kind in (
            ("unfiltered", unf(outs["snps"]), unf(cpu_outs["snps"]), "snp"),
            ("snps", outs["snps"], cpu_outs["snps"], "snp"),
            ("snps.phased", outs["phased_snps"], cpu_outs["phased_snps"],
             "snp"),
            ("indels", outs["indels"], cpu_outs["indels"], "indel"),
            ("final", outs["final"], cpu_outs["final"], "any")):
        records[name], diffs = compare_records(a, b, kind)
        cases += [dict(d, vcf=name) for d in diffs]
    for d in cases:
        emit({"phase": "all_slice_rounding_case", **d})
    # the high-QUAL set and the phase map, from the per-contig files
    pdir = lambda dev: os.path.join(tmp, "all_" + dev,
                                    "intermediate_phase_files")
    hiq, pmaps = {}, {}
    for dev in ("cuda", "cpu"):
        hiq[dev], pmaps[dev] = _vcf_phase_sets(
            os.path.join(pdir(dev), "chr_t.snps.phased.vcf.gz"))
    if hiq["cuda"] != hiq["cpu"]:
        for pos in sorted(hiq["cuda"] ^ hiq["cpu"]):
            emit({"phase": "all_slice_hiq_crossing", "pos": pos,
                  "cuda_hiq": pos in hiq["cuda"], "cpu_hiq": pos in hiq["cpu"],
                  "phase_qual_score": cfg.phase_qual_score})
        fail("the high-QUAL SNP sets of the cuda and cpu runs differ")
    if pmaps["cuda"] != pmaps["cpu"]:
        fail("the phase maps of the cuda and cpu runs differ")
    blocks = {}
    for _gt, ps in pmaps["cuda"].values():
        blocks[ps] = blocks.get(ps, 0) + 1
    bams = [_alignment_records(os.path.join(pdir(dev), "chr_t.phased.bam"),
                               fasta_p)
            for dev in ("cuda", "cpu")]
    if bams[0] != bams[1]:
        fail("the haplotagged BAM artifacts of the cuda and cpu runs differ")
    tagged = sum(1 for r in bams[0] if r[-1])
    if records["snps.phased"] < len(snps) // 2 or len(blocks) < 1 or \
            tagged < len(bams[0]) // 2 or records["indels"] < len(indels) // 2:
        fail("too little was called or phased: %s records, %d blocks, %d of "
             "%d reads tagged" % (records, len(blocks), tagged, len(bams[0])))
    # --skip_phased_bam on the card: the same VCF bytes as the first cuda
    # run, no artifact, and the indel stage without the writer's thread
    t0 = time.perf_counter()
    skip = cli.main(argv("cuda", "all_skip") + ["--skip_phased_bam"])
    skip_wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "all_skip", "metrics.json")) as fh:
        skip_timers = json.load(fh)["timers_s"]
    for path in [unf(skip["snps"])] + [skip[k] for k in (
            "snps", "phased_snps", "indels", "final")]:
        with gzip.open(path) as a, \
                gzip.open(path.replace("all_skip", "all_cuda")) as b:
            if a.read() != b.read():
                fail("--skip_phased_bam changed %s" % os.path.basename(path))
    if os.path.exists(os.path.join(pdir("skip"), "chr_t.phased.bam")):
        fail("--skip_phased_bam wrote the artifact")
    K.reset_counters()
    K3.reset_counters()
    prof, kern, dev = profile_slice(
        cli, argv("cuda", "all_prof"),
        ("nw_tb_rows_kernel", "nw_tb_wave_kernel", "nw_walk_kernel",
         "snp_pileup_kernel"))
    part = lambda *names: sum(us for k, (us, _) in dev.items()
                              if any(n in k for n in names))
    kern["copies_us"] = part("Memcpy", "Memset")
    kern["cnn_and_other_us"] = sum(us for us, _ in dev.values()) \
        - kern["sum_us"] - kern["copies_us"]
    kern["device_launches"] = sum(n for _, n in dev.values())
    emit({"phase": "all_slice", "contig_bp": ALL_FIXTURE_LEN,
          "reads": n_reads, "planted_snps": len(snps),
          "planted_indels": len(indels), "fixture_s": t_fixture,
          "snp_chunks": metrics["counts"].get("snp_chunks"),
          "cohorts": cohorts, "indel_chunks": n_chunks,
          "snp_candidates": metrics["counts"].get("snp_candidates"),
          "indel_candidates": metrics["counts"].get("indel_candidates"),
          "records": records, "rounding_cases": len(cases),
          "cases_past_one_unit": sum(1 for d in cases if d.get("units", 1) > 1),
          "hiq_records": len(hiq["cuda"]), "phased_sites": len(pmaps["cuda"]),
          "phase_blocks": len(blocks),
          "largest_block_sites": max(blocks.values()),
          "block_cap_limit_sites": 16 * cfg.phase_cell_budget // (1 << 15),
          "artifact_reads": len(bams[0]), "artifact_tagged": tagged,
          "cuda_wall_s": wall, "cuda_timers_s": metrics["timers_s"],
          "cpu_wall_s": runs["cpu"][1],
          "cpu_timers_s": runs["cpu"][3]["timers_s"],
          "cuda_skip_phased_bam_wall_s": skip_wall,
          "cuda_skip_phased_bam_timers_s": skip_timers, **counts})
    emit({"phase": "all_slice_profile", **prof})
    emit({"phase": "all_slice_profile_kernels", **kern,
          "launches_k3": K3.SNP_PILEUP_LAUNCHES,
          "launches_k1": K.NW_TB_LAUNCHES})
    return counts


def phase_a2a(tmp, fasta_p, bam_p):
    """Phase 10: a SNP decode group over the payload caps on the card.
    The SNP fixture's first two-member group through the SNP stage with
    the read cap set between the members' decoded reads and the group's:
    each member goes as a group of one (one K3 launch a member cohort),
    and the VCFs must hold the uncapped group run's records (the SNP
    rules of the cuda-vs-cpu comparison: the CNN runs on other
    batches)."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.pileup import snp_features as SF
    from nanocaller_tpu_torch.pileup import snp_pileup as K3
    from nanocaller_tpu_torch.pileup.engine import decode_reads
    from nanocaller_tpu_torch.runtime.chunker import (get_chunks,
                                                      get_regions_list)
    from nanocaller_tpu_torch.snp_caller import _group_adjacent, call_snps

    cfg = cli.config_from_args(["--bam", bam_p, "--ref", fasta_p, "--mode",
                                "snps", "--cpu", "1", "--device", "cuda",
                                "--prefix", "smoke", "--sample", "S"])
    bam = BamReader(bam_p)
    regions = get_regions_list(cfg, bam)
    chunks = get_chunks(regions, cfg.cpu)
    group = [c for _, c in
             _group_adjacent(chunks, range(len(chunks)), cfg)[0]]
    if len(group) != 2:
        fail("the SNP fixture's first decode group has %d members, not 2"
             % len(group))
    # call_snps sizes its groups from the chunks it is given: keep these
    # two together as the whole contig's run does
    cfg.snp_group_span = sum(m["end"] - m["start"] + 1 for m in group)
    contig = group[0]["chrom"]
    windows = [(max(0, m["start"] - 1 - SF.SNP_HALO), m["end"] + SF.SNP_HALO)
               for m in group]
    n_group = decode_reads(bam, contig, windows[0][0], windows[-1][1]).n_reads
    n_members = [decode_reads(bam, contig, lo, hi).n_reads
                 for lo, hi in windows]
    cap = max(n_members)
    if not cap < n_group:
        fail("no read cap sends the group member by member: members %s, "
             "group %d reads" % (n_members, n_group))
    saved = SF._GROUP_MAX_READS
    runs = {}
    for name, limit in (("whole", saved), ("capped", cap)):
        out = os.path.join(tmp, "a2a_" + name)
        os.makedirs(out)
        cfg.output = out
        SF._GROUP_MAX_READS = limit
        try:
            K3.reset_counters()
            t0 = time.perf_counter()
            call_snps(cfg, bam, regions, [dict(m) for m in group], out)
            runs[name] = (K3.SNP_PILEUP_LAUNCHES, time.perf_counter() - t0,
                          os.path.join(out, "smoke.snps.vcf.gz"))
        finally:
            SF._GROUP_MAX_READS = saved
    if (runs["whole"][0], runs["capped"][0]) != (1, 2):
        fail("K3 launched %d times for the whole group and %d for its "
             "members, not 1 and 2" % (runs["whole"][0], runs["capped"][0]))
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    n_all, d_all = compare_records(unf(runs["capped"][2]),
                                   unf(runs["whole"][2]), "snp")
    n_pass, d_pass = compare_records(runs["capped"][2], runs["whole"][2],
                                     "snp")
    for d in d_all + d_pass:
        emit({"phase": "a2a_rounding_case", **d})
    emit({"phase": "a2a", "members": [[m["start"], m["end"]]
                                      for m in group],
          "group_reads": n_group, "member_reads": n_members,
          "group_max_reads": cap, "k3_launches_whole": runs["whole"][0],
          "k3_launches_capped": runs["capped"][0],
          "records_unfiltered": n_all, "records_pass": n_pass,
          "rounding_cases": len(d_all) + len(d_pass),
          "whole_s": runs["whole"][1], "capped_s": runs["capped"][1]})


def phase_cram_all(tmp):
    """Phase 11: `--mode all --cpu 1` on a CRAM on the card. A cut of
    phase 9's fixture (CRAM_FIXTURE_LEN bp, the same seed and densities)
    written as BAM and, through the port's CramWriter, as CRAM; both run
    on cuda. The five VCFs must be byte-identical, and the .phased.cram
    artifact record-identical to the .phased.bam one."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.cram import CramWriter
    from nanocaller_tpu_torch.sim import write_all_fixture

    d = os.path.join(tmp, "cram_fixture")
    os.makedirs(d)
    fasta_p, bam_p, snps, indels, n_reads = write_all_fixture(
        d, CRAM_FIXTURE_LEN, seed=2026, snp_every=1000, indel_every=5000,
        depth=30, read_len=8000, error_rate=0.03, indel_error_rate=0.01)
    cram_p = os.path.join(d, "reads.cram")
    t0 = time.perf_counter()
    br = BamReader(bam_p)
    with CramWriter(cram_p, br.references, br.lengths, fasta_p) as w:
        for c in br.references:
            for r in br.fetch(c):
                w.write(r)
    br.close()
    cram_write_s = time.perf_counter() - t0

    outs, walls, timers = {}, {}, {}
    for name, inp in (("bam", bam_p), ("cram", cram_p)):
        out = os.path.join(tmp, "cram_all_" + name)
        t0 = time.perf_counter()
        outs[name] = cli.main([
            "--bam", inp, "--ref", fasta_p, "--mode", "all", "--cpu", "1",
            "--device", "cuda", "--output", out, "--prefix", "smoke",
            "--sample", "S", "--suppress_progress_bar"])
        walls[name] = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.json")) as fh:
            timers[name] = json.load(fh)["timers_s"]
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    records = {}
    for key in ("unfiltered", "snps", "phased_snps", "indels", "final"):
        a, b = [unf(outs[n]["snps"]) if key == "unfiltered" else outs[n][key]
                for n in ("bam", "cram")]
        with gzip.open(a) as fa, gzip.open(b) as fb:
            data = fa.read()
            if data != fb.read():
                fail("--mode all on the CRAM changed %s" % key)
        records[key] = sum(1 for l in data.splitlines()
                           if not l.startswith(b"#"))
    pdir = lambda n: os.path.join(tmp, "cram_all_" + n,
                                  "intermediate_phase_files")
    art_bam = os.path.join(pdir("bam"), "chr_t.phased.bam")
    art_cram = os.path.join(pdir("cram"), "chr_t.phased.cram")
    if os.path.exists(os.path.join(pdir("cram"), "chr_t.phased.bam")):
        fail("the CRAM run wrote a phased BAM")
    got, want = (_alignment_records(art_cram, fasta_p),
                 _alignment_records(art_bam, fasta_p))
    if got != want:
        fail("the .phased.cram artifact's records differ from the "
             ".phased.bam artifact's")
    tagged = sum(1 for r in got if "HP" in r[-1])
    if records["snps"] < len(snps) // 2 or records["indels"] < \
            len(indels) // 2 or tagged < len(got) // 2:
        fail("too little was called or tagged on the CRAM: %s, %d of %d "
             "reads tagged" % (records, tagged, len(got)))
    emit({"phase": "cram_all", "contig_bp": CRAM_FIXTURE_LEN,
          "reads": n_reads, "bam_bytes": os.path.getsize(bam_p),
          "cram_bytes": os.path.getsize(cram_p), "cram_write_s": cram_write_s,
          "records": records, "artifact_reads": len(got),
          "artifact_tagged": tagged, "bam_wall_s": walls["bam"],
          "cram_wall_s": walls["cram"], "bam_timers_s": timers["bam"],
          "cram_timers_s": timers["cram"]})


def _child_pids(pid):
    """PIDs of the live processes whose parent is `pid`."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % d) as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def _is_pool_worker(pid):
    """Whether `pid` is a worker that multiprocessing's `spawn` started
    (its command line runs spawn_main); the resource tracker, which
    spawn also starts, is not one."""
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as fh:
            return b"spawn_main" in fh.read()
    except OSError:
        return False


def _maps_libcuda(pid):
    try:
        with open("/proc/%d/maps" % pid) as fh:
            return "libcuda" in fh.read()
    except OSError:
        return False


def _cmdline(pid):
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as fh:
            return fh.read()
    except OSError:
        return None


class CudaContextWatch:
    """Polls, on a thread, nvidia-smi's compute apps (the PIDs that hold
    a CUDA context on the card; in a container it may list none, or
    PIDs of the host's namespace, so `smi_polls_with_pids` says how many
    polls listed any) and the memory maps of this process's children
    (every child: one that loaded the CUDA driver maps libcuda).
    `workers` are the children that are spawn's pool workers.

    A child that `spawn` (or any subprocess) has forked but not yet
    exec'd still shares or copies this process's memory, libcuda
    included, and still shows this process's command line. It maps
    libcuda for that moment without having loaded anything, so such a
    child counts in `cuda_children` only if it is still an un-exec'd
    copy of this process `fork_grace` seconds after it was first seen
    (a fork that never execs keeps this process's mappings for good);
    `fork_windows` counts the polls that met one. A child that has
    exec'd and maps libcuda counts at once."""

    def __init__(self, period=0.25, fork_grace=2.0):
        import threading

        self.period, self.fork_grace = period, fork_grace
        self.smi_pids, self.workers, self.cuda_children = set(), set(), set()
        self.polls = self.smi_polls_with_pids = self.fork_windows = 0
        self._forks = {}  # pid -> when first seen un-exec'd, mapping libcuda
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _check_child(self, c, mine, now):
        before = _cmdline(c)
        maps = _maps_libcuda(c)
        after = _cmdline(c)
        if before is None or after is None or before != after:
            return  # gone, or exec'd during the reads: next poll decides
        if _is_pool_worker(c):
            self.workers.add(c)
        if not maps:
            self._forks.pop(c, None)
        elif after == mine:
            self.fork_windows += 1
            if now - self._forks.setdefault(c, now) >= self.fork_grace:
                self.cuda_children.add(c)
        else:
            self.cuda_children.add(c)

    def _run(self):
        me = os.getpid()
        mine = _cmdline(me)
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=30).stdout
                pids = {int(x) for x in out.split() if x.isdigit()}
                self.smi_pids |= pids
                self.smi_polls_with_pids += bool(pids)
            except (OSError, subprocess.SubprocessError):
                pass
            now = time.monotonic()
            for c in _child_pids(me):
                self._check_child(c, mine, now)
            self.polls += 1
            self._stop.wait(self.period)

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()


def phase_dag(tmp):
    """Phase 12: the main path, `--mode all --cpu N` on the card, with the
    feature workers, the per-contig phase→indel DAG and every worker's
    indel jobs aligned in this process on K1/K2 (see the module
    docstring). Returns the counters of the cuda --cpu N run."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.pileup import snp_pileup as K3
    from nanocaller_tpu_torch.sim import write_contigs_fixture

    n = min(8, os.cpu_count() or 1)
    d = os.path.join(tmp, "dag_fixture")
    os.makedirs(d)
    t0 = time.perf_counter()
    fasta_p, bam_p, planted, n_reads = write_contigs_fixture(
        d, DAG_CONTIGS, depth=30, read_len=8000, error_rate=0.03,
        indel_error_rate=0.01)
    t_fixture = time.perf_counter() - t0
    diploid = [c[0] for c in DAG_CONTIGS if not c[5]]

    def argv(dev, cpu, out):
        return ["--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu",
                str(cpu), "--haploid_X", "--device", dev, "--output",
                os.path.join(tmp, out), "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar"]

    def drive(dev, cpu, out, watch=False):
        K.reset_counters()
        K3.reset_counters()
        w = CudaContextWatch() if watch else None
        t0 = time.perf_counter()
        if w:
            with w:
                outputs = cli.main(argv(dev, cpu, out))
        else:
            outputs = cli.main(argv(dev, cpu, out))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": K3.SNP_PILEUP_LAUNCHES,
                  "NW_TB_LAUNCHES": K.NW_TB_LAUNCHES,
                  "NW_WALK_LAUNCHES": K.NW_WALK_LAUNCHES,
                  "NW_TB_PAIRS": K.NW_TB_PAIRS}
        with open(os.path.join(tmp, out, "metrics.json")) as fh:
            metrics = json.load(fh)
        return outputs, wall, counts, metrics, w

    runs = {"cuda1": drive("cuda", 1, "dag_cuda1"),
            "cudaN": drive("cuda", n, "dag_cudaN", watch=True),
            "cudaN_again": drive("cuda", n, "dag_cudaN_again"),
            "cpuN": drive("cpu", n, "dag_cpuN")}
    outs, wall, counts, metrics, watch = runs["cudaN"]
    for k in ("SNP_PILEUP_LAUNCHES", "NW_TB_LAUNCHES", "NW_WALK_LAUNCHES"):
        if not counts[k] > 0:
            fail("--mode all --cpu %d did not launch %s" % (n, k))
    if any(runs["cpuN"][2][k] for k in ("SNP_PILEUP_LAUNCHES",
                                        "NW_TB_LAUNCHES")):
        fail("the cpu run launched a CUDA kernel")
    # the device owner holds a context all along, so nvidia-smi must list
    # one process at most (its PID may be the host's, in a container)
    if len(watch.smi_pids) > 1 or watch.cuda_children:
        fail("a process other than the device owner (%d) held a CUDA "
             "context: nvidia-smi %s, workers mapping libcuda %s"
             % (os.getpid(), sorted(watch.smi_pids),
                sorted(watch.cuda_children)))
    if len(watch.workers) < min(n, 2):
        fail("saw %d spawned worker processes, not the --cpu %d pool"
             % (len(watch.workers), n))
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    paths = lambda o: [unf(o["snps"])] + [o[k] for k in (
        "snps", "phased_snps", "indels", "final")]
    again = runs["cudaN_again"][0]
    for a, b in zip(paths(outs), paths(again)):
        with gzip.open(a) as fa, gzip.open(b) as fb:
            if fa.read() != fb.read():
                fail("two cuda --cpu %d runs differ in %s"
                     % (n, os.path.basename(a)))
    # --cpu 1 and --cpu N cut this fixture into the same chunks, so the
    # inline path and the workers' path must call the same records (the
    # CNN batches differ: the SNP rules allow their rounding cases)
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.runtime.chunker import (get_chunks,
                                                      get_regions_list)

    regions = get_regions_list(cli.config_from_args(argv("cuda", n, "x")),
                               BamReader(bam_p))
    serial_cases = None
    if get_chunks(regions, 1) == get_chunks(regions, n):
        serial_cases = 0
        for name, a, b, kind in zip(
                ("unfiltered", "snps", "snps.phased", "indels", "final"),
                paths(outs), paths(runs["cuda1"][0]),
                ("snp", "snp", "snp", "indel", "any")):
            serial_cases += len(compare_records(a, b, kind)[1])
    cpu_outs = runs["cpuN"][0]
    records, cases = {}, []
    for name, a, b, kind in zip(
            ("unfiltered", "snps", "snps.phased", "indels", "final"),
            paths(outs), paths(cpu_outs),
            ("snp", "snp", "snp", "indel", "any")):
        records[name], diffs = compare_records(a, b, kind)
        cases += [dict(x, vcf=name) for x in diffs]
    for x in cases:
        emit({"phase": "dag_rounding_case", **x})
    pdir = lambda out: os.path.join(tmp, out, "intermediate_phase_files")
    tagged = 0
    for c in diploid:
        sets = [_vcf_phase_sets(os.path.join(
            pdir(o), "%s.snps.phased.vcf.gz" % c))
            for o in ("dag_cudaN", "dag_cpuN")]
        if sets[0][0] != sets[1][0] or sets[0][1] != sets[1][1]:
            fail("the hiq set or phase map of %s differs between the cuda "
                 "and cpu --cpu %d runs" % (c, n))
        arts = [_alignment_records(os.path.join(
            pdir(o), "%s.phased.bam" % c), fasta_p)
            for o in ("dag_cudaN", "dag_cpuN")]
        if arts[0] != arts[1]:
            fail("the %s artifacts of the cuda and cpu runs differ" % c)
        tagged += sum(1 for r in arts[0] if r[-1])
    timeline = metrics.get("stage_timeline", [])
    unlocked = [e["t"] for e in timeline if e["stage"] == "indels_unlocked"]
    done = [e["t"] for e in timeline if e["stage"] == "phase_done"]
    if len(done) != len(diploid) or not unlocked or \
            not min(unlocked) < max(done):
        fail("the stage timeline shows no indel unlock before the last "
             "phase_done: %s" % timeline[:12])
    n_snps = sum(len(p[0]) for p in planted.values())
    n_indels = sum(len(p[1]) for p in planted.values())
    if records["snps"] < n_snps // 2 or records["indels"] < n_indels // 2 \
            or tagged < n_reads // 3:
        fail("too little was called or tagged: %s, %d reads tagged"
             % (records, tagged))
    K.reset_counters()
    K3.reset_counters()
    prof, kern, dev = profile_slice(
        cli, argv("cuda", n, "dag_prof"),
        ("nw_tb_rows_kernel", "nw_tb_wave_kernel", "nw_walk_kernel",
         "snp_pileup_kernel"))
    emit({"phase": "dag", "cpu": n, "contigs": [c[:2] for c in DAG_CONTIGS],
          "reads": n_reads, "planted_snps": n_snps,
          "planted_indels": n_indels, "fixture_s": t_fixture,
          "records": records, "rounding_cases": len(cases),
          "cuda1_vs_cudaN_rounding_cases": serial_cases,
          "cases_past_one_unit": sum(1 for x in cases
                                     if x.get("units", 1) > 1),
          "artifact_tagged": tagged,
          "walls_s": {k: v[1] for k, v in runs.items()},
          "timers_s": {k: v[3]["timers_s"] for k, v in runs.items()},
          "counts": {k: v[3]["counts"] for k, v in runs.items()},
          "launches_cuda1": runs["cuda1"][2], **counts,
          "stage_timeline": timeline[:40],
          "workers_seen": len(watch.workers), "watch_polls": watch.polls,
          "smi_polls_with_pids": watch.smi_polls_with_pids,
          "fork_windows_seen": watch.fork_windows,
          "nvidia_smi_compute_pids": sorted(watch.smi_pids),
          "device_owner_pid": os.getpid()})
    emit({"phase": "dag_profile", **prof})
    emit({"phase": "dag_profile_kernels", **kern,
          "launches_k3": K3.SNP_PILEUP_LAUNCHES,
          "launches_k1": K.NW_TB_LAUNCHES,
          "copies_us": sum(us for k, (us, _) in dev.items()
                           if "Memcpy" in k or "Memset" in k)})
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "nanocaller_tpu_torch", "csrc")):
        print("chip_smoke: the nanocaller_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.io import native
    from nanocaller_tpu_torch.runtime.device import resolve_device
    import numpy as np

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = K.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_lib()
    native_s = time.perf_counter() - t0
    resolve_device("cuda")  # also pins TF32 off and deterministic cuDNN
    emit({"phase": "setup", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "library": os.path.relpath(lib, HERE),
          "native_build_s": native_s,
          "native_library": os.path.relpath(native.library_path(), HERE)})

    rng = np.random.default_rng(1)
    rows = phase_kernels(K, rng)
    phase_models()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts = phase_slice(K, tmp)
        phase_snp_models()
        snp_counts, fasta_p, bam_p = phase_snp_slice(tmp)
        k3_rows = phase_k3(fasta_p, bam_p,
                           snp_counts["SNP_PILEUP_LAUNCHES"])
        all_counts = phase_all_slice(tmp)
        phase_a2a(tmp, fasta_p, bam_p)
        phase_cram_all(tmp)
        dag_counts = phase_dag(tmp)

    def pick(phase):
        return next(r for r in rows if r["phase"] == phase and
                    r["inputs"] == "bucket" and
                    (r["Q"], r["R"], r["scoring"]) == (192, 192, "msa"))

    k1, k2 = pick("K1_nw_tb"), pick("K2_nw_walk")
    k3 = next(r for r in k3_rows if r["inputs"].startswith("main_group1"))

    def max_err(phase, rows=rows):
        return max(r["max_abs_err"] for r in rows if r["phase"] == phase)

    kernels = [
        {"name": "nw_tb", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/nw_tb.cu",
         "replaces": "nanocaller_tpu/align/pallas_nw.py:102",
         "launches": dag_counts["NW_TB_LAUNCHES"],
         "launches_by_path": {"indels": counts["NW_TB_LAUNCHES"],
                              "all": all_counts["NW_TB_LAUNCHES"],
                              "all_cpuN": dag_counts["NW_TB_LAUNCHES"]},
         "max_abs_err": max_err("K1_nw_tb"),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "shape": "B=1024 Q=192 R=192 msa scoring"},
        {"name": "nw_walk", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/nw_walk.cu",
         "replaces": "nanocaller_tpu/align/batch_nw.py:134",
         "launches": dag_counts["NW_WALK_LAUNCHES"],
         "launches_by_path": {"indels": counts["NW_WALK_LAUNCHES"],
                              "all": all_counts["NW_WALK_LAUNCHES"],
                              "all_cpuN": dag_counts["NW_WALK_LAUNCHES"]},
         "max_abs_err": max_err("K2_nw_walk"),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "shape": "B=1024 Q=192 R=192 msa scoring"},
        {"name": "snp_pileup", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/snp_pileup.cu",
         "replaces": "nanocaller_tpu/snp_caller.py:417 and :483",
         "launches": dag_counts["SNP_PILEUP_LAUNCHES"],
         "launches_by_path": {"snps": snp_counts["SNP_PILEUP_LAUNCHES"],
                              "all": all_counts["SNP_PILEUP_LAUNCHES"],
                              "all_cpuN": dag_counts["SNP_PILEUP_LAUNCHES"]},
         "max_abs_err": max_err("K3_snp_pileup", k3_rows),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None,
         "shape": "B=%d rows, N=%d reads, S=%d sites (%s)"
                  % (k3["B"], k3["N"], k3["S"], k3["inputs"])},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
