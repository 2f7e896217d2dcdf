#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (nanocaller_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per case:

1. the card (nvidia-smi name and power limit), the nvcc build of the
   kernels from the sources in this checkout (one nvcc per source, all
   started together) and the g++ build of the native host library
   (io/native/ncio.cpp);
2. K1 nw_tb against its plain twin, exactly equal, with kernel, twin
   and bound times: at the buckets (192,192), (256,192), (256,320),
   (512,512) with B = 1024 and both scoring sets; at the main path's
   launch shapes (MAIN_LAUNCHES); on tie-heavy pairs (homopolymer runs,
   tandem repeats with a unit inserted or deleted, identical sequences)
   at both scorings;
3. K2 nw_walk against its plain twin on each of those tracebacks,
   exactly equal, timed right after a K1 launch (warm L2, as the main
   path finds it), with the longest walk's step count; then K4 nw_cigar
   against its plain twin on each of K2's op streams and the pairs' raw
   bytes (with lowercase and N bytes), the counts and every run exactly
   equal, with kernel, twin and bound times, and on its hand-built edge
   inputs (sim.cigar_edge_case, whole and from their second row: the last
   non-zero step at block edges, all-zero rows, bad streams, B = 1 and
   one over the kernel's changes of warps a pair, every bucket pair the
   main path and --preset ccs launch); then K5 snp_dense_pileup against
   its plain twin at B = 4096 and R = 160 and 64 on random dense batches
   (deep rows, reads masked off), both outputs exactly equal, with
   kernel, twin and bound times, and on its edge inputs
   (sim.dense_edge_case: R around a byte counter's range and a 16-byte
   load, one row, counts equal to R); then the launch floor (a one-cycle
   spin kernel timed as the kernels are);
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
   atol 2e-5, B = 4096; then (6b, alone with `python3 chip_smoke.py
   --k6`) K6 snp_trunk against its plain twin (within 1e-5, two launches
   bit-identical) at 4,096 and 2,704 rows, with kernel, twin, cuDNN
   trunk and bound times, and the SNP forward with K6 and with the cuDNN
   trunk;
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
   cohort, K1, K2 and K4 on every indel chunk) and on cpu: SNP calling,
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
   card and runs K3, the SNP CNN, finish_indel_jobs (K1, K2 and K4 over
   every pending chunk's pairs) and the indel CNN. Runs: cuda --cpu 1
   (wall only), cuda --cpu N with the counters reset just before and
   read just after (K1, K2, K3 and K4 must all launch; launches and pairs
   by kernel and bucket printed, and the split of `indel.align_finish`:
   encoding, K1/K2/K4 with their copies, MSA projection, allele round;
   the cpu --cpu N run's split too, with the CPU settings it ran with:
   intra-op threads, OpenMP wait policy, cores)
   while nvidia-smi's compute apps and the workers' memory maps are
   polled (no process but this one may hold a CUDA context, and no
   worker may map libcuda), a second cuda --cpu N run (byte-identical
   VCFs) that must make no call to the host walk (`_walk_to_cigar`,
   `refine_diag_ops`) and copy no op stream of K2 to the host, cpu
   --cpu N (the same chunks;
   the records by phase 9's rules, hiq sets, phase maps and artifacts);
   the cuda --cpu 1 run's records too, by the same rules, where --cpu 1
   and --cpu N cut the same chunks;
   the stage timeline must unlock a contig's indels before the last
   contig is phased; then the cuda --cpu N run under torch.profiler;
13. `--preset ccs --mode all --cpu 1` (PacBio: 260 bp of reference after
   a candidate, CCS packs) on the CRAM phase's 500 kb cut of phase 9's
   fixture, on cuda (counters reset just before, read just after) and
   on cpu; the five VCFs by phase 9's rules, the hiq sets and phase maps
   identical; K1, K2 and K4 must launch in a bucket with R >= 256, their
   launches by bucket printed;
14. the per-chunk and dense SNP paths (phase_a2b), each cuda run with
   the counters reset just before and read just after (K3 by wire, group
   or chunk, and K5) and held by compare_records' rules against its cpu
   run and against the group path's run: phase 7's fixture under
   --no_snp_group_payload, snp_group_span = -1 (K3 on chunk wires only)
   and --no_dedup_transfer (K5 only); `--mode all --no_dedup_transfer`
   on phase 11's 500 kb cut; a 500 kb contig of 1 kb reads at 80x
   (~40,000 reads, over the group payload's read cap on its own) with
   its route, S, N and S x N printed, at maxcov 160 (K3 on its chunk
   wire), at --maxcov 48 (every row deep) and with _TABLE_CELL_CAP
   lowered under its S x N (K5), K3 against its twin at that chunk's
   cohorts, timed, and the chunk's x by the three routes (a group of
   one, its chunk wire, its dense batch) bit for bit; K5 against its
   twin, exactly, and timed, on the largest batch the --no_dedup_transfer
   run launched it on (the kernels line's K5 row) and on the over-caps
   chunk's dense batches.

15. several processes and devices (phase_dist) on phase 12's fixture,
   every run at --cpu 4 (so that every run cuts the same 500 kb
   chunks), each cuda run with the counters reset just before and read
   just after: (a) one process; (b) `--coordinator localhost:P
   --num_processes 2 --process_id i` as two concurrent processes of this
   script (`--cli-child`) on this card, joined by Gloo, process 0 taking
   chr1 and chrX and process 1 chr2 (shard_regions), while nvidia-smi
   and the maps of both processes' workers are polled (two device owners
   at most, no worker mapping libcuda): process 0's merged five VCFs
   record for record against (a) (compare_records; the rounding cases
   counted), the summed K1/K2/K4 pairs and K3 rows equal to (a)'s, and
   `global_counts` in both metrics.host00i.json equal to (a)'s counts,
   with each process's start-up (spawn to a CUDA context), Gloo connect
   and run times; (c) `--num_shards 2 --shard_index 0|1` one after the
   other, then `--merge_shards`, held as (b); (d) `--num_shards 2` on
   phase 11's 500 kb cut, which shard_regions splits into two 250 kb
   pieces, cuda against cpu; (e) two replicas on this card
   (sharding.inference_devices monkeypatched to [cuda:0, cuda:0], a
   per-device batch of DP_BATCH rows): the SNP group, chunk and dense
   routes' and the indel CNN's probabilities equal to one replica's
   bit for bit, K3 and K5 launched once a cohort and replica;
16. training and the entry module (phase_train) on a 200 kb contig of
   phase 9's densities written by sim.write_train_fixture (untagged and
   haplotagged BAMs, the truth VCF of the planted variants): (a) the
   indel training examples on cuda (the launch counters reset just
   before and read just after: K1, K2 and K4, which must launch, by
   bucket), and on the first TRAIN_CHECK_LEN bp cuda's equal to cpu's
   in x, labels and positions; the SNP training examples; (b) one SNP
   step (B = 128) and one indel step (B = 64) from the same flax-like
   init and batch, cuda against cpu (loss within 2e-5, every gradient
   within rtol 1e-4 / atol 1e-6) and two cuda steps bit-identical, then
   each step's time by CUDA events over STEP_REPS steps (the SNP step
   also at B = 1024) and, under torch.profiler, the device's busy time
   and idle share a step; (c) three epochs of each trainer on cuda (the
   loss must fall; an epoch's wall and the share of it that builds the
   batches on the host), each last checkpoint through load_model into a
   forward, and the SNP training CLI (`python -m
   nanocaller_tpu_torch.train.train_snp`, with --train_coverage) end to
   end; (d) the sharded SNP step at world size 1 on NCCL, bit-identical
   to the unsharded step; (e) entry()'s forward at B = 1024 (K3 on the
   chunk wire, counter reset just before and read just after) against
   entry(device="cpu") within 2e-5, timed, and dryrun_multichip(1) (the
   sharded step, the sharded inference, the real --mode all --cpu 2
   pipeline, whose VCFs must carry calls);
17. the user tools and the one-chunk entry points (phase_tools_api):
   (a) `python -m nanocaller_tpu_torch.tools.bench_e2e` (E2E_ARGS: its
   simulate with --hp_profile, `--mode all --cpu 4` in a subprocess,
   vcf_compare) with --device cuda, then --device cpu on a fixture of the
   same bytes; its JSON line (walls, stage timers, F1) with the card's
   name and power limit and the CPU settings each run's CLI ran with,
   the two runs' five VCFs held record for record (compare_records)
   and the SNP F1 over 0.5; (b) snp_caller.call_chunk
   on one 500 kb chunk of phase 7's fixture (CHUNK_API_SNP), with
   dedup_transfer on (K3 on the chunk wire) and off (K5), and
   indel_caller.call_indel_chunk on one 100 kb chunk of phase 5's
   (CHUNK_API_INDEL; K1, K2, K4), each on cuda with the counters reset
   just before and read just after, and on cpu; the cuda lines against
   the cpu lines by compare_records' rules (compare_lines);
18. the stall watchdog (phase_watchdog) on phase 12's fixture at phase
   15's --cpu: a cold `--cli-child` run's time to its first beat (a
   heartbeat of its own) sets the window W (twice it, at least
   WATCHDOG_MIN_S). (a) `--cli-child --mode all` under the port's
   supervise in a process that loads no torch (`--supervise`), with a
   hook in the child only: after the first SNP manifest entry a kernel
   spins the card FREEZE_CYCLES and the host waits on it. The supervisor must kill that child once and the
   --resume relaunch exit 0, its five VCFs held record for record
   against phase 12's cuda run (byte equality with phase 15(a) printed);
   while nvidia-smi and the maps of the supervisor and its children are
   polled: the supervisor never maps libcuda or libtorch, at most one
   child holds a CUDA context at a time, and the killed child's context
   leaves nvidia-smi's list before the new child makes one. It prints
   the heartbeat's age at the kill, the seconds from the kill to the new
   child's CUDA context, the resumed run's wall against phase 12's and
   phase 15(a)'s, and the resumed child's launches (the kernels line's
   `all_cpuN_watchdog`). (b) two `python -m nanocaller_tpu_torch.cli
   --watchdog W --num_processes 2` processes; process 1's child is
   SIGKILLed once its first SNP chunk is in its manifest. Both
   supervisors must end within (1 + retries) x (W + poll) + 60 s of the
   kill (recovered, or a clean exit), never mapping libcuda or libtorch,
   and a --resume relaunch of both must exit 0 with merged VCFs held
   contig by contig against phase 15(a)'s.

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
# the float32 FMA peak outside the tensor cores (NVIDIA's data sheet)
FP32_FLOP_PER_S = 67e12
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
# int32 operations a serial run-length scan of K2's stream needs (the
# function's work, not K4's ballot bookkeeping), one each: per op-stream
# byte the load address, the zero test and the loop step; per non-zero op
# the code tests (two), the bound test, the index increment, for a
# diagonal the byte compare and the "ACGT" test, the run compare, and the
# length increment or the packed store
K4_OPS_PER_BYTE = 3
K4_OPS_PER_OP = 8
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
# int32 operations per read K5 needs, one each: its mask test and its
# centre code's < 4 test (whether the read is counted)
K5_OPS_PER_READ = 2
# int32 operations per code of a counted read: its < 4 test
K5_OPS_PER_CODE = 1
# the SNP slice's K3 launches: one diploid cohort for each of its five
# decode groups (no deep row at maxcov 160)
SNP_LAUNCHES = 5
# K5's random timed shapes: rows (the SNP CNN's batch) and read-axis sizes
K5_B = 4096
K5_R = (160, 64)
# phase 14's over-caps contig: one 500 kb contig of 1 kb reads at 80x
# (about 40,000 reads, over the group payload's read cap on its own), a
# planted SNP every 1,000 bp from 2 kb to 498 kb, run on the region the
# SNPs span (its reads cover every candidate fully; the scan window still
# holds every read), and --maxcov 48, under every candidate's depth
CAPS_FIXTURE_LEN = 500_000
CAPS_REGION = "chr_t:2001-498000"
CAPS_MAXCOV = 48
BUCKETS = [(192, 192), (256, 192), (256, 320), (512, 512)]
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
# the pileup's centre column, the candidate site, and its width
CENTER_COL = 20
WIDTH = 41
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
# phase 15's --cpu: get_chunks cuts min(500,000, total / cpu + 1) bp
# chunks, so at 4 the whole fixture (4.5 Mb) and each process's share
# (chr1 + chrX 2.5 Mb, chr2 2 Mb) all chunk at 500,000: every run cuts
# the same chunks and calls the same records
DIST_CPU = 4
DIST_TIMEOUT_S = 300
DIST_VCFS = (("unfiltered.snps", "snp"), ("snps", "snp"),
             ("snps.phased", "snp"), ("indels", "indel"), ("", "any"))
# phase 15(e): the per-device CNN batch (cfg.batch_size) that spreads
# each cohort's rows over two replicas, and the indel CNN's random rows
DP_BATCH = 256
DP_INDEL_ROWS = 1000
# phase 16: the training fixture (phase 9's densities on a contig cut to
# keep example generation near 20 s on the host), the training CLIs'
# default batch sizes, the trainers' epochs and the timed steps
TRAIN_LEN = 200_000
TRAIN_SEED = 1616
# the indel examples' cuda run against the plain twins on the cpu, on
# the contig's first 50 kb (the twins take ~0.3 s a kb on the card's host)
TRAIN_CHECK_LEN = 50_000
TRAIN_B = {"snp": 128, "indel": 64}
TRAIN_B_LARGE = 1024
TRAIN_EPOCHS = 3
STEP_REPS = 20
ENTRY_REPS = 10
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# phase 17: the bench tool's fixture and run (half a megabase at 30x with
# the homopolymer profile, --mode all --cpu 4), and the one-chunk entry
# points' chunks: the second 500 kb chunk of phase 7's contig, and the
# second 100 kb chunk of phase 5's (as the CLI cuts both)
E2E_ARGS = ["--mb", "0.5", "--depth", "30", "--cpu", "4", "--hp_profile"]
E2E_TIMEOUT_S = 300
CHUNK_API_SNP = {"chrom": "chr_t", "start": 500_001, "end": 1_000_001,
                 "ploidy": "diploid"}
CHUNK_API_INDEL = {"chrom": "chr_t", "start": 100_001, "end": 200_001,
                   "ploidy": "diploid"}
# phase 18: the stall watchdog on phase 12's fixture at phase 15's --cpu.
# (a)'s frozen child spins the card 2**40 cycles (about 9 minutes at the
# H100's 1.98 GHz); the window is twice a cold child's time to its first
# beat, and at least WATCHDOG_MIN_S s. (b)'s survivors may each wait out
# (1 + retries) windows, so a longer one costs the phase four times over
FREEZE_CYCLES = 2 ** 40
WATCHDOG_MIN_S = 20
# supervise's retries and poll, as --watchdog runs it
WATCHDOG_RETRIES = 3
WATCHDOG_POLL_S = 2.0


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
    read window (the ref mutated at 10%) against its ref window. Returns
    the codes and lengths K1 and K2 take and the raw bytes K4 takes:
    a random code's byte is one of "ACGTN", lowercase one time in ten
    (K1's codes fold the case, K4 calls a/a 'X')."""
    import numpy as np

    from nanocaller_tpu_torch.align.batch_nw import encode_pairs, pad_bytes

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
    letters = np.frombuffer(b"ACGTNacgtn", np.uint8)
    qraw = letters[q + 5 * (rng.random(q.shape) < 0.1)]
    rraw = letters[r + 5 * (rng.random(r.shape) < 0.1)]
    qraw[B // 2:] = pad_bytes([a for a, _ in pairs], Q)[0]
    rraw[B // 2:] = pad_bytes([b for _, b in pairs], R)[0]
    return q, r, qlens, rlens, qraw, rraw


def nw_cases(rng):
    """Phase 2-3 inputs: (label, Q, R, B, scoring, inputs)."""
    from nanocaller_tpu_torch.align.batch_nw import encode_pairs, pad_bytes
    from nanocaller_tpu_torch.sim import TIE_KINDS, tie_heavy_pairs

    for Q, R in BUCKETS:
        inputs = nw_inputs(rng, B_NW, Q, R)
        for sname in SCORINGS:
            yield "bucket", Q, R, B_NW, sname, inputs
    for Q, R, B, sname in MAIN_LAUNCHES:
        yield "main_path", Q, R, B, sname, nw_inputs(rng, B, Q, R)
    for kind in TIE_KINDS:
        pairs = tie_heavy_pairs(rng, B_TIE, 192, 192, kind)
        inputs = (*encode_pairs(pairs, 192, 192),
                  pad_bytes([a for a, _ in pairs], 192)[0],
                  pad_bytes([b for _, b in pairs], 192)[0])
        for sname in SCORINGS:
            yield "ties_" + kind, 192, 192, B_TIE, sname, inputs


# K1, K2 and K4 by the names this script's counts give them
NW_NAMES = (("k1", "nw_tb"), ("k2", "nw_walk"), ("k4", "nw_cigar"))


def counter(prefix):
    """The sum of the port's counters (runtime/metrics.py) whose name
    starts with `prefix`, 0 if none was counted."""
    from nanocaller_tpu_torch.runtime.metrics import total

    return total(prefix)


def kernel_launches(kernel):
    """The launches of kernel "k1" ... "k5" in the port's counters."""
    return counter(kernel + ".launches")


def nw_buckets():
    """{"<kernel name> <Q>x<R>": [launches, pairs]} of K1, K2 and K4."""
    from nanocaller_tpu_torch.runtime.metrics import counters

    c, out = counters(), {}
    for k, kname in NW_NAMES:
        for name, n in counters(k + ".launches.").items():
            shape = name.rsplit(".", 1)[1]
            out["%s %s" % (kname, shape)] = [
                n, c.get("%s.pairs.%s" % (k, shape), 0)]
    return out


def reset_counters(*kernels):
    """Zero the port's counters of the kernels named ("k1" ... "k5")."""
    from nanocaller_tpu_torch.runtime import metrics

    metrics.reset_counters(tuple(k + "." for k in kernels))


def bound(nbytes, ops):
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def nw_counters():
    """K1, K2 and K4's launch counters, K1's pairs, and the launches and
    pairs of each kernel by bucket."""
    return {"NW_TB_LAUNCHES": kernel_launches("k1"),
            "NW_WALK_LAUNCHES": kernel_launches("k2"),
            "NW_CIGAR_LAUNCHES": kernel_launches("k4"),
            "NW_TB_PAIRS": counter("k1.pairs"),
            "nw_by_bucket": nw_buckets()}


def phase_kernels(K, rng):
    """Phases 2 and 3: K1, K2 and K4 against their twins, exact, with
    times."""
    import torch

    rows = []
    for label, Q, R, B, sname, (q, r, ql, rl, qraw, rraw) in nw_cases(rng):
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

        qr, rr = torch.from_numpy(qraw).cuda(), torch.from_numpy(rraw).cuda()
        runs, counts = K.nw_cigar(ops_k, qr, rr)
        w_runs, w_counts = K.nw_cigar_reference(ops_k, qr, rr)
        torch.cuda.synchronize()
        keep = torch.arange(Q + R, device="cuda")[None, :] < counts[:, None]
        if not torch.equal(counts, w_counts) or int(counts.min()) < 0 or \
                not torch.equal(torch.where(keep, runs, 0), w_runs):
            fail("K4 differs from its twin at %s" % shape)
        n_runs = int(counts.sum())
        ms = cuda_ms(lambda: K.nw_cigar(ops_k, qr, rr), 10)
        plain_ms = cuda_ms(lambda: K.nw_cigar_reference(ops_k, qr, rr), 1)
        row = {"phase": "K4_nw_cigar", **shape, "exact": True,
               "max_abs_err": 0, "runs": n_runs,
               "most_runs": int(counts.max()), "ms": ms,
               "plain_ms": plain_ms,
               **bound(B * T + B * (Q + R) + 4 * (n_runs + B),
                       B * T * K4_OPS_PER_BYTE + int(nz.sum())
                       * K4_OPS_PER_OP)}
        emit(row)
        rows.append(row)
        del tb, ops_k, twin_k, cur, runs, w_runs
    rows += phase_k4_edges(K)
    rows += phase_k5(rng)
    floor = cuda_ms(lambda: torch.cuda._sleep(1), 10)
    emit({"phase": "launch_floor", "launch_floor_ms": floor})
    return rows


def phase_k4_edges(K):
    """Phase 3, K4 on its hand-built edge inputs (sim.cigar_edge_case:
    last non-zero steps at 16-, 32- and 128-byte block edges, all-zero
    rows, bad streams faulting in the first, a middle and the last chunk,
    B = 1, B one over the kernel's changes of warps a pair and of waves,
    every bucket pair the main path, --preset ccs and training launch),
    whole and from their second row (op rows off the 16-byte grid): the
    counts and every run equal to the twin's, else fail."""
    import torch

    from nanocaller_tpu_torch.sim import CIGAR_EDGE_LABELS, cigar_edge_case

    rows = []
    for label in CIGAR_EDGE_LABELS:
        whole = [torch.from_numpy(a).cuda() for a in cigar_edge_case(label)]
        for view, args in (("whole", whole),
                           ("from_row_1", [a[1:] for a in whole])):
            if not len(args[0]):
                continue
            runs, counts = K.nw_cigar(*args)
            w_runs, w_counts = K.nw_cigar_reference(*args)
            torch.cuda.synchronize()
            keep = torch.arange(runs.shape[1], device="cuda")[None, :] < \
                counts[:, None]
            shape = {"inputs": "edge_" + label, "view": view,
                     "B": len(args[0]), "Q": args[1].shape[1],
                     "R": args[2].shape[1]}
            if not torch.equal(counts, w_counts) or not torch.equal(
                    torch.where(keep, runs, 0), torch.where(keep, w_runs, 0)):
                fail("K4 differs from its twin at %s" % shape)
            row = {"phase": "K4_nw_cigar_edge", **shape, "exact": True,
                   "max_abs_err": 0, "bad_rows": int((counts < 0).sum()),
                   "runs": int(counts.clamp(min=0).sum())}
            emit(row)
            rows.append(row)
    return rows


def k5_work(args):
    """The bytes and int32 operations K5's function needs on these inputs
    (codes, read_mask, col_ref, col_valid, center_ref, norm): every mask
    byte; the centre code of each masked-in read, and the other 40 codes
    of each counted read (masked in, centre code 0-3), the only codes
    that reach the counts; col_ref, col_valid, center_ref and norm; x and
    the ref one-hot written. Returns (bytes, operations, counted reads,
    counted cells)."""
    codes, mask = args[0], args[1].bool()
    B, R = mask.shape
    centre = codes[:, :, CENTER_COL]
    counted = mask & (centre >= 0) & (centre < 4)
    reads = int(counted.sum())
    c = codes[counted]
    cells = int(((c >= 0) & (c < 4)).sum())
    nbytes = (args[1].numel() * args[1].element_size() + int(mask.sum())
              + (WIDTH - 1) * reads
              + sum(t.numel() * t.element_size() for t in args[2:])
              + B * 5 * WIDTH * 5 * 4 + B * 4 * 4)
    ops = (B * R * K5_OPS_PER_READ + reads * WIDTH * K5_OPS_PER_CODE
           + cells * K3_OPS_PER_COUNT)
    return nbytes, ops, reads, cells


def k5_row(label, args):
    """K5 against its plain twin on the card tensors `args`, both outputs
    torch.equal (else fail), with kernel, twin and bound times; emits
    and returns the row, and K5's x."""
    import torch

    from nanocaller_tpu_torch.pileup import snp_dense as K5

    with torch.inference_mode():
        outs = K5.snp_dense_pileup(*args)
        twins = K5.snp_dense_pileup_reference(*args)
        torch.cuda.synchronize()
        B, R = args[1].shape
        shape = {"inputs": label, "B": B, "R": R}
        if not all(o.shape == w.shape and o.dtype == w.dtype and
                   torch.equal(o, w) for o, w in zip(outs, twins)):
            errs = [float((o - w).abs().max()) for o, w in zip(outs, twins)]
            fail("K5 differs from its twin at %s (max err x %g, ref %g)"
                 % (shape, *errs))
        nbytes, ops, reads, cells = k5_work(args)
        ms = cuda_ms(lambda: K5.snp_dense_pileup(*args), 10)
        plain_ms = cuda_ms(lambda: K5.snp_dense_pileup_reference(*args), 1)
    row = {"phase": "K5_snp_dense_pileup", **shape, "exact": True,
           "max_abs_err": 0.0, "ref_max_abs_err": 0.0,
           "masked_in_reads": int(args[1].sum()), "counted_reads": reads,
           "counted_cells": cells, "bytes": nbytes, "ms": ms,
           "plain_ms": plain_ms, **bound(nbytes, ops)}
    row["share_of_bound"] = row["bound_ms"] / ms
    emit(row)
    return row, outs[0]


def phase_k5(rng):
    """Phase 3, K5 snp_dense_pileup against its plain twin (k5_row) at
    B = K5_B rows and each read-axis size of K5_R, on random dense
    batches with deep rows (every read in) and reads masked off with
    codes (sim.random_dense_batch); then on its edge inputs
    (sim.dense_edge_case: R = 0, 1, 15, 17, 224, 225, 255, 256, 300 at
    B = 133, one row, columns whose count is R), whole and from their
    second row, both outputs equal to the twin's, else fail."""
    import torch

    from nanocaller_tpu_torch.pileup import snp_dense as K5
    from nanocaller_tpu_torch.sim import (DENSE_EDGE_LABELS, dense_edge_case,
                                          random_dense_batch)

    rows = []
    for R in K5_R:
        host = random_dense_batch(rng, K5_B, R)
        args = [torch.from_numpy(a).cuda() for a in host]
        rows.append(k5_row("random_dense", args)[0])
        del args
    for label in DENSE_EDGE_LABELS:
        whole = [torch.from_numpy(a).cuda() for a in dense_edge_case(label)]
        for view, args in (("whole", whole),
                           ("from_row_1", [a[1:] for a in whole])):
            if not len(args[0]):
                continue
            with torch.inference_mode():
                outs = K5.snp_dense_pileup(*args)
                twins = K5.snp_dense_pileup_reference(*args)
                torch.cuda.synchronize()
            shape = {"inputs": "edge_" + label, "view": view,
                     "B": len(args[0]), "R": args[0].shape[1]}
            if not all(o.shape == w.shape and torch.equal(o, w)
                       for o, w in zip(outs, twins)):
                fail("K5 differs from its twin at %s" % shape)
            row = {"phase": "K5_snp_dense_pileup_edge", **shape,
                   "exact": True, "max_abs_err": 0.0}
            emit(row)
            rows.append(row)
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


def compare_records(a, b, kind, by_contig=False):
    """The cuda and cpu VCFs a and b record by record, by the SNP rules
    (kind "snp"), the indel rules ("indel") or, in a VCF of both, each
    record's own ("any": SNP records carry FQ). by_contig: each file's
    records grouped by contig name first (a merge of region shards lists
    the contigs shard by shard). Returns (records, the one-unit rounding
    cases)."""
    ra, rb = _records(a), _records(b)
    if by_contig:
        ra, rb = (sorted(r, key=lambda x: x[0]) for r in (ra, rb))
    return _compare_fields(ra, rb, kind, os.path.basename(a))


def compare_lines(a, b, kind, label):
    """compare_records on two lists of VCF body lines (call_chunk's and
    call_indel_chunk's output)."""
    split = lambda lines: [l.rstrip("\n").split("\t") for l in lines]
    return _compare_fields(split(a), split(b), kind, label)


def _compare_fields(ra, rb, kind, label):
    if len(ra) != len(rb):
        fail("%s: cuda VCF has %d records, cpu VCF %d"
             % (label, len(ra), len(rb)))
    diffs = []
    for x, y in zip(ra, rb):
        snp = kind == "snp" or (kind == "any" and "FQ=" in x[7])
        diffs.extend((_snp_record if snp else _indel_record)(x, y))
    return len(ra), diffs


def phase_slice(tmp):
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
        reset_counters("k1", "k2", "k4")
        t0 = time.perf_counter()
        outputs = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = nw_counters()
        with open(os.path.join(out, "metrics.json")) as fh:
            metrics = json.load(fh)
        runs[dev] = (outputs["indels"], wall, counts, metrics)
    vcf_cuda, wall, counts, metrics = runs["cuda"]
    if min(counts[k] for k in ("NW_TB_LAUNCHES", "NW_WALK_LAUNCHES",
                               "NW_CIGAR_LAUNCHES")) < 1:
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
                                               "nw_walk_kernel",
                                               "nw_cigar_kernel"))
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
    return counts, fasta_p, bam_p


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


def snp_model_on_card(pack="ONT-HG002"):
    """The SNPModel of `pack` on the card, in eval mode."""
    from nanocaller_tpu_torch.models import (SNPModel, load_model,
                                             torch_state_dict_from_params)

    m = SNPModel()
    m.load_state_dict(torch_state_dict_from_params(load_model("snp", pack)[0]))
    return m.to("cuda").eval()


def k6_rows(m, snp_trunk, label, Bs=(4096, 2704), reps=20):
    """K6 (`snp_trunk(x, packed)`, the port's wrapper or another build of
    the kernel) at the SNP CNN's slice sizes on model m's weights: its
    time by CUDA events, its bound by operations (models/snp_trunk.py:
    3,286,112 FLOP a row over the float32 FMA peak) and by bytes, the
    plain twin's time, the cuDNN trunk's (the module's nn.Conv2d chain,
    `conv_trunk`, the library yardstick), the largest gap to the twin on
    uniform [0, 1) rows and whether two launches give equal bits."""
    import torch

    from nanocaller_tpu_torch.models import snp_trunk as K6

    packed = m.trunk_weights()
    rows = []
    g = torch.Generator(device="cuda").manual_seed(6)
    for B in Bs:
        x = torch.rand((B, 5, 41, 5), device="cuda", generator=g)
        with torch.inference_mode():
            got = snp_trunk(x, packed)
            again = snp_trunk(x, packed)
            want = K6.snp_trunk_reference(x, packed)
            torch.cuda.synchronize()
            row = {"phase": "K6_snp_trunk", "kernel": label, "B": B,
                   "max_abs_err": float((got - want).abs().max()),
                   "repeat_equal": bool(torch.equal(got, again)),
                   "ms": cuda_ms(lambda: snp_trunk(x, packed), reps),
                   "plain_ms": cuda_ms(
                       lambda: K6.snp_trunk_reference(x, packed), reps),
                   "library_ms": cuda_ms(lambda: m.conv_trunk(x), reps)}
        flop = 3_286_112 * B
        b_ops = flop / FP32_FLOP_PER_S * 1e3
        b_bytes = ((4100 + 6912) * B + 4 * K6.PACKED_SIZE) \
            / HBM_BYTES_PER_S * 1e3
        row.update(bound_ms=max(b_ops, b_bytes),
                   bound_by="operations" if b_ops >= b_bytes else "bytes",
                   gflop_per_s=flop / row["ms"] / 1e6)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        emit(row)
    return rows


def phase_k6():
    """Phase 6b: K6 snp_trunk against its plain twin and the cuDNN trunk
    at the SNP CNN's slice sizes (k6_rows), and the whole SNP forward at
    4,096 rows with K6 (inference) and with the cuDNN trunk (grad mode
    on: the module's nn.Conv2d path)."""
    import torch

    from nanocaller_tpu_torch.models.snp_trunk import snp_trunk

    m = snp_model_on_card()
    rows = k6_rows(m, snp_trunk, "snp_trunk.cu")
    for r in rows:
        if r["max_abs_err"] > 1e-5 or not r["repeat_equal"]:
            fail("K6 at B=%d: max err %g, repeat equal %s"
                 % (r["B"], r["max_abs_err"], r["repeat_equal"]))
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((SNP_CNN_B, 5, 41, 5), device="cuda", generator=g)
    ref = torch.nn.functional.one_hot(torch.randint(
        0, 4, (SNP_CNN_B,), device="cuda", generator=g), 4).float()
    with torch.inference_mode():
        k6_ms = cuda_ms(lambda: m(x, ref), 20)
    with torch.enable_grad():
        cudnn_ms = cuda_ms(lambda: m(x, ref), 20)
    emit({"phase": "snp_forward", "B": SNP_CNN_B, "k6_ms": k6_ms,
          "cudnn_trunk_ms": cudnn_ms})
    return rows


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
        reset_counters("k1", "k2", "k3", "k4")
        t0 = time.perf_counter()
        outputs = cli.main(argv(dev, "snp_" + dev))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
                  "NW_TB_LAUNCHES": kernel_launches("k1")}
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
    reset_counters("k3")
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
          "launches": kernel_launches("k3"), **breakdown})
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
        for p, deep, args, _mi, _j, _r in pileup_cohorts(state, gf, cfg):
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
    return [k3_row(label, args, gf, e2e_launches)
            for label, args, gf in k3_cases(fasta_p, bam_p)]


def k3_row(label, args, gf, e2e_launches):
    """One K3 launch's row: K3 against its twin (all three outputs
    exactly equal; else fail), its work (k3_work), kernel, twin and
    bound times and the time of the torch neighbour selection on the
    same rows."""
    import torch

    from nanocaller_tpu_torch.pileup import snp_pileup as K3

    wire, rids = args[0], args[6]
    outs = K3.snp_pileup(*args)
    twins = K3.snp_pileup_reference(*args)
    torch.cuda.synchronize()
    B = outs[0].shape[0]
    shape = {"inputs": label, "wire": wire.kind, "B": B, "N": wire.n_reads,
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
    # the torch neighbour selection K3's own replaced, on the same rows
    # (its band table read on the host once, as the schedule was): ~200
    # small launches a call, ~2 ms of host time, so two calls behind a
    # long spin, which the launch queue holds whole
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
    return row


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
    from nanocaller_tpu_torch.io.bam import BamReader
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
        reset_counters("k1", "k2", "k3", "k4")
        t0 = time.perf_counter()
        outputs = cli.main(argv(dev, "all_" + dev))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
                  **nw_counters()}
        with open(os.path.join(tmp, "all_" + dev, "metrics.json")) as fh:
            metrics = json.load(fh)
        runs[dev] = (outputs, wall, counts, metrics)
    outs, wall, counts, metrics = runs["cuda"]
    n_chunks = metrics["counts"].get("indel_chunks", 0)
    if counts["SNP_PILEUP_LAUNCHES"] != cohorts:
        fail("--mode all launched K3 %d times, not once a cohort (%d)"
             % (counts["SNP_PILEUP_LAUNCHES"], cohorts))
    # every 100 kb chunk of this fixture holds planted indels, so each
    # aligns its candidates' reads through K1, K2 and K4
    if n_chunks < 2 or min(counts[k] for k in (
            "NW_TB_LAUNCHES", "NW_WALK_LAUNCHES",
            "NW_CIGAR_LAUNCHES")) < n_chunks:
        fail("--mode all launched K1 %d, K2 %d and K4 %d times for %d indel "
             "chunks" % (counts["NW_TB_LAUNCHES"], counts["NW_WALK_LAUNCHES"],
                         counts["NW_CIGAR_LAUNCHES"], n_chunks))
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
    reset_counters("k1", "k2", "k3", "k4")
    prof, kern, dev = profile_slice(
        cli, argv("cuda", "all_prof"),
        ("nw_tb_rows_kernel", "nw_tb_wave_kernel", "nw_walk_kernel",
         "nw_cigar_kernel", "snp_pileup_kernel"))
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
          "launches_k3": kernel_launches("k3"),
          "launches_k1": kernel_launches("k1")})
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
            reset_counters("k3")
            t0 = time.perf_counter()
            call_snps(cfg, bam, regions, [dict(m) for m in group], out)
            runs[name] = (kernel_launches("k3"), time.perf_counter() - t0,
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
    return fasta_p, bam_p


def write_caps_fixture(tmp):
    import numpy as np

    from nanocaller_tpu_torch.io.fasta import write_fasta
    from nanocaller_tpu_torch.sim import (BASES, make_diploid_readset,
                                          random_seq, write_bam)

    rng = np.random.default_rng(2027)
    L = CAPS_FIXTURE_LEN
    ref = random_seq(rng, L)
    snps = []
    for k, p in enumerate(range(2000, L - 2000, 1000)):
        alt = BASES[(BASES.index(ref[p]) + 1 + k % 3) % 4]  # never the ref
        snps.append((p, alt, ("het1", "het2", "hom")[k % 3]))
    reads = make_diploid_readset(rng, ref, snps=snps, depth=80,
                                 read_len=1000, error_rate=0.03,
                                 indel_error_rate=0.01)
    fasta_p = os.path.join(tmp, "caps_ref.fa")
    bam_p = os.path.join(tmp, "caps_reads.bam")
    write_fasta(fasta_p, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads)
    return fasta_p, bam_p, len(snps), len(reads)


def x_routes(state, cfg, bam_p, fasta_p, member, maxcov, feats):
    """The CNN input x of one chunk's candidates by the three SNP routes
    on the card: a group of one (K3 on its group wire, the read cap
    raised for the build), the chunk's SnpChunkFeatures `feats` (K3 on
    its chunk wire) and its dense SnpBatch (K5, held against its twin on
    the same card tensors and timed, k5_row), at the chunk's coverage
    scale: torch.equal, else fail. Returns K5's row."""
    import numpy as np
    import torch

    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.pileup import snp_features as SF
    from nanocaller_tpu_torch.pileup import snp_pileup as K3
    from nanocaller_tpu_torch.snp_caller import (_coverage_norm,
                                                 chunk_cohorts,
                                                 pileup_cohorts)

    kw = dict(maxcov=maxcov, seq_type=cfg.sequencing, mincov=cfg.mincov,
              min_allele_freq=cfg.min_allele_freq,
              min_nbr_sites=cfg.min_nbr_sites, threshold=cfg.threshold)
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    saved = SF._GROUP_MAX_READS
    SF._GROUP_MAX_READS = feats.n_reads
    try:
        [gf] = SF.get_snp_group_payloads(bam, fasta, [member], **kw)
    finally:
        SF._GROUP_MAX_READS = saved
    gf.members = [(0, sec) for _m, sec in gf.members]
    batch = SF.get_snp_candidates(bam, fasta, member, **kw)
    B = len(feats)
    dev = state.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    xs = {r: torch.zeros((B, 5, WIDTH, 5), device=dev)
          for r in ("group", "chunk")}
    for _p, _deep, args, _mi, js, _r in pileup_cohorts(state, gf, cfg):
        xs["group"][t(js)] = K3.snp_pileup(*args)[0]
    for _deep, args, rows, _r in chunk_cohorts(state, feats, cfg,
                                                 "diploid"):
        xs["chunk"][t(rows)] = K3.snp_pileup(*args)[0]
    k5, xs["dense"] = k5_row("caps_dense_maxcov%d" % maxcov, [
        t(batch.codes), t(batch.read_mask), t(batch.col_ref),
        t(batch.col_valid), t(batch.center_ref),
        t(_coverage_norm(state, feats, "diploid", cfg))])
    torch.cuda.synchronize()
    equal = torch.equal(xs["group"], xs["chunk"]) and \
        torch.equal(xs["chunk"], xs["dense"])
    emit({"phase": "a2b_x_routes", "maxcov": maxcov, "rows": B,
          "deep_rows": len(feats.deep_idx), "group_wire_reads": gf.n_reads,
          "x_bit_identical": equal})
    if not equal:
        fail("x differs across the SNP routes at maxcov %d" % maxcov)
    return k5


def phase_a2b(tmp, snp_fasta, snp_bam, cut_fasta, cut_bam):
    """Phase 14: the per-chunk and dense SNP paths on the card, each run
    with the counters reset just before and read just after (K3 launches
    by wire, group or chunk, and K5's), held by compare_records' rules
    cuda against cpu and against the group path's run:
    (a) phase 7's SNP fixture under --no_snp_group_payload,
        snp_group_span = -1 and --no_dedup_transfer (K3 on chunk wires,
        K3 on chunk wires, K5), against phase 7's cuda run;
    (b) `--mode all --no_dedup_transfer` on phase 11's 500 kb cut (K5,
        K1, K2, K4), the five VCFs against phase 11's BAM run;
    (c) a chunk over the group payload caps on its own at the real
        _GROUP_MAX_READS (write_caps_fixture): its route (chunk or dense
        by S x N against _TABLE_CELL_CAP) and its S, N and S x N printed;
        then with --maxcov 48 (every row deep); then with _TABLE_CELL_CAP
        lowered under its S x N (dense, K5), against the first run; K3
        against its twin at the member's cohorts, timed; and its x by
        the three routes, bit for bit (x_routes).
    K5 is held against its twin, exactly, and timed (k5_row) on the
    largest dense batch the cuda run of (a) under --no_dedup_transfer
    gave it, and on the over-caps member's dense batches (x_routes).
    Returns {path: counters} of the cuda runs, the K3 rows of (c) and the
    K5 rows, the (a) run's first."""
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.caller import run
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.pileup import snp_features as SF
    from nanocaller_tpu_torch import snp_caller as SC
    from nanocaller_tpu_torch.snp_caller import SnpCallerState, chunk_cohorts

    t_phase = time.perf_counter()
    vcf = lambda out, name: os.path.join(tmp, out, "smoke.%s.vcf.gz" % name
                                         if name else "smoke.vcf.gz")
    snp_vcfs = (("unfiltered.snps", "snp"), ("snps", "snp"))
    all_vcfs = snp_vcfs + (("snps.phased", "snp"), ("indels", "indel"),
                           ("", "any"))

    def drive(label, bam_p, fasta_p, mode, dev, extra=(), span=None,
              capture=None):
        """One CLI run with the counters reset just before and read just
        after; with a dict `capture`, a copy of the inputs of the run's
        largest K5 launch goes into capture["args"]."""
        out = "a2b_%s_%s" % (label, dev)
        cfg = cli.config_from_args([
            "--bam", bam_p, "--ref", fasta_p, "--mode", mode, "--cpu", "1",
            "--device", dev, "--output", os.path.join(tmp, out), "--prefix",
            "smoke", "--sample", "S", "--suppress_progress_bar", *extra])
        if span is not None:
            cfg.snp_group_span = span
        reset_counters("k1", "k2", "k3", "k4", "k5")
        launch = SC.snp_dense_pileup
        if capture is not None:
            def keep(*args):
                if args[1].numel() > capture.get("cells", -1):
                    capture.update(cells=args[1].numel(),
                                   args=[a.clone() for a in args])
                return launch(*args)
            SC.snp_dense_pileup = keep
        t0 = time.perf_counter()
        try:
            run(cfg)
        finally:
            SC.snp_dense_pileup = launch
        wall = time.perf_counter() - t0
        counts = {"k3_group": counter("k3.launches.group"),
                  "k3_chunk": counter("k3.launches.chunk"),
                  "k5": kernel_launches("k5"),
                  "k1": kernel_launches("k1"), "k2": kernel_launches("k2"),
                  "k4": kernel_launches("k4")}
        if dev == "cpu" and any(counts.values()):
            fail("the cpu run %s launched a CUDA kernel: %s" % (out, counts))
        return out, wall, counts

    def held(label, a, b, names):
        """compare_records of each VCF of runs a and b; one line."""
        records, cases = {}, []
        for name, kind in names:
            records[name], diffs = compare_records(vcf(a, name),
                                                   vcf(b, name), kind)
            cases += [dict(d, vcf=name) for d in diffs]
        emit({"phase": "a2b_held", "runs": label, "a": a, "b": b,
              "records": records, "rounding_cases": len(cases),
              "first_cases": cases[:5]})
        return records

    def expect(label, counts, **want):
        for k, v in want.items():
            if (counts[k] >= 1) if v == "some" else (counts[k] == v):
                continue
            fail("phase 14 %s: %s launches %d, expected %s (%s)"
                 % (label, k, counts[k], v, counts))

    results = {}
    dense_batch = {}
    # (a) the SNP fixture under the three flags
    for label, extra, span, want in (
            ("chunk", ["--no_snp_group_payload"], None,
             dict(k3_group=0, k3_chunk="some", k5=0)),
            ("span", [], -1, dict(k3_group=0, k3_chunk="some", k5=0)),
            ("dense", ["--no_dedup_transfer"], None,
             dict(k3_group=0, k3_chunk=0, k5="some"))):
        cuda, wall, counts = drive(label, snp_bam, snp_fasta, "snps",
                                   "cuda", extra, span,
                                   dense_batch if label == "dense" else None)
        expect(label, counts, **want)
        cpu, cpu_wall, _ = drive(label, snp_bam, snp_fasta, "snps", "cpu",
                                 extra, span)
        recs = held("snps_%s cuda vs cpu" % label, cuda, cpu, snp_vcfs)
        held("snps_%s vs group (phase 7)" % label, cuda, "snp_cuda",
             snp_vcfs)
        results["snps_" + label] = counts
        emit({"phase": "a2b_snps", "path": label, "records": recs,
              "cuda_wall_s": wall, "cpu_wall_s": cpu_wall, **counts})
    k5_rows = [k5_row("snps_dense_run", dense_batch.pop("args"))[0]]

    # (b) --mode all --no_dedup_transfer on the 500 kb cut
    cuda, wall, counts = drive("all_dense", cut_bam, cut_fasta, "all",
                               "cuda", ["--no_dedup_transfer"])
    expect("all_dense", counts, k3_group=0, k3_chunk=0, k5="some",
           k1="some", k2="some", k4="some")
    cpu, cpu_wall, _ = drive("all_dense", cut_bam, cut_fasta, "all", "cpu",
                             ["--no_dedup_transfer"])
    recs = held("all_dense cuda vs cpu", cuda, cpu, all_vcfs)
    held("all_dense vs group (phase 11)", cuda, "cram_all_bam", all_vcfs)
    results["all_dense"] = counts
    emit({"phase": "a2b_all_dense", "records": recs, "cuda_wall_s": wall,
          "cpu_wall_s": cpu_wall, **counts})

    # (c) a chunk over the caps on its own, at the real caps
    t0 = time.perf_counter()
    fasta_p, bam_p, n_snps, n_reads = write_caps_fixture(tmp)
    t_fixture = time.perf_counter() - t0
    contig, span = CAPS_REGION.split(":")
    lo, hi = map(int, span.split("-"))
    member = {"chrom": contig, "start": lo, "end": hi, "ploidy": "diploid"}
    state = SnpCallerState.create("ONT-HG002", device="cuda")
    cfg = cli.config_from_args(["--bam", bam_p, "--ref", fasta_p])
    feats = {}
    for maxcov in (cfg.maxcov, CAPS_MAXCOV):
        [p] = SF.get_snp_group_payloads(
            BamReader(bam_p), FastaFile(fasta_p), [member],
            maxcov=maxcov, seq_type=cfg.sequencing, mincov=cfg.mincov,
            min_allele_freq=cfg.min_allele_freq,
            min_nbr_sites=cfg.min_nbr_sites, threshold=cfg.threshold)
        if not isinstance(p, tuple):
            fail("the over-caps chunk went as a group payload")
        feats[maxcov] = p[1]
    f = feats[cfg.maxcov]
    route = "chunk" if isinstance(f, SF.SnpChunkFeatures) else "dense"
    scan = SF._scan_chunk(BamReader(bam_p), FastaFile(fasta_p), member)
    S, N = len(scan.union_sites), scan.rw.n_reads
    cells = (S + 1) * N
    emit({"phase": "a2b_caps_member", "contig_bp": CAPS_FIXTURE_LEN,
          "region": CAPS_REGION, "reads": n_reads, "planted_snps": n_snps,
          "fixture_s": t_fixture, "route": route, "S": S, "N": N,
          "S_x_N": S * N, "table_cells": cells,
          "group_max_reads": SF._GROUP_MAX_READS,
          "table_cell_cap": SF._TABLE_CELL_CAP, "candidates": len(f),
          "deep_rows_at_maxcov_48": len(feats[CAPS_MAXCOV].deep_idx)
          if route == "chunk" else None})
    if N <= SF._GROUP_MAX_READS:
        fail("the over-caps chunk has %d reads, not over the cap %d"
             % (N, SF._GROUP_MAX_READS))
    if route == "chunk" and \
            len(feats[CAPS_MAXCOV].deep_idx) != len(feats[CAPS_MAXCOV]):
        fail("at --maxcov %d not every row of the over-caps chunk is deep"
             % CAPS_MAXCOV)
    extra = ["--regions", CAPS_REGION]
    k3_rows = []
    caps = {}
    for label, more, want in (
            ("caps", [], dict(k3_group=0, k3_chunk=1, k5=0)
             if route == "chunk" else dict(k3_group=0, k3_chunk=0, k5=1)),
            ("caps_deep", ["--maxcov", str(CAPS_MAXCOV)],
             dict(k3_group=0, k3_chunk=1, k5=0)
             if route == "chunk" else dict(k3_group=0, k3_chunk=0, k5=1))):
        cuda, wall, counts = drive(label, bam_p, fasta_p, "snps", "cuda",
                                   extra + more)
        expect(label, counts, **want)
        cpu, cpu_wall, _ = drive(label, bam_p, fasta_p, "snps", "cpu",
                                 extra + more)
        recs = held("%s cuda vs cpu" % label, cuda, cpu, snp_vcfs)
        results[label] = counts
        caps[label] = cuda
        emit({"phase": "a2b_caps_run", "run": label, "records": recs,
              "cuda_wall_s": wall, "cpu_wall_s": cpu_wall, **counts})
    if route == "chunk":
        saved = SF._TABLE_CELL_CAP
        SF._TABLE_CELL_CAP = cells - 1
        try:
            cuda, wall, counts = drive("caps_dense", bam_p, fasta_p, "snps",
                                       "cuda", extra)
        finally:
            SF._TABLE_CELL_CAP = saved
        expect("caps_dense", counts, k3_group=0, k3_chunk=0, k5=1)
        held("caps_dense vs caps (chunk)", cuda, caps["caps"], snp_vcfs)
        results["caps_dense"] = counts
        emit({"phase": "a2b_caps_run", "run": "caps_dense",
              "table_cell_cap": cells - 1, "cuda_wall_s": wall, **counts})
        for maxcov, label in ((cfg.maxcov, "caps_chunk"),
                              (CAPS_MAXCOV, "caps_chunk_maxcov48")):
            run_label = "caps" if maxcov == cfg.maxcov else "caps_deep"
            for deep, args, _rows, _r in chunk_cohorts(
                    state, feats[maxcov], cfg, "diploid"):
                k3_rows.append(k3_row(
                    label + ("_deep" if deep else ""), args, feats[maxcov],
                    results[run_label]["k3_chunk"]))
            k5_rows.append(x_routes(state, cfg, bam_p, fasta_p, member,
                                    maxcov, feats[maxcov]))
    emit({"phase": "a2b", "wall_s": time.perf_counter() - t_phase,
          "launches": results})
    return results, k3_rows, k5_rows


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
    polls listed any) and the memory maps of the device owners' children
    (`owners`, this process by default; every child: one that loaded
    the CUDA driver maps libcuda).
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

    def __init__(self, period=0.25, fork_grace=2.0, owners=None):
        import threading

        # the device owners whose children are watched (this process by
        # default; phase 15's two --num_processes processes)
        self.owners = owners or [os.getpid()]
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
        mine = {o: _cmdline(o) for o in self.owners}
        while not self._stop.is_set():
            try:
                pids = set(_smi_apps())
                self.smi_pids |= pids
                self.smi_polls_with_pids += bool(pids)
            except (OSError, subprocess.SubprocessError):
                pass
            now = time.monotonic()
            for owner in self.owners:
                for c in _child_pids(owner):
                    self._check_child(c, mine[owner], now)
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

    def drive(dev, cpu, out, watch=None):
        reset_counters("k1", "k2", "k3", "k4")
        t0 = time.perf_counter()
        if watch:
            with watch:
                outputs = cli.main(argv(dev, cpu, out))
        else:
            outputs = cli.main(argv(dev, cpu, out))
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
                  **nw_counters()}
        with open(os.path.join(tmp, out, "metrics.json")) as fh:
            metrics = json.load(fh)
        return outputs, wall, counts, metrics, watch

    runs = {"cuda1": drive("cuda", 1, "dag_cuda1"),
            "cudaN": drive("cuda", n, "dag_cudaN", CudaContextWatch()),
            "cudaN_again": drive("cuda", n, "dag_cudaN_again",
                                 HostWalkWatch()),
            "cpuN": drive("cpu", n, "dag_cpuN")}
    outs, wall, counts, metrics, watch = runs["cudaN"]
    for k in ("SNP_PILEUP_LAUNCHES", "NW_TB_LAUNCHES", "NW_WALK_LAUNCHES",
              "NW_CIGAR_LAUNCHES"):
        if not counts[k] > 0:
            fail("--mode all --cpu %d did not launch %s" % (n, k))
    walk = runs["cudaN_again"][4]
    if walk.walk_calls or walk.op_copies or not walk.op_streams:
        fail("the cuda path called the host walk %d times and moved %d of "
             "K2's %d op streams" % (walk.walk_calls, walk.op_copies,
                                      walk.op_streams))
    split = lambda m: {k: v for k, v in m["timers_s"].items()
                       if k.startswith("indel.align_finish")}
    emit({"phase": "dag_align_finish_split", "cpu": n, **split(metrics),
          "walk_calls": walk.walk_calls, "op_stream_copies": walk.op_copies,
          "op_streams": walk.op_streams})
    # the cpu run: the same split (K1/K2/K4's plain twins under .kernels)
    # and the CPU settings this process ran them with
    cpu_metrics = runs["cpuN"][3]
    emit({"phase": "dag_cpu_align_finish_split", "cpu": n,
          "wall_s": runs["cpuN"][1], **split(cpu_metrics),
          "cpu_settings": cpu_metrics["cpu_settings"]})
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
    reset_counters("k1", "k2", "k3", "k4")
    prof, kern, dev = profile_slice(
        cli, argv("cuda", n, "dag_prof"),
        ("nw_tb_rows_kernel", "nw_tb_wave_kernel", "nw_walk_kernel",
         "nw_cigar_kernel", "snp_pileup_kernel"))
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
          "launches_k3": kernel_launches("k3"),
          "launches_k1": kernel_launches("k1"),
          "copies_us": sum(us for k, (us, _) in dev.items()
                           if "Memcpy" in k or "Memset" in k)})
    return counts, fasta_p, bam_p, wall


class HostWalkWatch:
    """While entered, counts the calls of the host walk K4 replaced
    (batch_nw._walk_to_cigar, batch_nw.refine_diag_ops), the op streams
    K2 returns to BatchAligner, and every move of such a stream off the
    card: Tensor.cpu, .to, .tolist, .item, .numpy on it, or Tensor.copy_
    from it."""

    def __enter__(self):
        import weakref

        import torch
        from nanocaller_tpu_torch.align import batch_nw

        self.walk_calls = self.op_streams = self.op_copies = 0
        live = {}

        def is_stream(t):
            ref = live.get(id(t))
            return ref is not None and ref() is t

        def walk(fn):
            def call(*a, **kw):
                self.walk_calls += 1
                return fn(*a, **kw)
            return call

        def stream(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                live[id(out)] = weakref.ref(out)
                self.op_streams += 1
                return out
            return call

        def move(fn, src=0):
            def call(*a, **kw):
                if len(a) > src and is_stream(a[src]):
                    self.op_copies += 1
                return fn(*a, **kw)
            return call

        wraps = [(batch_nw, "_walk_to_cigar", walk),
                 (batch_nw, "refine_diag_ops", walk),
                 (batch_nw, "nw_walk", stream),
                 (torch.Tensor, "copy_", lambda fn: move(fn, src=1))]
        wraps += [(torch.Tensor, name, move)
                  for name in ("cpu", "to", "tolist", "item", "numpy")]
        self._saved = [(owner, name, getattr(owner, name))
                       for owner, name, _ in wraps]
        for owner, name, wrap in wraps:
            setattr(owner, name, wrap(getattr(owner, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def phase_ccs(tmp, fasta_p, bam_p):
    """Phase 13: `--preset ccs --mode all --cpu 1` on the CRAM phase's
    500 kb BAM, on cuda (counters reset just before, read just after) and
    on cpu. The five VCFs by phase 9's rules, the hiq sets and phase maps
    identical; K1, K2 and K4 must launch in a bucket with R >= 256 (ccs
    reads 260 bp of reference after a candidate). Returns the cuda run's
    counters."""
    from nanocaller_tpu_torch import cli

    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, "ccs_" + dev)
        reset_counters("k1", "k2", "k3", "k4")
        t0 = time.perf_counter()
        outputs = cli.main([
            "--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu", "1",
            "--preset", "ccs", "--device", dev, "--output", out,
            "--prefix", "smoke", "--sample", "S", "--suppress_progress_bar"])
        wall = time.perf_counter() - t0
        counts = {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
                  **nw_counters()}
        with open(os.path.join(out, "metrics.json")) as fh:
            timers = json.load(fh)["timers_s"]
        runs[dev] = (outputs, wall, counts, timers)
    outs, wall, counts, timers = runs["cuda"]
    cpu_outs = runs["cpu"][0]
    if runs["cpu"][2]["NW_TB_LAUNCHES"] or runs["cpu"][2][
            "SNP_PILEUP_LAUNCHES"]:
        fail("the cpu ccs run launched a CUDA kernel")
    wide = {k.split()[0] for k, (n, _) in counts["nw_by_bucket"].items()
            if n and int(k.split()[1].split("x")[1]) >= 256}
    if wide != {"nw_tb", "nw_walk", "nw_cigar"}:
        fail("--preset ccs launched only %s in a bucket with R >= 256: %s"
             % (sorted(wide), counts["nw_by_bucket"]))
    records, cases = {}, []
    for name, key, kind in (("unfiltered", "snps", "snp"),
                            ("snps", "snps", "snp"),
                            ("snps.phased", "phased_snps", "snp"),
                            ("indels", "indels", "indel"),
                            ("final", "final", "any")):
        a, b = outs[key], cpu_outs[key]
        if name == "unfiltered":
            a, b = unf(a), unf(b)
        records[name], diffs = compare_records(a, b, kind)
        cases += [dict(d, vcf=name) for d in diffs]
    for d in cases:
        emit({"phase": "ccs_rounding_case", **d})
    sets = [_vcf_phase_sets(os.path.join(
        tmp, "ccs_" + dev, "intermediate_phase_files",
        "chr_t.snps.phased.vcf.gz")) for dev in ("cuda", "cpu")]
    if sets[0] != sets[1]:
        fail("the hiq set or phase map of the ccs runs differs")
    if records["snps"] < 100 or records["indels"] < 10:
        fail("too little was called with --preset ccs: %s" % records)
    emit({"phase": "ccs", "contig_bp": CRAM_FIXTURE_LEN, "records": records,
          "rounding_cases": len(cases), "cuda_wall_s": wall,
          "cpu_wall_s": runs["cpu"][1], "cuda_timers_s": timers,
          "cpu_timers_s": runs["cpu"][3], **counts})
    return counts


def _smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def kernel_counts():
    """Every kernel's launch counter, K1/K2/K4's pairs (summed over the
    buckets) and K3's rows, as a phase 15 run reads them."""
    pairs = {kname: counter(k + ".pairs") for k, kname in NW_NAMES
             if counter(k + ".pairs")}
    return {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
            "SNP_PILEUP_ROWS": counter("k3.rows"),
            "SNP_DENSE_LAUNCHES": kernel_launches("k5"),
            "NW_TB_LAUNCHES": kernel_launches("k1"),
            "NW_WALK_LAUNCHES": kernel_launches("k2"),
            "NW_CIGAR_LAUNCHES": kernel_launches("k4"),
            "pairs": pairs}


def cli_child(argv):
    """One process of phase 15(b) or an attempt of phase 18(a), started by
    this script with `--cli-child ARGV_JSON [--resume]` (a supervisor
    appends --resume to a relaunch): joins the process group, resets the
    counters, runs the CLI and prints one JSON line of its counters and
    times (spawn to a CUDA context, the Gloo connect, the run; the clock
    time of its CUDA context). With CHIP_SMOKE_FREEZE set, the run hangs
    on the card once (_install_freeze)."""
    t_spawn = float(os.environ["CHIP_SMOKE_T_SPAWN"])
    sys.path.insert(0, HERE)
    import torch
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.runtime import distributed

    imported = time.time() - t_spawn
    torch.zeros(1, device="cuda")
    ctx_at = time.time()
    startup = ctx_at - t_spawn
    if os.environ.get("CHIP_SMOKE_FREEZE"):
        _install_freeze(os.environ["CHIP_SMOKE_FREEZE"])
    cfg = cli.config_from_args(argv)
    t0 = time.perf_counter()
    distributed.initialize(cfg.coordinator, cfg.num_processes,
                           cfg.process_id)
    gloo = time.perf_counter() - t0
    reset_counters("k1", "k2", "k3", "k4", "k5")
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    emit({"process_id": cfg.process_id, "import_s": imported,
          "startup_s": startup, "gloo_init_s": gloo, "run_s": wall,
          "ctx_at": ctx_at, "resume": cfg.resume,
          "counts": kernel_counts()})
    return 0


def _sum_counts(counts):
    out = {"pairs": {}}
    for c in counts:
        for k, v in c.items():
            if k == "pairs":
                for kk, vv in v.items():
                    out["pairs"][kk] = out["pairs"].get(kk, 0) + vv
            else:
                out[k] = out.get(k, 0) + v
    return out


def _held(label, got, want, names=DIST_VCFS):
    """Each of got's five VCFs record for record against want's
    (compare_records' rules, contig by contig: the merge lists process
    0's contigs first); returns the rounding cases."""
    cases = []
    for name, kind in names:
        _, diffs = compare_records(got(name), want(name), kind,
                                   by_contig=True)
        cases += [dict(d, vcf=name, run=label) for d in diffs]
    for d in cases:
        emit({"phase": "dist_rounding_case", **d})
    return cases


def phase_dist(tmp, dag_fasta, dag_bam, cut_fasta, cut_bam):
    """Phase 15: multi-process, region-sharded and data-parallel runs of
    the main path on phase 12's fixture at --cpu 4 (see the module
    docstring). Returns the summed counters of (b)'s two processes."""
    from nanocaller_tpu_torch import cli

    t_phase = time.perf_counter()
    out = lambda name: os.path.join(tmp, "dist_" + name)

    def argv(bam_p, fasta_p, dest, dev="cuda", *extra):
        return ["--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu",
                str(DIST_CPU), "--haploid_X", "--device", dev, "--output",
                dest, "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar", *extra]

    vcf = lambda d: lambda name: os.path.join(
        d, "smoke.%s.vcf.gz" % name if name else "smoke.vcf.gz")

    def drive(args):
        reset_counters("k1", "k2", "k3", "k4", "k5")
        t0 = time.perf_counter()
        cli.main(args)
        return time.perf_counter() - t0, kernel_counts()

    # (a) one process
    wall_a, counts_a = drive(argv(dag_bam, dag_fasta, out("a")))
    with open(os.path.join(out("a"), "metrics.json")) as fh:
        metrics_a = json.load(fh)
    metrics_a, metrics_a_timers = metrics_a["counts"], metrics_a["timers_s"]

    # (b) two processes on this card, joined by Gloo
    coord = "localhost:%d" % _free_port()
    env = dict(os.environ, CHIP_SMOKE_T_SPAWN=repr(time.time()))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-child",
         json.dumps(argv(dag_bam, dag_fasta, out("b"), "cuda",
                         "--coordinator", coord, "--num_processes", "2",
                         "--process_id", str(i)))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    children, ends = [], {}
    try:
        with CudaContextWatch(owners=[p.pid for p in procs]) as watch:
            for i, p in enumerate(procs):
                o, e = p.communicate(timeout=DIST_TIMEOUT_S)
                ends[i] = time.perf_counter() - t0
                if p.returncode != 0:
                    fail("--num_processes 2: process %d exited %d: %s"
                         % (i, p.returncode, e[-3000:]))
                children.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_b = time.perf_counter() - t0
    counts_b = _sum_counts([c["counts"] for c in children])
    cases_b = _held("2proc", vcf(out("b")), vcf(out("a")))
    for key in ("SNP_PILEUP_ROWS", "pairs"):
        if counts_b[key] != counts_a[key]:
            fail("the two processes' %s (%s) are not the single run's (%s)"
                 % (key, counts_b[key], counts_a[key]))
    timers = {"a": metrics_a_timers}
    for i in range(2):
        with open(os.path.join(out("b"), "metrics.host%03d.json" % i)) as fh:
            m = json.load(fh)
        timers["b%d" % i] = m["timers_s"]
        if m.get("global_counts") != metrics_a or m.get("hosts") != 2:
            fail("metrics.host%03d.json: global_counts %s, hosts %s; the "
                 "single run counted %s" % (i, m.get("global_counts"),
                                            m.get("hosts"), metrics_a))
    if len(watch.smi_pids) > 2 or watch.cuda_children:
        fail("a process other than the two device owners held a CUDA "
             "context: nvidia-smi %s, workers mapping libcuda %s"
             % (sorted(watch.smi_pids), sorted(watch.cuda_children)))
    if len(watch.workers) < 2:
        fail("saw %d spawned worker processes under the two processes"
             % len(watch.workers))

    # (c) two shard runs one after the other, then --merge_shards
    t0 = time.perf_counter()
    counts_c = []
    for i in range(2):
        counts_c.append(drive(argv(dag_bam, dag_fasta, out("c"), "cuda",
                                   "--num_shards", "2", "--shard_index",
                                   str(i)))[1])
    cli.main(argv(dag_bam, dag_fasta, out("c"), "cuda", "--num_shards", "2",
                  "--merge_shards"))
    wall_c = time.perf_counter() - t0
    counts_c = _sum_counts(counts_c)
    cases_c = _held("shards", vcf(out("c")), vcf(out("a")))
    for key in ("SNP_PILEUP_ROWS", "pairs"):
        if counts_c[key] != counts_a[key]:
            fail("the two shard runs' %s (%s) are not the single run's (%s)"
                 % (key, counts_c[key], counts_a[key]))

    # (d) one contig split sub-contig: cuda shards against cpu shards
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.runtime.distributed import shard_regions
    from nanocaller_tpu_torch.runtime.chunker import get_regions_list

    regions = get_regions_list(cli.config_from_args(
        argv(cut_bam, cut_fasta, out("x"))), BamReader(cut_bam))
    pieces = [shard_regions(regions, i, 2) for i in range(2)]
    if [len(p) for p in pieces] != [1, 1]:
        fail("the 500 kb cut did not split into one piece a shard: %s"
             % pieces)
    walls_d = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        for i in range(2):
            cli.main(argv(cut_bam, cut_fasta, out("d_" + dev), dev,
                          "--num_shards", "2", "--shard_index", str(i)))
        cli.main(argv(cut_bam, cut_fasta, out("d_" + dev), dev,
                      "--num_shards", "2", "--merge_shards"))
        walls_d[dev] = time.perf_counter() - t0
    cases_d = _held("split", vcf(out("d_cuda")), vcf(out("d_cpu")))

    # (e) two replicas on this card
    dp = phase_dp(dag_fasta, dag_bam)
    emit({"phase": "dist", "cpu": DIST_CPU,
          "nvidia_smi": _smi_line(),
          "walls_s": {"a_1proc": wall_a, "b_2proc_whole": wall_b,
                      "b_2proc_ends": ends, "c_shards_and_merge": wall_c,
                      "d_split_cuda": walls_d["cuda"],
                      "d_split_cpu": walls_d["cpu"],
                      "phase": time.perf_counter() - t_phase},
          "b_processes": children, "timers_s": timers,
          "rounding_cases": {"b": len(cases_b), "c": len(cases_c),
                             "d": len(cases_d)},
          "d_pieces": pieces, "launches_a": counts_a,
          "launches_b": counts_b, "launches_c": counts_c,
          "global_counts": metrics_a,
          "workers_seen": len(watch.workers),
          "nvidia_smi_compute_pids": sorted(watch.smi_pids), **dp})
    return counts_b, wall_a


def phase_dp(fasta_p, bam_p):
    """Phase 15(e): the SNP group, chunk and dense routes and the indel
    CNN with two replicas on this card (sharding.inference_devices
    monkeypatched to [cuda:0, cuda:0]) against one replica: the
    probabilities equal bit for bit, K3 and K5 launched once a cohort
    and replica. A per-device batch of DP_BATCH rows spreads each cohort's
    rows over both replicas."""
    import numpy as np
    import torch
    from nanocaller_tpu_torch import indel_caller as I
    from nanocaller_tpu_torch import snp_caller as S
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.pileup import snp_features as sf
    from nanocaller_tpu_torch.runtime import sharding

    cfg = Config(bam=bam_p, ref=fasta_p, batch_size=DP_BATCH, device="cuda")
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    # the first two 500 kb chunks of chr1: a two-member decode group
    span = min(500_000, bam.get_reference_length("chr1") // 2)
    members = [{"chrom": "chr1", "start": 1 + k * span,
                "end": (k + 1) * span, "ploidy": "diploid"}
               for k in range(2)]
    [gf] = sf.get_snp_group_payloads(bam, fasta, members)
    gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
    feats = sf.get_snp_chunk_features(bam, fasta, members[0])
    batch = sf.get_snp_candidates(bam, fasta, members[0])
    rng = np.random.default_rng(15)

    class _Indels:
        x0, x1, x2 = (rng.random((DP_INDEL_ROWS, 5, 128, 2), np.float32)
                      for _ in range(3))

        def __len__(self):
            return DP_INDEL_ROWS

    saved = sharding.inference_devices
    dev0 = torch.device("cuda", 0)
    out, launches = {}, {}
    try:
        for n in (1, 2):
            sharding.inference_devices = lambda _d, n=n: \
                [dev0] * n if n > 1 else None
            snp = S.SnpCallerState.create(cfg.snp_model, device="cuda")
            indel = I.IndelCallerState.create(cfg.indel_model, device="cuda")
            if len(snp.replicas) != n or len(indel.replicas) != n:
                fail("inference_devices gave %d replicas, not %d"
                     % (len(snp.replicas), n))
            runs = {"group": lambda: np.concatenate(
                        S.infer_snp_group(snp, gf, cfg)),
                    "chunk": lambda: S.infer_snp_chunk(snp, feats, cfg,
                                                       "diploid"),
                    "dense": lambda: S.infer_snp_batch(snp, batch, cfg,
                                                       "diploid"),
                    "indel": lambda: I.infer_indel_many(
                        indel, [_Indels()], batch_size=DP_BATCH)[0]}
            for name, fn in runs.items():
                reset_counters("k3", "k5")
                out[name, n] = fn()
                launches[name, n] = (kernel_launches("k3"),
                                     kernel_launches("k5"))
    finally:
        sharding.inference_devices = saved
    # the launches two replicas must make: one a (cohort, replica) with
    # rows; a cohort of B rows reaches min(2, ceil(B / DP_BATCH)) replicas
    reach = lambda B: min(2, -(-B // DP_BATCH))
    rows_group = {}
    for _mi, sec in gf.members:
        if sec is None:
            continue
        nd = len(sec.deep_idx)
        for deep, k in ((False, len(sec) - nd), (True, nd)):
            if k:
                rows_group[sec.ploidy, deep] = \
                    rows_group.get((sec.ploidy, deep), 0) + k
    nd = len(feats.deep_idx)
    want = {"group": (sum(reach(b) for b in rows_group.values()), 0),
            "chunk": (sum(reach(b) for b in (len(feats) - nd, nd) if b), 0),
            "dense": (0, reach(len(batch))), "indel": (0, 0)}
    for name in runs:
        if not np.array_equal(out[name, 1], out[name, 2]):
            fail("two replicas changed the %s probabilities" % name)
        if launches[name, 2] != want[name] or (
                name != "indel" and launches[name, 1] == want[name]):
            fail("%s: launches (K3, K5) %s with one replica, %s with two; "
                 "want %s with two" % (name, launches[name, 1],
                                       launches[name, 2], want[name]))
    return {"dp_batch": DP_BATCH,
            "dp_rows": {"group": sum(rows_group.values()),
                        "chunk": len(feats), "dense": len(batch),
                        "indel": DP_INDEL_ROWS},
            "dp_launches_k3_k5": {"%s_%dreplica" % k: v
                                  for k, v in launches.items()},
            "dp_bit_identical": True}


def init_state(kind, seed):
    """The kind's model ("snp" or "indel") initialised as flax's defaults
    from `seed` (models.weights.init_params), as {name: numpy array}."""
    import torch
    from nanocaller_tpu_torch.models import IndelModel, SNPModel, init_params

    m = init_params((SNPModel if kind == "snp" else IndelModel)(),
                    torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in m.state_dict().items()}


def train_step_for(kind, state, device):
    """(model, step) of the kind's train step (snp_train.make_train_step
    or indel_train.make_indel_train_step, Adam at 1e-3) from state on
    device (resolve_device: on cuda TF32 off and deterministic cuDNN, as
    the trainers run)."""
    import torch
    from nanocaller_tpu_torch.models import IndelModel, SNPModel
    from nanocaller_tpu_torch.runtime.device import resolve_device
    from nanocaller_tpu_torch.train.indel_train import make_indel_train_step
    from nanocaller_tpu_torch.train.snp_train import make_train_step

    model = (SNPModel if kind == "snp" else IndelModel)()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(resolve_device(device))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    make = make_train_step if kind == "snp" else make_indel_train_step
    return model, make(model, opt)


def one_step(kind, state, batch, device):
    """One train step of the kind's model from state on a numpy batch:
    (loss, gradients, weights after the update), as floats and
    {name: numpy array}."""
    from nanocaller_tpu_torch.train.snp_train import to_device

    model, step = train_step_for(kind, state, device)
    loss = float(step(to_device(batch, device)))
    return (loss, {n: p.grad.cpu().numpy() for n, p in
                   model.named_parameters()},
            {n: p.detach().cpu().numpy() for n, p in
             model.named_parameters()})


def steps_differ(a, b, what):
    """None when two one_step results agree within the step tolerances
    (loss 2e-5, gradients rtol 1e-4 / atol 1e-6), else what differs."""
    import numpy as np

    if abs(a[0] - b[0]) > PARITY_ATOL:
        return "%s: loss %r vs %r" % (what, a[0], b[0])
    for n, g in a[1].items():
        if not np.allclose(g, b[1][n], rtol=GRAD_RTOL, atol=GRAD_ATOL):
            return "%s: gradient of %s, max |diff| %g" % (
                what, n, float(np.abs(g - b[1][n]).max()))
    return None


def steps_equal(a, b):
    """Two one_step results bit for bit: loss, gradients and weights."""
    import numpy as np

    return a[0] == b[0] and all(
        np.array_equal(a[k][n], b[k][n]) for k in (1, 2) for n in a[1])


def step_ms(kind, state, batch, reps=STEP_REPS):
    """Mean ms of one train step on the card at the batch's size, by CUDA
    events around `reps` steps after one warm-up step. No spin before:
    a step this small is launch-bound, and the host's time between its
    launches is part of what it costs."""
    import torch
    from nanocaller_tpu_torch.train.snp_train import to_device

    _model, step = train_step_for(kind, state, "cuda")
    b = to_device(batch, "cuda")
    step(b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step(b)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_steps(kind, state, batch, reps=STEP_REPS):
    """`reps` train steps on the card (after a warm-up) under
    torch.profiler: a step's wall (the profiler's own cost included),
    the device's busy time a step, its idle share of the wall and its
    kernels and copies a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nanocaller_tpu_torch.train.snp_train import to_device

    _model, step = train_step_for(kind, state, "cuda")
    b = to_device(batch, "cuda")
    step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages()
          if e.device_type == cuda and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    return {"model": kind, "B": len(batch["x"]),
            "profiled_wall_ms_a_step": wall / reps * 1e3,
            "device_busy_ms_a_step": busy / reps * 1e3,
            "device_idle_share": 1 - busy / wall if ev else None,
            "device_events_a_step": sum(e.count for e in ev) / reps}


def train_batches(snp_ex, x, labels):
    """Phase 16's step batches: the SNP examples' first batch of each
    size (batches_from_examples, rng 0) and the first indel examples."""
    import numpy as np
    from nanocaller_tpu_torch.train.data import batches_from_examples

    first = lambda B: next(batches_from_examples(
        snp_ex, B, np.random.default_rng(0)))
    B = TRAIN_B["indel"]
    return {"snp": first(TRAIN_B["snp"]), "snp_large": first(TRAIN_B_LARGE),
            "indel": {"x": x[:B], "label": np.eye(4, dtype=np.float32)[
                labels[:B]]}}


def phase_train(tmp):
    """Phase 16: training and the entry module on the card (see the
    module docstring). Returns the counters of the indel training
    features' cuda run and of entry()'s forward."""
    import numpy as np
    import torch
    from nanocaller_tpu_torch import entry as E
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.io.vcf import VcfReader
    from nanocaller_tpu_torch.models import (IndelModel, SNPModel,
                                             load_model,
                                             torch_state_dict_from_params)
    from nanocaller_tpu_torch.runtime.sharding import shard_train_step_demo
    from nanocaller_tpu_torch.sim import write_train_fixture
    from nanocaller_tpu_torch.train.data import (
        batches_from_examples, generate_snp_training_examples, truth_snps)
    from nanocaller_tpu_torch.train.indel_data import (
        generate_indel_training_examples, truth_indels)
    from nanocaller_tpu_torch.train.indel_train import train_indel_model
    from nanocaller_tpu_torch.train.snp_train import train_snp_model

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "train")
    os.makedirs(d)
    fasta_p, bam_p, tagged_p, vcf_p, snps, indels = write_train_fixture(
        d, TRAIN_LEN, TRAIN_SEED)
    chunk = {"chrom": "chr_t", "start": 1, "end": TRAIN_LEN}
    walls = {}

    # (a) the indel training features: K1, K2 and K4 on the card
    truth_i = truth_indels(VcfReader(vcf_p), "chr_t", 1, TRAIN_LEN)

    def indel_examples(region, dev):
        t0 = time.perf_counter()
        out = generate_indel_training_examples(
            BamReader(tagged_p), FastaFile(fasta_p), truth_i, region,
            device=dev)
        return out, time.perf_counter() - t0

    reset_counters("k1", "k2", "k4")
    (x, labels, _pos), walls["indel_examples_cuda_s"] = indel_examples(
        chunk, "cuda")
    counts = nw_counters()
    if counts["NW_TB_LAUNCHES"] == 0:
        fail("the indel training features launched no K1")
    check = dict(chunk, end=TRAIN_CHECK_LEN)
    feats = {dev: indel_examples(check, dev)[0] for dev in ("cuda", "cpu")}
    for name, a, b in zip(("x", "labels", "pos"), feats["cuda"],
                          feats["cpu"]):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail("indel training %s differ between cuda and cpu" % name)
    emit({"phase": "train_indel_features", "examples": len(x),
          "variant_labelled": int((labels > 0).sum()),
          "truth_indels": len(truth_i), "cuda_s":
          walls["indel_examples_cuda_s"], "cuda_equals_cpu_on":
          "chr_t:1-%d (%d examples)" % (TRAIN_CHECK_LEN,
                                        len(feats["cpu"][0])), **counts})

    truth_s = truth_snps(VcfReader(vcf_p), "chr_t", 1, TRAIN_LEN)
    t0 = time.perf_counter()
    snp_ex = generate_snp_training_examples(
        BamReader(bam_p), FastaFile(fasta_p), truth_s, chunk)
    walls["snp_examples_s"] = time.perf_counter() - t0
    emit({"phase": "train_snp_examples", "examples": len(snp_ex["gt"]),
          "truth_snps": len(truth_s), "wall_s": walls["snp_examples_s"]})

    # (b) one step of each model, cuda against cpu, and twice on cuda
    batches = train_batches(snp_ex, x, labels)
    states = {"snp": init_state("snp", TRAIN_SEED),
              "indel": init_state("indel", TRAIN_SEED)}
    steps = {}
    for kind in ("snp", "indel"):
        b = batches[kind]
        cpu = one_step(kind, states[kind], b, "cpu")
        cuda = one_step(kind, states[kind], b, "cuda")
        again = one_step(kind, states[kind], b, "cuda")
        bad = steps_differ(cuda, cpu, "%s step cuda vs cpu" % kind)
        if bad:
            fail(bad)
        if not steps_equal(cuda, again):
            fail("two cuda %s steps differ" % kind)
        steps[kind] = cuda
        emit({"phase": "train_step", "model": kind, "B": len(b["x"]),
              "loss_cuda": cuda[0], "loss_cpu": cpu[0],
              "loss_abs_diff": abs(cuda[0] - cpu[0]),
              "max_grad_abs_diff": max(
                  float(np.abs(g - cpu[1][n]).max())
                  for n, g in cuda[1].items()),
              "cuda_runs_bit_identical": True})
    times = {"snp_step_ms_B%d" % TRAIN_B["snp"]: step_ms(
                 "snp", states["snp"], batches["snp"]),
             "snp_step_ms_B%d" % TRAIN_B_LARGE: step_ms(
                 "snp", states["snp"], batches["snp_large"]),
             "indel_step_ms_B%d" % TRAIN_B["indel"]: step_ms(
                 "indel", states["indel"], batches["indel"])}
    for kind in ("snp", "indel"):
        emit({"phase": "train_step_profile",
              **profile_steps(kind, states[kind], batches[kind])})

    # (c) a few epochs of each trainer on the card, then their last
    # checkpoints through load_model into a forward
    marks = []
    t0 = time.perf_counter()
    _params, hist = train_snp_model(
        snp_ex, snp_ex, os.path.join(d, "snp_ckpt"), epochs=TRAIN_EPOCHS,
        batch_size=TRAIN_B["snp"], seed=TRAIN_SEED, device="cuda",
        log=lambda *a: marks.append(time.perf_counter()))
    epoch_s = np.diff([t0] + marks).tolist()
    t1 = time.perf_counter()
    n_batches = sum(1 for _ in batches_from_examples(
        snp_ex, TRAIN_B["snp"], np.random.default_rng(0)))
    host_s = time.perf_counter() - t1
    _iparams, ihist = train_indel_model(
        x, labels, os.path.join(d, "indel_ckpt"), epochs=TRAIN_EPOCHS,
        batch_size=TRAIN_B["indel"], seed=TRAIN_SEED, device="cuda",
        log=lambda *a: None)
    for kind, h in (("snp", hist), ("indel", ihist)):
        if not h[-1]["loss"] < h[0]["loss"]:
            fail("the %s loss did not fall: %s"
                 % (kind, [e["loss"] for e in h]))
    with torch.no_grad():
        p, _ = load_model("snp", hist[-1]["ckpt"])
        m = SNPModel()
        m.load_state_dict(torch_state_dict_from_params(p))
        b = batches["snp"]
        probs, _gt = m.cuda()(torch.from_numpy(b["x"]).cuda(),
                              torch.from_numpy(b["ref"]).cuda())
        p, _ = load_model("indel", ihist[-1]["ckpt"])
        m = IndelModel()
        m.load_state_dict(torch_state_dict_from_params(p))
        iprobs = m.cuda()(torch.from_numpy(batches["indel"]["x"]).cuda())
    if not (torch.isfinite(probs).all() and torch.isfinite(iprobs).all()):
        fail("a trained checkpoint's forward is not finite")
    cli_out = os.path.join(d, "cli")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nanocaller_tpu_torch.train.train_snp",
         "--bam", bam_p, "--ref", fasta_p, "--truth_vcf", vcf_p,
         "--regions", "chr_t:1-%d" % TRAIN_LEN, "--output", cli_out,
         "--epochs", "2", "--chunk_size", "100000", "--val_every", "2",
         "--train_coverage", "30", "--device", "cuda"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        capture_output=True, text=True, timeout=600)
    walls["snp_cli_s"] = time.perf_counter() - t0
    ckpt = os.path.join(cli_out, "snp_model-2.npz")
    if res.returncode != 0 or not os.path.exists(ckpt) \
            or load_model("snp", ckpt)[1] != 30.0:
        fail("the SNP training CLI failed (rc %d): %s"
             % (res.returncode, (res.stdout + res.stderr)[-3000:]))
    emit({"phase": "train_epochs",
          "snp_loss": [e["loss"] for e in hist],
          "snp_val_acc": [e["val_acc"] for e in hist],
          "indel_loss": [e["loss"] for e in ihist],
          "snp_epoch_s": epoch_s, "snp_batches_an_epoch": n_batches,
          "snp_batch_building_s": host_s,
          "snp_host_share_last_epoch": host_s / epoch_s[-1],
          "snp_cli_s": walls["snp_cli_s"], "checkpoints_load": True})

    # (d) the sharded step at world size 1 on NCCL, against the unsharded
    t0 = time.perf_counter()
    out = shard_train_step_demo(1, device="cuda", state_dict=states["snp"],
                                batch=batches["snp"])
    walls["nccl_step_s"] = time.perf_counter() - t0
    if not steps_equal((out["loss"], out["grads"], out["params"]),
                       steps["snp"]):
        fail("the NCCL world-size-1 step differs from the unsharded step")
    emit({"phase": "train_sharded_nccl", "world": 1,
          "mesh": out["mesh"].shape, "loss": out["loss"],
          "bit_identical_to_unsharded": True,
          "wall_s": walls["nccl_step_s"]})

    # (e) entry()'s forward on the chunk wire, and dryrun_multichip(1)
    fn, args = E.entry(device="cuda")
    reset_counters("k3")
    got = fn(*args)
    entry_counts = {"SNP_PILEUP_LAUNCHES": kernel_launches("k3"),
                    "chunk_wire": counter("k3.launches.chunk")}
    if entry_counts["chunk_wire"] == 0:
        fail("entry() launched no K3 on a chunk wire")
    cpu_fn, cpu_args = E.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    err = float(np.abs(got - want).max())
    if got.shape != (len(args[0]), 4) or not np.isfinite(got).all() \
            or err > PARITY_ATOL:
        fail("entry() on cuda against cpu: shape %s, max |diff| %g"
             % (got.shape, err))
    t0 = time.perf_counter()
    for _ in range(ENTRY_REPS):
        fn(*args)
    entry_ms = (time.perf_counter() - t0) / ENTRY_REPS * 1e3
    t0 = time.perf_counter()
    calls = E.dryrun_multichip(1, device="cuda")
    walls["dryrun_multichip_s"] = time.perf_counter() - t0
    emit({"phase": "entry", "B": len(args[0]), "max_abs_err_vs_cpu": err,
          "forward_ms": entry_ms, **entry_counts,
          "dryrun_calls": calls, "dryrun_s": walls["dryrun_multichip_s"]})
    emit({"phase": "train_summary", "nvidia_smi": _smi_line(), **times,
          **walls, "snp_epoch_s": epoch_s,
          "snp_host_share_last_epoch": host_s / epoch_s[-1],
          "entry_forward_ms": entry_ms,
          "phase_s": time.perf_counter() - t_phase})
    return counts, entry_counts


def phase_tools_api(tmp, snp_fasta, snp_bam, indel_fasta, indel_bam):
    """Phase 17 (see the module docstring): the bench tool on cuda and
    cpu, then the one-chunk entry points. Returns the counters of the
    entry points' cuda runs by path."""
    import torch

    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.indel_caller import (IndelCallerState,
                                                   call_indel_chunk)
    from nanocaller_tpu_torch.io.bam import BamReader
    from nanocaller_tpu_torch.io.fasta import FastaFile
    from nanocaller_tpu_torch.snp_caller import SnpCallerState, call_chunk

    t_phase = time.perf_counter()
    # (a) the bench tool, cuda then cpu
    runs = {}
    for dev in ("cuda", "cpu"):
        wd = os.path.join(tmp, "e2e_" + dev)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "nanocaller_tpu_torch.tools.bench_e2e",
             *E2E_ARGS, "--device", dev, "--workdir", wd],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=E2E_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            fail("bench_e2e --device %s failed (rc %d): %s"
                 % (dev, res.returncode, (res.stdout + res.stderr)[-3000:]))
        runs[dev] = (wd, json.loads(res.stdout.strip().splitlines()[-1]),
                     wall)
    for name in ("ref.fa", "reads.bam", "truth.vcf.gz"):
        with open(os.path.join(runs["cuda"][0], name), "rb") as fa, \
                open(os.path.join(runs["cpu"][0], name), "rb") as fb:
            if fa.read() != fb.read():
                fail("bench_e2e's two fixtures differ in %s" % name)
    vcf = lambda dev, name: os.path.join(
        runs[dev][0], "out", "v.%s.vcf.gz" % name if name else "v.vcf.gz")
    cases, records = [], {}
    for name, kind in DIST_VCFS:
        records[name or "final"], diffs = compare_records(
            vcf("cuda", name), vcf("cpu", name), kind)
        cases += [dict(d, vcf=name or "final") for d in diffs]
    for d in cases:
        emit({"phase": "tools_bench_e2e_rounding_case", **d})
    out = runs["cuda"][1]
    if not (out["results"]["snp"]["f1"] or 0) > 0.5:
        fail("bench_e2e on cuda: SNP F1 %s" % out["results"]["snp"])
    # the CPU settings each run's CLI process (bench_e2e's child) ran with
    settings = {}
    for dev, (wd, _o, _wall) in runs.items():
        with open(os.path.join(wd, "out", "metrics.json")) as fh:
            settings[dev] = json.load(fh)["cpu_settings"]
    emit({"phase": "tools_bench_e2e", "nvidia_smi": _smi_line(),
          "argv": E2E_ARGS, "records": records,
          "rounding_cases": len(cases), "cpu_settings": settings,
          **{dev: {"tool_wall_s": wall, "cli_wall_s": o["wall_s"],
                   "stages": o["stages"], "counts": o["counts"],
                   "rates": o["rates"], "results": o["results"]}
             for dev, (_wd, o, wall) in runs.items()}})

    # (b) the one-chunk entry points, cuda then cpu
    def reset():
        reset_counters("k1", "k2", "k3", "k4", "k5")

    def counts():
        return {**{k: v for k, v in kernel_counts().items()
                   if k != "pairs"}, "chunk_wire": counter("k3.launches.chunk")}

    snp_states = {dev: SnpCallerState.create("ONT-HG002", device=dev)
                  for dev in ("cuda", "cpu")}
    indel_states = {dev: IndelCallerState.create("ONT-HG002", device=dev)
                    for dev in ("cuda", "cpu")}
    paths = {}
    cases = (("chunk_api_snp", snp_fasta, snp_bam, CHUNK_API_SNP, True),
             ("chunk_api_snp_dense", snp_fasta, snp_bam, CHUNK_API_SNP,
              False),
             ("chunk_api_indel", indel_fasta, indel_bam, CHUNK_API_INDEL,
              True))
    for path, fasta_p, bam_p, chunk, dedup in cases:
        lines, walls = {}, {}
        for dev in ("cuda", "cpu"):
            cfg = Config(bam=bam_p, ref=fasta_p, device=dev,
                         dedup_transfer=dedup)
            args = (BamReader(bam_p), FastaFile(fasta_p), chunk, cfg)
            reset()
            t0 = time.perf_counter()
            if path == "chunk_api_indel":
                lines[dev] = call_indel_chunk(indel_states[dev], *args)
            else:
                lines[dev] = call_chunk(snp_states[dev], *args)
            if dev == "cuda":
                torch.cuda.synchronize()
                paths[path] = counts()
            walls[dev] = time.perf_counter() - t0
        c = paths[path]
        need = {"chunk_api_snp": ("chunk_wire",),
                "chunk_api_snp_dense": ("SNP_DENSE_LAUNCHES",),
                "chunk_api_indel": ("NW_TB_LAUNCHES", "NW_WALK_LAUNCHES",
                                    "NW_CIGAR_LAUNCHES")}[path]
        if min(c[k] for k in need) < 1:
            fail("%s launched no %s: %s" % (path, need, c))
        if path == "chunk_api_snp_dense" and c["SNP_PILEUP_LAUNCHES"]:
            fail("the dense call_chunk launched K3: %s" % c)
        kind = "indel" if path == "chunk_api_indel" else "snp"
        n, diffs = compare_lines(lines["cuda"], lines["cpu"], kind, path)
        if n < 10:
            fail("%s called %d records" % (path, n))
        for d in diffs:
            emit({"phase": "tools_api_rounding_case", "path": path, **d})
        emit({"phase": "tools_api", "path": path, "chunk": chunk,
              "records": n, "rounding_cases": len(diffs),
              "cuda_s": walls["cuda"], "cpu_s": walls["cpu"], **c})
    emit({"phase": "tools_api_summary",
          "phase_s": time.perf_counter() - t_phase})
    return paths


def _install_freeze(sentinel):
    """Phase 18(a)'s hang, installed in a --cli-child process only: once
    the first SNP chunk is in the run manifest, unless an earlier attempt
    froze (the sentinel, which gets the clock time of the freeze), queue
    a kernel that spins the card FREEZE_CYCLES and wait for it, as the
    host waits at the copy-back of a kernel that never ends."""
    import torch
    from nanocaller_tpu_torch.runtime import scheduler

    orig = scheduler.RunManifest.mark_done

    def mark_done(self, stage, chunk, shard_path):
        orig(self, stage, chunk, shard_path)
        if stage == "snp" and not os.path.exists(sentinel):
            with open(sentinel, "w") as fh:
                fh.write(repr(time.time()))
            torch.cuda._sleep(FREEZE_CYCLES)
            torch.cuda.synchronize()

    scheduler.RunManifest.mark_done = mark_done


def supervise_child(window, heartbeat, argv_json):
    """Phase 18(a)'s supervisor, started by this script with `--supervise
    WINDOW HEARTBEAT ARGV_JSON`: the port's supervise, with --watchdog's
    retries and poll, over `--cli-child ARGV_JSON`, in a process that
    loads neither torch nor CUDA. Prints each log line with its clock
    time, then one JSON line; exits with the supervisor's code."""
    from nanocaller_tpu_torch.runtime.watchdog import supervise

    rc = supervise([sys.executable, os.path.abspath(__file__),
                    "--cli-child", argv_json], heartbeat, float(window),
                   log=lambda m: emit({"watchdog_log": m, "at": time.time()}))
    emit({"supervisor_rc": rc, "torch_loaded": "torch" in sys.modules,
          "maps_libcuda": _maps_libcuda(os.getpid())})
    return rc


def _smi_apps():
    """The PIDs nvidia-smi lists as holding a CUDA context, one a process
    (in a container it may give every process the PID 1)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout
    return [int(x) for x in out.split() if x.isdigit()]


def _free_port():
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _kill_tree(pid):
    """SIGKILL pid and every live process below it."""
    import signal

    for c in _child_pids(pid):
        _kill_tree(c)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _wait_bounded(proc, deadline, what):
    """proc's exit code, or fail (with proc's tree killed) when it has not
    ended by the clock time `deadline`."""
    try:
        return proc.wait(timeout=max(0.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        _kill_tree(proc.pid)
        proc.wait()
        fail("%s did not end within its bound" % what)


def _log_lines(path):
    """The JSON lines of a log file, and its other lines."""
    objs, other = [], []
    with open(path) as fh:
        for line in fh:
            try:
                obj = json.loads(line)
            except ValueError:
                other.append(line.rstrip("\n"))
                continue
            (objs if isinstance(obj, dict) else other).append(obj)
    return objs, other


class SupervisorWatch:
    """Polls, on a thread, what phase 18 holds its supervisors to: the
    compute apps nvidia-smi lists, with each poll's clock time (`smi`:
    (time, PIDs)); the libraries of libcuda and libtorch that a
    supervisor mapped at any poll (`supervisor_maps`, which must stay
    empty); the supervisors' children in the order first seen; and the
    most children that mapped libcuda (held a CUDA context) at one poll
    (`most_owners`)."""

    def __init__(self, supervisors, period=0.25):
        import threading

        self.supervisors, self.period = supervisors, period
        self.smi, self.children, self.supervisor_maps = [], [], set()
        self.most_owners = 0
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.smi.append((time.time(), _smi_apps()))
            except (OSError, subprocess.SubprocessError):
                pass
            owners = 0
            for sup in self.supervisors:
                try:
                    with open("/proc/%d/maps" % sup) as fh:
                        maps = fh.read()
                except OSError:
                    maps = ""
                self.supervisor_maps |= {lib for lib in ("libcuda",
                                                         "libtorch")
                                         if lib in maps}
                for c in _child_pids(sup):
                    if c not in self.children:
                        self.children.append(c)
                    owners += _maps_libcuda(c)
            self.most_owners = max(self.most_owners, owners)
            self._stop.wait(self.period)

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()


def _vcf_bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


def phase_watchdog(tmp, fasta_p, bam_p, dag_wall, dist_wall):
    """Phase 18 (see the module docstring): (a) a real device stall under
    the port's supervise, killed and resumed; (b) a dead Gloo peer under
    --watchdog, then a --resume relaunch. Returns the counters of (a)'s
    resumed child."""
    import math
    import re
    import signal

    t_phase = time.perf_counter()
    path = lambda name: os.path.join(tmp, "wd_" + name)
    vcf = lambda d: lambda name: os.path.join(
        d, "smoke.%s.vcf.gz" % name if name else "smoke.vcf.gz")
    me = os.path.abspath(__file__)

    def argv(out, *extra):
        return ["--bam", bam_p, "--ref", fasta_p, "--mode", "all", "--cpu",
                str(DIST_CPU), "--haploid_X", "--device", "cuda",
                "--output", out, "--prefix", "smoke", "--sample", "S",
                "--suppress_progress_bar", *extra]

    env = {k: v for k, v in os.environ.items()
           if k not in ("NC_TPU_HEARTBEAT", "NC_TPU_WATCHDOG_CHILD")}

    # (a) a cold child's time to its first beat: a child with a heartbeat
    # of its own, killed with its workers at that beat
    probe_hb = path("probe.heartbeat")
    t0 = time.time()
    with open(path("probe.log"), "w") as log:
        probe = subprocess.Popen(
            [sys.executable, me, "--cli-child",
             json.dumps(argv(path("probe")))],
            env=dict(env, NC_TPU_HEARTBEAT=probe_hb,
                     NC_TPU_WATCHDOG_CHILD="1",
                     CHIP_SMOKE_T_SPAWN=repr(t0)),
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        while not os.path.exists(probe_hb):
            if probe.poll() is not None or time.time() - t0 > 300:
                fail("the probe child made no beat (rc %s)" % probe.poll())
            time.sleep(0.02)
        first_beat = os.path.getmtime(probe_hb) - t0
    finally:
        try:
            os.killpg(probe.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        probe.wait()
    window = max(WATCHDOG_MIN_S, math.ceil(2 * first_beat))
    emit({"phase": "watchdog_window", "first_beat_s": first_beat,
          "window_s": window})

    # (a) the supervised run, frozen on the card once
    sentinel, log_a = path("froze"), path("a.log")
    base = _smi_apps()
    t_a = time.time()
    with open(log_a, "w") as log:
        sup = subprocess.Popen(
            [sys.executable, me, "--supervise", str(window),
             path("a.heartbeat"), json.dumps(argv(path("a")))],
            env=dict(env, CHIP_SMOKE_FREEZE=sentinel,
                     CHIP_SMOKE_T_SPAWN=repr(t_a)),
            stdout=log, stderr=subprocess.STDOUT)
    bound_a = (1 + WATCHDOG_RETRIES) * (window + WATCHDOG_POLL_S) + 120
    with SupervisorWatch([sup.pid]) as watch_a:
        rc = _wait_bounded(sup, t_a + bound_a, "phase 18(a)'s supervisor")
    wall_a = time.time() - t_a
    objs, other = _log_lines(log_a)
    logs = [o for o in objs if "watchdog_log" in o]
    kills = [o for o in logs if "killing the run" in o["watchdog_log"]]
    children = [o for o in objs if "counts" in o]
    summary = next((o for o in objs if "supervisor_rc" in o), {})
    if rc != 0 or summary.get("supervisor_rc") != 0 or len(kills) != 1 \
            or len(children) != 1 or not children[0]["resume"] \
            or not os.path.exists(sentinel):
        fail("phase 18(a): rc %s, log %s, children %s, froze %s: %s"
             % (rc, logs, children, os.path.exists(sentinel),
                "\n".join(map(str, other[-40:]))))
    child, kill_at = children[0], kills[0]["at"]
    with open(sentinel) as fh:
        froze_at = float(fh.read())
    if summary["torch_loaded"] or summary["maps_libcuda"] or \
            watch_a.supervisor_maps:
        fail("phase 18(a)'s supervisor loaded torch or CUDA: %s, %s"
             % (summary, sorted(watch_a.supervisor_maps)))
    if watch_a.most_owners > 1:
        fail("two supervised children held a CUDA context at once")
    # nvidia-smi: at most this process and one child at a time; the killed
    # child's context gone before the new child made its own
    frozen = watch_a.children[0]
    counts_smi = [len(p) for _, p in watch_a.smi]
    between = [len(p) for t, p in watch_a.smi if kill_at < t < child["ctx_at"]]
    smi_left = bool(between) and min(between) <= len(base)
    pids_real = any(frozen in p for t, p in watch_a.smi if t < kill_at)
    if any(counts_smi) and (max(counts_smi) > len(base) + 1 or
                            not smi_left):
        fail("nvidia-smi listed %s compute apps (this process alone: %d; "
             "between the kill and the new context: %s)"
             % (sorted(set(counts_smi)), len(base), between))
    if pids_real and any(frozen in p for t, p in watch_a.smi
                         if t > child["ctx_at"]):
        fail("the killed child %d stayed in nvidia-smi's list" % frozen)
    cases_a = _held("watchdog_a", vcf(path("a")),
                    vcf(os.path.join(tmp, "dag_cudaN")))
    same_as_15a = [_vcf_bytes(vcf(path("a"))(name)) ==
                   _vcf_bytes(vcf(os.path.join(tmp, "dist_a"))(name))
                   for name, _ in DIST_VCFS]
    age = re.search(r"no progress for (\d+)s", kills[0]["watchdog_log"])

    # (b) two supervised processes; process 1's child dies mid-run
    out_b = path("b")
    coord = "localhost:%d" % _free_port()
    cmd_b = lambda i, out, coord, *extra: [
        sys.executable, "-m", "nanocaller_tpu_torch.cli",
        *argv(out, "--coordinator", coord, "--num_processes", "2",
              "--process_id", str(i), *extra)]
    logs_b = [path("b%d.log" % i) for i in range(2)]
    bound_b = (1 + WATCHDOG_RETRIES) * (window + WATCHDOG_POLL_S) + 60
    t0 = time.time()
    sups = []
    for i in range(2):
        with open(logs_b[i], "w") as log:
            sups.append(subprocess.Popen(
                cmd_b(i, out_b, coord, "--watchdog", str(window)),
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
    killed = None
    try:
        with SupervisorWatch([p.pid for p in sups]) as watch_b:
            manifest = os.path.join(out_b, "run_manifest.host001.json")
            while not os.path.exists(manifest):
                if time.time() - t0 > DIST_TIMEOUT_S or \
                        any(p.poll() is not None for p in sups):
                    fail("phase 18(b): process 1 finished no SNP chunk")
                time.sleep(0.05)
            killed = next(iter(_child_pids(sups[1].pid)), None)
            if killed is None:
                fail("phase 18(b): process 1's supervisor has no child")
            os.kill(killed, signal.SIGKILL)
            kill_b = time.time()
            rcs = [_wait_bounded(p, kill_b + bound_b,
                                 "phase 18(b)'s supervisor %d" % i)
                   for i, p in enumerate(sups)]
            ends_b = time.time() - kill_b
    finally:
        for p in sups:
            if p.poll() is None:
                _kill_tree(p.pid)
                p.wait()
        if killed is not None:
            try:  # the killed child's feature workers
                os.killpg(killed, signal.SIGKILL)
            except ProcessLookupError:
                pass
    if watch_b.supervisor_maps:
        fail("a --watchdog supervisor mapped %s"
             % sorted(watch_b.supervisor_maps))
    wlog = []
    for i in range(2):
        with open(logs_b[i]) as fh:
            wlog.append([l.strip() for l in fh if l.startswith("watchdog:")
                         or "Error" in l][-8:])
    # every process relaunched with --resume completes from its manifest
    coord = "localhost:%d" % _free_port()
    t0 = time.time()
    relaunch = []
    for i in range(2):
        with open(path("b_resume%d.log" % i), "w") as log:
            relaunch.append(subprocess.Popen(
                cmd_b(i, out_b, coord, "--resume"), cwd=HERE, env=env,
                stdout=log, stderr=subprocess.STDOUT))
    for i, p in enumerate(relaunch):
        if _wait_bounded(p, t0 + DIST_TIMEOUT_S,
                         "phase 18(b)'s --resume process %d" % i) != 0:
            with open(path("b_resume%d.log" % i)) as fh:
                fail("phase 18(b): the --resume process %d failed: %s"
                     % (i, fh.read()[-3000:]))
    resume_b = time.time() - t0
    cases_b = _held("watchdog_b", vcf(out_b),
                    vcf(os.path.join(tmp, "dist_a")))
    emit({"phase": "watchdog", "nvidia_smi": _smi_line(), "cpu": DIST_CPU,
          "first_beat_s": first_beat, "window_s": window,
          "a": {"supervisor_wall_s": wall_a, "bound_s": bound_a,
                "log": [o["watchdog_log"] for o in logs],
                "heartbeat_age_at_kill_s": int(age.group(1)),
                "kill_after_freeze_s": kill_at - froze_at,
                "freeze_after_start_s": froze_at - t_a,
                "kill_to_cuda_context_s": child["ctx_at"] - kill_at,
                "resumed_run_s": child["run_s"],
                "phase12_cuda_cpuN_wall_s": dag_wall,
                "phase15a_wall_s": dist_wall,
                "resumed_launches": child["counts"],
                "rounding_cases_vs_phase12": len(cases_a),
                "bytes_equal_phase15a": same_as_15a,
                "smi_apps_alone": len(base),
                "smi_apps_most": max(counts_smi, default=None),
                "smi_left_before_new_context": smi_left,
                "smi_pids_are_processes": pids_real,
                "most_device_owners": watch_a.most_owners,
                "children": watch_a.children},
          "b": {"outcome": "recovered" if rcs == [0, 0] else
                "bounded exit", "rcs": rcs, "ends_after_kill_s": ends_b,
                "bound_s": bound_b, "log": wlog,
                "resume_wall_s": resume_b,
                "rounding_cases_vs_phase15a": len(cases_b),
                "supervisor_children": watch_b.children},
          "phase_s": time.perf_counter() - t_phase})
    return child["counts"]


def main():
    if not os.path.isdir(os.path.join(HERE, "nanocaller_tpu_torch", "csrc")):
        print("chip_smoke: the nanocaller_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    # the package before torch, as `python -m nanocaller_tpu_torch.cli`
    # imports it: its OpenMP setting (OMP_WAIT_POLICY) then holds for the
    # runs this process drives (phase 12's cpu --cpu N run among them)
    sys.path.insert(0, HERE)
    import nanocaller_tpu_torch  # noqa: F401

    if sys.argv[1:2] == ["--supervise"]:
        # phase 18(a)'s supervisor: before torch, which it must not load
        return supervise_child(*sys.argv[2:5])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cli-child"]:
        return cli_child(json.loads(sys.argv[2]) + sys.argv[3:])
    if sys.argv[1:2] == ["--k6"]:
        # phase 6b alone
        from nanocaller_tpu_torch.runtime.device import resolve_device

        resolve_device("cuda")
        emit({"phase": "setup", "nvidia_smi": _smi_line()})
        phase_k6()
        return 0
    from nanocaller_tpu_torch.align import nw_kernels as K
    from nanocaller_tpu_torch.io import native
    from nanocaller_tpu_torch.runtime import kernels
    from nanocaller_tpu_torch.runtime.device import resolve_device
    import numpy as np

    smi = _smi_line()
    t0 = time.perf_counter()
    lib = kernels.build()
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
        counts, indel_fasta, indel_bam = phase_slice(tmp)
        phase_snp_models()
        k6_rows_ = phase_k6()
        snp_counts, fasta_p, bam_p = phase_snp_slice(tmp)
        k3_rows = phase_k3(fasta_p, bam_p,
                           snp_counts["SNP_PILEUP_LAUNCHES"])
        all_counts = phase_all_slice(tmp)
        phase_a2a(tmp, fasta_p, bam_p)
        cut_fasta, cut_bam = phase_cram_all(tmp)
        dag_counts, dag_fasta, dag_bam, dag_wall = phase_dag(tmp)
        ccs_counts = phase_ccs(tmp, cut_fasta, cut_bam)
        a2b_counts, a2b_k3_rows, a2b_k5_rows = phase_a2b(
            tmp, fasta_p, bam_p, cut_fasta, cut_bam)
        dist_counts, dist_wall = phase_dist(tmp, dag_fasta, dag_bam,
                                            cut_fasta, cut_bam)
        train_counts, entry_counts = phase_train(tmp)
        api_counts = phase_tools_api(tmp, fasta_p, bam_p, indel_fasta,
                                     indel_bam)
        watchdog_counts = phase_watchdog(tmp, dag_fasta, dag_bam, dag_wall,
                                         dist_wall)

    def pick(phase):
        return next(r for r in rows if r["phase"] == phase and
                    r["inputs"] == "bucket" and
                    (r["Q"], r["R"], r["scoring"]) == (192, 192, "msa"))

    k1, k2, k4 = pick("K1_nw_tb"), pick("K2_nw_walk"), pick("K4_nw_cigar")
    k5 = a2b_k5_rows[0]
    k5_rows = [r for r in rows if r["phase"] == "K5_snp_dense_pileup"] \
        + a2b_k5_rows
    k3 = next(r for r in k3_rows if r["inputs"].startswith("main_group1"))

    def api_launches(key):
        # phase 17(b)'s cuda runs: call_chunk (dedup_transfer on; K5's
        # row takes its dense run) and call_indel_chunk
        return {path: api_counts[path][key]
                for path in ("chunk_api_snp", "chunk_api_indel")}

    def max_err(phase, rows=rows):
        return max(r["max_abs_err"] for r in rows if r["phase"] == phase)

    kernels = [
        {"name": "nw_tb", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/nw_tb.cu",
         "replaces": "nanocaller_tpu/align/pallas_nw.py:102",
         "launches": dag_counts["NW_TB_LAUNCHES"],
         "launches_by_path": {"indels": counts["NW_TB_LAUNCHES"],
                              "all": all_counts["NW_TB_LAUNCHES"],
                              "all_cpuN": dag_counts["NW_TB_LAUNCHES"],
                              "all_ccs": ccs_counts["NW_TB_LAUNCHES"],
                              "all_cpuN_2proc": dist_counts["NW_TB_LAUNCHES"],
                              "all_cpuN_watchdog": watchdog_counts["NW_TB_LAUNCHES"],
                              "train_indel_features":
                                  train_counts["NW_TB_LAUNCHES"],
                              **api_launches("NW_TB_LAUNCHES")},
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
                              "all_cpuN": dag_counts["NW_WALK_LAUNCHES"],
                              "all_ccs": ccs_counts["NW_WALK_LAUNCHES"],
                              "all_cpuN_2proc": dist_counts["NW_WALK_LAUNCHES"],
                              "all_cpuN_watchdog": watchdog_counts["NW_WALK_LAUNCHES"],
                              "train_indel_features":
                                  train_counts["NW_WALK_LAUNCHES"],
                              **api_launches("NW_WALK_LAUNCHES")},
         "max_abs_err": max_err("K2_nw_walk"),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "shape": "B=1024 Q=192 R=192 msa scoring"},
        {"name": "nw_cigar", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/nw_cigar.cu",
         "replaces": "nanocaller_tpu/align/batch_nw.py:266-309 (host walk)",
         "launches": dag_counts["NW_CIGAR_LAUNCHES"],
         "launches_by_path": {"indels": counts["NW_CIGAR_LAUNCHES"],
                              "all": all_counts["NW_CIGAR_LAUNCHES"],
                              "all_cpuN": dag_counts["NW_CIGAR_LAUNCHES"],
                              "all_ccs": ccs_counts["NW_CIGAR_LAUNCHES"],
                              "all_cpuN_2proc": dist_counts["NW_CIGAR_LAUNCHES"],
                              "all_cpuN_watchdog": watchdog_counts["NW_CIGAR_LAUNCHES"],
                              "train_indel_features":
                                  train_counts["NW_CIGAR_LAUNCHES"],
                              **api_launches("NW_CIGAR_LAUNCHES")},
         "max_abs_err": max_err("K4_nw_cigar"),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None, "shape": "B=1024 Q=192 R=192 msa scoring"},
        {"name": "snp_pileup", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/snp_pileup.cu",
         "replaces": "nanocaller_tpu/snp_caller.py:417 and :483",
         "launches": dag_counts["SNP_PILEUP_LAUNCHES"],
         "launches_by_path": {"snps": snp_counts["SNP_PILEUP_LAUNCHES"],
                              "all": all_counts["SNP_PILEUP_LAUNCHES"],
                              "all_cpuN": dag_counts["SNP_PILEUP_LAUNCHES"],
                              "all_ccs": ccs_counts["SNP_PILEUP_LAUNCHES"],
                              "all_cpuN_2proc":
                                  dist_counts["SNP_PILEUP_LAUNCHES"],
                              "all_cpuN_watchdog":
                                  watchdog_counts["SNP_PILEUP_LAUNCHES"],
                              "entry": entry_counts["SNP_PILEUP_LAUNCHES"],
                              **api_launches("SNP_PILEUP_LAUNCHES"),
                              **{"a2b_%s_%s_wire" % (path, wire):
                                 c["k3_" + wire]
                                 for path, c in a2b_counts.items()
                                 for wire in ("group", "chunk")}},
         "max_abs_err": max_err("K3_snp_pileup", k3_rows + a2b_k3_rows),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None,
         "shape": "B=%d rows, N=%d reads, S=%d sites (%s)"
                  % (k3["B"], k3["N"], k3["S"], k3["inputs"])},
        {"name": "snp_dense_pileup", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/snp_dense_pileup.cu",
         "replaces": "nanocaller_tpu/snp_caller.py:79 and :61",
         "launches": a2b_counts["snps_dense"]["k5"],
         "launches_by_path": {
             **{"a2b_" + path: c["k5"] for path, c in a2b_counts.items()},
             "all_cpuN_2proc": dist_counts["SNP_DENSE_LAUNCHES"],
             "chunk_api_snp":
                 api_counts["chunk_api_snp_dense"]["SNP_DENSE_LAUNCHES"],
             "chunk_api_indel":
                 api_counts["chunk_api_indel"]["SNP_DENSE_LAUNCHES"]},
         "max_abs_err": max_err("K5_snp_dense_pileup", k5_rows),
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None,
         "shape": "B=%d rows, R=%d reads (the largest batch of the "
                  "--no_dedup_transfer run)" % (k5["B"], k5["R"]),
         "other_shapes": [{k: r[k] for k in (
             "inputs", "B", "R", "ms", "plain_ms", "bound_ms", "bound_by")}
             for r in k5_rows[:-len(a2b_k5_rows)] + a2b_k5_rows[1:]]},
        {"name": "snp_trunk", "route": "cuda",
         "source": "nanocaller_tpu_torch/csrc/snp_trunk.cu",
         "replaces": "no TPU kernel: the SNP CNN's cuDNN trunk "
                     "(models/snp.py)",
         "max_abs_err": max(r["max_abs_err"] for r in k6_rows_),
         "ms": k6_rows_[0]["ms"], "plain_ms": k6_rows_[0]["plain_ms"],
         "bound_ms": k6_rows_[0]["bound_ms"],
         "bound_by": k6_rows_[0]["bound_by"],
         "library_ms": k6_rows_[0]["library_ms"],
         "shape": "B=%d rows (a full SNP CNN slice)" % k6_rows_[0]["B"],
         "other_shapes": [{k: r[k] for k in (
             "B", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
             for r in k6_rows_[1:]]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
