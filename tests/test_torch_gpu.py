"""The CUDA kernels against their plain twins on the card, exactly.
K1 (nw_tb) and K2 (nw_walk): at the main path's buckets, at the edges of
K1's 32-lane column strips, with a batch that leaves the last CTA part
empty, with pad codes, and on tie-heavy pairs. K4 (nw_cigar): at every
bucket, on bytes with soft-masked (lowercase) stretches and N, empty
sides, long runs, bad streams; BatchAligner's packed runs. K3
(snp_pileup), on its three outputs: normal, deep and haploid cohorts of
a simulated group, random payloads (holes, dense exceptions, reads out
of start order, a read over every site, every band schedule, clamped
windows), one row, rows without neighbours, at the first and last site,
deep rows with no valid id, windows longer than the kernel's list, and
the wrapper's refusals; K3 on a chunk wire (the per-chunk path's rows,
normal and deep, windows over the whole neighbour array), its x equal to
K5's on the same chunk's dense batch; K5 (snp_dense_pileup) at B = 4096
and R = 32, 64, 160 with deep and masked-off rows, uint8 masks, one row,
no row, and the wrapper's refusals; K4 and K5 on their hand-built edge
inputs (sim.cigar_edge_case, sim.dense_edge_case), whole and from their
second row (rows off the 16-byte grid); a SNP decode group over the payload
caps, sent member by member (one K3 launch a member), against its
uncapped run;
`--mode all --cpu 2` on cuda against cpu, with no CUDA context in a
worker; two replicas on the card (bit-identical probabilities, one K3 or
K5 launch a cohort and replica) and two `--num_processes 2` processes
on it; one train step of each model cuda against cpu (and twice on the
card, bit-identical), and the sharded SNP step at world size 1 on NCCL
against the unsharded step, bit for bit; the one-chunk entry points
call_chunk (K3 on the chunk wire, or K5) and call_indel_chunk (K1, K2,
K4) on cuda against cpu. Skips without a GPU.

Imports neither jax nor the JAX package, so that it also runs where only
the port is installed: `python -m pytest --noconftest tests/test_torch_gpu.py`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.align.batch_nw import (BatchAligner, encode_pairs,
                                                 pad_bytes)
from nanocaller_tpu_torch.align.nw import nw_align, unpack_cigar
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile, write_fasta
from nanocaller_tpu_torch.pileup import snp_dense as K5
from nanocaller_tpu_torch.pileup import snp_pileup as K3
from nanocaller_tpu_torch.pileup.snp_features import (BAND_SCHEDULES,
                                                      get_snp_candidates,
                                                      get_snp_chunk_features,
                                                      get_snp_group_payloads)
from nanocaller_tpu_torch.sim import (BASES, CIGAR_EDGE_LABELS,
                                      DENSE_EDGE_LABELS, TIE_KINDS,
                                      cigar_edge_case, dense_edge_case,
                                      make_diploid_readset,
                                      random_dense_batch, random_group_wire,
                                      random_seq, tie_heavy_pairs, write_bam)
from nanocaller_tpu_torch.snp_caller import (SnpCallerState, _coverage_norm,
                                             chunk_cohorts, pileup_cohorts)

from torch_threads import _torch_threads  # noqa: F401 (autouse)

SCORINGS = [(20, -10, 9, 1), (5, -4, 8, 1)]
# R at the edges of the strips (K = ceil(R/32) columns per lane), each
# with a one-row, a short and a main-path query
EDGES = [(Q, R) for R in (1, 31, 32, 33, 63, 511, 512) for Q in (1, 7, 192)]
# one shape for each compiled instance of K1: the wavefront with 4 pairs
# a CTA (B = 531) and with one (B = 37), and the rows kernel (Q < 96)
INSTANCES = ([(100, R, 531) for R in (64, 128, 256, 300, 512, 1023)]
             + [(100, R, 37) for R in (64, 128, 192, 256, 320, 600)]
             + [(50, R, 37) for R in (128, 256, 1023)])


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


def _codes(rng, B, n, pad_tail):
    c = rng.integers(0, 5, (B, n)).astype(np.int8)
    c[:, n - pad_tail:] = 4
    return c


def _check_both(q, r, ql, rl):
    qc, rc = torch.from_numpy(q).cuda(), torch.from_numpy(r).cuda()
    ql, rl = torch.from_numpy(ql), torch.from_numpy(rl)
    Q, R = q.shape[1], r.shape[1]
    T = 2 * (Q + R) + 2
    for params in SCORINGS:
        tb = K.nw_tb(qc, rc, *params)
        want = K.nw_tb_reference(qc, rc, *params)
        torch.cuda.synchronize()
        assert torch.equal(tb, want)
        ops = K.nw_walk(tb, ql, rl, T)
        torch.cuda.synchronize()
        assert torch.equal(ops, K.nw_walk_reference(tb, ql.cuda(),
                                                    rl.cuda(), T))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,R,B,kind", [
    (192, 192, 64, "random"), (256, 192, 64, "random"),
    (512, 512, 64, "random"), (7, 1, 64, "random"),
    # 531 fills 132 CTAs of 4 pairs and leaves 3 in the last
    (192, 192, 531, "random"), (64, 192, 531, "random")]
    + [(Q, R, 37, "random") for Q, R in EDGES]
    + [(Q, R, B, "random") for Q, R, B in INSTANCES]
    + [(Q, R, 96, kind) for kind in TIE_KINDS
       for Q, R in ((192, 192), (64, 192), (33, 31))])
def test_kernels_match_twins(Q, R, B, kind):
    _need_gpu()
    rng = np.random.default_rng(Q + R + B + len(kind))
    if kind == "random":
        # pad code 4 in both sequences, at random and in a padded tail
        q = _codes(rng, B, Q, pad_tail=min(7, Q - 1))
        r = _codes(rng, B, R, pad_tail=min(2, R - 1))
        ql = rng.integers(0, Q + 1, B).astype(np.int32)
        rl = rng.integers(0, R + 1, B).astype(np.int32)
        _check_both(q, r, ql, rl)
    else:
        _check_both(*encode_pairs(tie_heavy_pairs(rng, B, Q, R, kind), Q, R))


@pytest.mark.cuda
def test_walk_range_check_without_sync():
    """nw_walk checks the lengths on the host: a good call makes no
    synchronizing CUDA call, bad lengths and CUDA lengths raise."""
    _need_gpu()
    rng = np.random.default_rng(3)
    Q, R, B = 64, 48, 40
    q, r = _codes(rng, B, Q, 0), _codes(rng, B, R, 0)
    ql = torch.from_numpy(rng.integers(0, Q + 1, B).astype(np.int32))
    rl = torch.from_numpy(rng.integers(0, R + 1, B).astype(np.int32))
    T = 2 * (Q + R) + 2
    tb = K.nw_tb(torch.from_numpy(q).cuda(), torch.from_numpy(r).cuda(),
                 *SCORINGS[1])
    K.nw_walk(tb, ql, rl, T)  # first call: builds, loads, pins
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops = K.nw_walk(tb, ql, rl, T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(ops, K.nw_walk_reference(tb, ql.cuda(), rl.cuda(), T))
    bad = ql.clone()
    bad[B // 2] = Q + 1
    with pytest.raises(ValueError, match="qlens"):
        K.nw_walk(tb, bad, rl, T)
    with pytest.raises(ValueError, match="CPU"):
        K.nw_walk(tb, ql.cuda(), rl, T)


@pytest.mark.cuda
def test_batch_aligner_cigars_on_card():
    _need_gpu()
    rng = np.random.default_rng(9)
    pairs = []
    for n in (40, 64, 150, 200, 260, 330, 500):
        r = "".join("ACGT"[int(b)] for b in rng.integers(0, 4, n))
        q = r[: n // 3] + "GAT" + r[n // 3 + 2:]
        pairs.append((q, r))
    pairs.append(("", "ACG"))
    before = K.NW_TB_LAUNCHES
    got = BatchAligner(device="cuda").align_many(pairs)
    assert K.NW_TB_LAUNCHES > before
    assert got == [nw_align(q, r)[1] for q, r in pairs]


def _cigar_case(rng, B, Q, R):
    """B pairs for one bucket as raw bytes: mutated windows with random
    lowercase and N bytes, a long identical stretch, one empty side each
    and both empty."""
    pairs = []
    for b in range(B):
        n = int(rng.integers(1, min(Q, R) + 1))
        r = "".join("ACGTNacgtn"[int(x)] for x in
                    rng.choice(10, n, p=[.22] * 4 + [.02] + [.02] * 4
                               + [.02]))
        q = "".join(c if rng.random() > 0.1 else "ACGTa"[int(rng.integers(5))]
                    for c in r[: int(rng.integers(0, n + 1))])
        q += r[len(q):][: Q - len(q)] if b % 3 else ""
        pairs.append((q[:Q], r))
    pairs[:3] = [("", pairs[0][1]), (pairs[1][1][:Q], ""), ("", "")]
    long = "ACGT" * (min(Q, R) // 4)
    pairs[3] = (long, long)
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("Q,R,B", [
    (64, 64, 300), (128, 192, 300), (192, 192, 1024), (256, 320, 1024),
    (320, 256, 131), (512, 512, 1024)])
def test_cigar_kernel_matches_twin(Q, R, B):
    _need_gpu()
    rng = np.random.default_rng(Q * 3 + R + B)
    pairs = _cigar_case(rng, B, Q, R)
    qc, rc, ql, rl = encode_pairs(pairs, Q, R)
    qraw, _ = pad_bytes([q for q, _ in pairs], Q)
    rraw, _ = pad_bytes([r for _, r in pairs], R)
    tb = K.nw_tb(torch.from_numpy(qc).cuda(), torch.from_numpy(rc).cuda(),
                 *SCORINGS[1])
    ops = K.nw_walk(tb, torch.from_numpy(ql), torch.from_numpy(rl),
                    2 * (Q + R) + 2)
    qd, rd = torch.from_numpy(qraw).cuda(), torch.from_numpy(rraw).cuda()
    before = K.NW_CIGAR_LAUNCHES
    runs, counts = K.nw_cigar(ops, qd, rd)
    torch.cuda.synchronize()
    assert K.NW_CIGAR_LAUNCHES == before + 1
    w_runs, w_counts = K.nw_cigar_reference(ops, qd, rd)
    assert torch.equal(counts, w_counts) and int(counts.min()) >= 0
    keep = torch.arange(Q + R, device="cuda")[None, :] < counts[:, None]
    assert torch.equal(torch.where(keep, runs, 0), w_runs)
    assert int(counts[2]) == 0 and int((w_runs >> 4).max()) > 15


@pytest.mark.cuda
def test_cigar_kernel_flags_bad_streams():
    _need_gpu()
    ops = torch.zeros((3, 10), dtype=torch.int8)
    ops[0, :4] = 1  # four diagonal steps for Q = 3
    ops[1, 0] = 5
    ops[2, 2:4] = torch.tensor([2, 1], dtype=torch.int8)
    q = torch.full((3, 3), ord("A"), dtype=torch.uint8)
    r = torch.full((3, 2), ord("A"), dtype=torch.uint8)
    runs, counts = K.nw_cigar(ops.cuda(), q.cuda(), r.cuda())
    assert counts.tolist() == [-1, -1, 2]
    assert runs[2, :2].tolist() == [(1 << 4) | 7, (1 << 4) | 1]


# the edge inputs, whole and from their second row (one-row inputs whole)
_EDGE_VIEWS = [(label, view) for label in CIGAR_EDGE_LABELS
               + DENSE_EDGE_LABELS for view in ("whole", "from_row_1")
               if view == "whole" or not label.startswith("one_")]


@pytest.mark.cuda
@pytest.mark.parametrize("label,view", [
    lv for lv in _EDGE_VIEWS if lv[0] in CIGAR_EDGE_LABELS])
def test_cigar_kernel_edge_inputs(label, view):
    """K4 against its twin, exactly, on the hand-built edge inputs
    (sim.cigar_edge_case: the last non-zero step at 16-, 32- and 128-byte
    block edges, all-zero rows, bad streams with the fault in the first,
    a middle and the last chunk, B = 1, B one over where the kernel goes
    from 4 warps a pair to 2 and to 1 and past a wave, every bucket pair
    the main path, --preset ccs and training launch); from_row_1 passes
    the arrays from their second row, so that the op rows start 2 bytes
    off the 16-byte grid."""
    _need_gpu()
    ops, qraw, rraw = (torch.from_numpy(a).cuda()
                       for a in cigar_edge_case(label))
    if view == "from_row_1":
        ops, qraw, rraw = ops[1:], qraw[1:], rraw[1:]
    before = K.NW_CIGAR_LAUNCHES
    runs, counts = K.nw_cigar(ops, qraw, rraw)
    torch.cuda.synchronize()
    assert K.NW_CIGAR_LAUNCHES == before + 1
    w_runs, w_counts = K.nw_cigar_reference(ops, qraw, rraw)
    assert torch.equal(counts, w_counts)
    keep = torch.arange(runs.shape[1], device="cuda")[None, :] < \
        counts[:, None]
    assert torch.equal(torch.where(keep, runs, 0),
                       torch.where(keep, w_runs, 0))
    if label.startswith("bad"):
        assert int((counts == -1).sum()) >= 9


@pytest.mark.cuda
def test_batch_aligner_packed_on_card():
    """The packed runs from K4 unpack to the cuda path's lists and to the
    cpu twins' runs, soft-masked and N bytes included."""
    _need_gpu()
    rng = np.random.default_rng(10)
    pairs = _cigar_case(rng, 200, 192, 192) + _cigar_case(rng, 40, 256, 320)
    before = K.NW_CIGAR_LAUNCHES
    packed = BatchAligner(*SCORINGS[1], device="cuda").align_many(
        pairs, packed=True)
    assert K.NW_CIGAR_LAUNCHES > before
    plain = BatchAligner(*SCORINGS[1], device="cuda").align_many(pairs)
    cpu = BatchAligner(*SCORINGS[1], device="cpu").align_many(pairs,
                                                              packed=True)
    assert [unpack_cigar(c) for c in packed] == plain
    assert all(np.array_equal(a, b) for a, b in zip(packed, cpu))


class _Cfg:
    batch_size = 128
    disable_coverage_normalization = False


@pytest.fixture(scope="module")
def snp_group(tmp_path_factory):
    """(state, {ploidy: SnpGroupFeatures}) of a simulated 60 kb, 30x
    group of three members, maxcov 24 so that members have deep rows."""
    _need_gpu()
    tmp = tmp_path_factory.mktemp("gpu_snp")
    rng = np.random.default_rng(6)
    L = 60000
    ref = random_seq(rng, L)
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(400, L - 400, 700))]
    reads = make_diploid_readset(rng, ref, snps=snps, depth=30,
                                 read_len=2000, error_rate=0.03)
    write_fasta(str(tmp / "ref.fa"), {"chr_t": ref})
    write_bam(str(tmp / "reads.bam"), "chr_t", L, reads)
    state = SnpCallerState.create("ONT-HG002", device="cuda")
    out = {}
    for ploidy in ("diploid", "haploid"):
        members = [{"chrom": "chr_t", "start": 1 + i * 20000,
                    "end": (i + 1) * 20000, "ploidy": ploidy}
                   for i in range(3)]
        [gf] = get_snp_group_payloads(
            BamReader(str(tmp / "reads.bam")), FastaFile(str(tmp / "ref.fa")),
            members, seq_type="ul_ont", maxcov=24)
        gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
        out[ploidy] = gf
    return state, out


def _k3_equal(args):
    """K3 against its twin on both outputs (and the ref one-hot),
    exactly; one launch."""
    before = K3.SNP_PILEUP_LAUNCHES
    got = K3.snp_pileup(*args)
    want = K3.snp_pileup_reference(*args)
    torch.cuda.synchronize()
    assert K3.SNP_PILEUP_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("ploidy,deep", [("diploid", False),
                                         ("diploid", True),
                                         ("haploid", False)])
def test_snp_pileup_cohorts_match_twin(snp_group, ploidy, deep):
    state, groups = snp_group
    gf = groups[ploidy]
    launches = [a for p, d, a, _, _, _ in pileup_cohorts(state, gf, _Cfg())
                if (p, d) == (ploidy, deep)]
    assert len(launches) == 1
    x, soc, _ = _k3_equal(launches[0])
    assert x.shape[0] > 5 and float(x[:, 1:].abs().sum()) > 0
    assert int((soc >= 0).sum()) > 20 * soc.shape[0]


def _cuda_args(wire_host, *rows):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (K3.group_wire(wire_host, "cuda"), *map(t, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_snp_pileup_random_payloads(seed):
    """Holes, dense exceptions, empty spans, with and without a minor
    bitmask; reads out of start order, a read over every site (odd
    seeds), every band schedule, clamped member windows; normal rows,
    then the same rows as deep rows over random read ids."""
    _need_gpu()
    rng = np.random.default_rng(40 + seed)
    S, N = int(rng.integers(3, 300)), int(rng.integers(2, 700))
    kinds = sorted(BAND_SCHEDULES)
    wire, *rows = random_group_wire(
        rng, S, N, B=int(rng.integers(1, 200)), max_span=min(S, 60),
        bitmask=seed % 3 != 0, seq_type=kinds[seed % len(kinds)],
        span_all=seed % 2 == 1)
    args = _cuda_args(wire, *rows)
    _k3_equal(args)
    B = len(rows[0])
    N = len(wire.read_lo)
    rids = torch.from_numpy(rng.integers(0, N, (B, 24)).astype(np.int32))
    n_valid = torch.from_numpy(rng.integers(0, 25, B).astype(np.int32))
    _k3_equal(args + (rids.cuda(), n_valid.cuda()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_row", "all_padding", "no_neighbours",
                                  "first_last_site", "deep_none_valid",
                                  "long_window"])
def test_snp_pileup_edge_rows(case):
    _need_gpu()
    rng = np.random.default_rng(7)
    kw = dict(nbr_share=0.0) if case == "no_neighbours" else {}
    if case == "long_window":
        # one read over every site and many long reads: windows of
        # several hundred reads, taken in rounds of the kernel's list
        kw = dict(max_span=50, span_all=True, exc_share=0.05,
                  hole_share=0.02)
    N = 900 if case == "long_window" else 200
    wire, *rows = random_group_wire(rng, 50, N, B=3, **kw)
    cand_site, cand_pos, lo_c, hi_c, norm = rows
    S = len(wire.site_ref)
    if case == "one_row":
        rows = [a[:1] for a in rows]
    elif case == "all_padding":
        lo_c[1] = hi_c[1] = 0  # an empty window: only the centre column
        cand_site[2] = -1  # a candidate below 0 reads the trash site
    elif case == "first_last_site":
        # before every neighbour and after every neighbour
        for i, s, p in ((0, 0, wire.nbr_pos[0] - 1),
                        (1, S - 1, wire.nbr_pos[-1] + 1)):
            cand_site[i], cand_pos[i] = s, p
            lo_c[i], hi_c[i] = 0, len(wire.nbr_pos)
    elif case == "long_window":
        cand_site[:] = (25, 49, 40)
    args = _cuda_args(wire, *rows)
    if case == "deep_none_valid":
        B = len(cand_site)
        rids = torch.zeros((B, 8), dtype=torch.int32, device="cuda")
        args += (rids, torch.tensor([0, 3, 0], dtype=torch.int32,
                                    device="cuda"))
    x, soc, _ = _k3_equal(args)
    if case == "all_padding":
        assert float(x[2, 1:].abs().sum()) == 0.0
        assert (soc[1].cpu() >= 0).sum() == 1
    if case == "no_neighbours":
        assert int((soc >= 0).sum()) == soc.shape[0]
    if case == "long_window":
        wire, cand_site = args[0], args[1].long()
        assert int((wire.win_hi[cand_site] - wire.win_lo[cand_site]).min()) \
            > 256


@pytest.mark.cuda
def test_snp_pileup_wrapper_refuses():
    _need_gpu()
    wire, cand_site, cand_pos, lo_c, hi_c, norm = _cuda_args(
        *random_group_wire(np.random.default_rng(8), 30, 80, B=4))
    rows = [cand_site, cand_pos, lo_c, hi_c, norm]
    for i, name in enumerate(("cand_site", "cand_pos", "lo_c", "hi_c")):
        with pytest.raises(TypeError, match=name):  # refused, not cast
            K3.snp_pileup(wire, *rows[:i], rows[i].long(), *rows[i + 1:])
    with pytest.raises(ValueError, match="expected cuda"):
        K3.snp_pileup(wire, *rows[:4], norm.cpu())
    with pytest.raises(ValueError, match="expected cuda"):
        K3.snp_pileup(wire, cand_site, cand_pos.cpu(), *rows[2:])
    with pytest.raises(ValueError, match="expected cpu"):
        K3.snp_pileup(wire, *(r.cpu() for r in rows))
    with pytest.raises(TypeError, match="nbr_union"):
        K3.snp_pileup(dataclasses.replace(wire,
                                          nbr_union=wire.nbr_union.long()),
                      *rows)
    with pytest.raises(ValueError, match="win_hi"):
        K3.snp_pileup(dataclasses.replace(wire, win_hi=wire.win_hi[:-1]),
                      *rows)


@pytest.fixture(scope="module")
def snp_chunk(tmp_path_factory):
    """(state, {maxcov: (SnpChunkFeatures, SnpBatch)}) of one 40 kb chunk
    of a simulated 60 kb, 30x contig (its scan window is the whole
    contig); maxcov 24 gives deep rows."""
    _need_gpu()
    tmp = tmp_path_factory.mktemp("gpu_snp_chunk")
    rng = np.random.default_rng(16)
    L = 60000
    ref = random_seq(rng, L)
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(400, L - 400, 700))]
    reads = make_diploid_readset(rng, ref, snps=snps, depth=30,
                                 read_len=2000, error_rate=0.03)
    fa, bam_p = str(tmp / "ref.fa"), str(tmp / "reads.bam")
    write_fasta(fa, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads)
    chunk = {"chrom": "chr_t", "start": 10001, "end": 50000,
             "ploidy": "diploid"}
    out = {}
    for maxcov in (160, 24):
        args = (BamReader(bam_p), FastaFile(fa), chunk)
        out[maxcov] = (get_snp_chunk_features(*args, maxcov=maxcov),
                       get_snp_candidates(*args, maxcov=maxcov))
    return SnpCallerState.create("ONT-HG002", device="cuda"), out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("maxcov", [160, 24])
def test_snp_pileup_on_chunk_wire(snp_chunk, maxcov):
    """K3 on the chunk's wire against its twin, exactly, one launch a
    cohort counted as a chunk launch; the x it builds equals, bit for
    bit, K5's on the same chunk's dense batch."""
    state, chunks = snp_chunk
    feats, batch = chunks[maxcov]
    B = len(feats)
    assert B > 20 and (len(feats.deep_idx) > 0) == (maxcov == 24)
    x = torch.zeros((B, 5, 41, 5), device="cuda")
    launches = K3.BY_WIRE["chunk"]
    cohorts = chunk_cohorts(state, feats, _Cfg(), "diploid")
    assert [d for d, _, _, _ in cohorts] == ([False, True] if maxcov == 24
                                          else [False])
    for _deep, args, rows, _r in cohorts:
        assert args[0].kind == "chunk"
        x[_t(rows)] = _k3_equal(args)[0]
    assert K3.BY_WIRE["chunk"] == launches + len(cohorts)
    norm = _coverage_norm(state, feats, "diploid", _Cfg())
    dense = (_t(batch.codes), _t(batch.read_mask), _t(batch.col_ref),
             _t(batch.col_valid), _t(batch.center_ref), _t(norm))
    xd, _ = K5.snp_dense_pileup(*dense)
    torch.cuda.synchronize()
    assert torch.equal(x, xd)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [32, 64, 160])
def test_dense_pileup_matches_twin(R):
    """K5 against its twin at B = 4096, exactly, with deep rows (every
    read masked in) and reads masked off with codes; one launch."""
    _need_gpu()
    args = [_t(a) for a in random_dense_batch(np.random.default_rng(R),
                                              4096, R)]
    before = K5.SNP_DENSE_LAUNCHES
    got = K5.snp_dense_pileup(*args)
    want = K5.snp_dense_pileup_reference(*args)
    torch.cuda.synchronize()
    assert K5.SNP_DENSE_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    assert float(got[0][:, 1:].abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,R", [(1, 1), (1, 200), (0, 64), (37, 129)])
def test_dense_pileup_edges(B, R):
    """One row, a read axis past a tile of 128, no row; uint8 masks."""
    _need_gpu()
    rng = np.random.default_rng(B * 1000 + R)
    host = random_dense_batch(rng, max(B, 1), R)
    args = [_t(a[:B]) for a in host]
    args[1], args[3] = args[1].to(torch.uint8), args[3].to(torch.uint8)
    got = K5.snp_dense_pileup(*args)
    want = K5.snp_dense_pileup_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("label,view", [
    lv for lv in _EDGE_VIEWS if lv[0] in DENSE_EDGE_LABELS])
def test_dense_pileup_edge_inputs(label, view):
    """K5 against its twin, exactly, on the edge inputs
    (sim.dense_edge_case: R = 0, 1, 15, 17, 224, 225, 255, 256, 300 at
    B = 133 with prefix and scattered read masks, one row at R = 45 and
    300, columns whose count is R); from_row_1 passes the arrays from
    their second row, so that the code rows start off the 16-byte
    grid."""
    _need_gpu()
    args = [_t(a) for a in dense_edge_case(label)]
    if view == "from_row_1":
        args = [a[1:] for a in args]
    before = K5.SNP_DENSE_LAUNCHES
    got = K5.snp_dense_pileup(*args)
    torch.cuda.synchronize()
    assert K5.SNP_DENSE_LAUNCHES == before + 1
    want = K5.snp_dense_pileup_reference(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_dense_pileup_wrapper_refuses():
    _need_gpu()
    args = [_t(a) for a in random_dense_batch(np.random.default_rng(2),
                                              8, 16)]
    with pytest.raises(ValueError, match="on cpu"):
        K5.snp_dense_pileup(*args[:5], args[5].cpu())
    with pytest.raises(TypeError, match="codes"):
        K5.snp_dense_pileup(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="col_ref"):
        K5.snp_dense_pileup(*args[:2], args[2][:, :40].contiguous(),
                            *args[3:])


def _snp_records(path):
    import gzip

    with gzip.open(path, "rt") as fh:
        return [l.rstrip("\n").split("\t") for l in fh
                if not l.startswith("#")]


@pytest.mark.cuda
def test_group_over_caps_on_card(tmp_path, monkeypatch):
    """A decode group over the payload caps on the card: each member goes
    as a group of one (one K3 launch a member cohort), and the SNP VCFs
    hold the uncapped group run's records (PR may differ by one unit of
    its rounding and QUAL by one or within the parity bar: the CNN runs
    on other batches)."""
    _need_gpu()
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.pileup import snp_features as sf
    from nanocaller_tpu_torch.pileup.engine import decode_reads
    from nanocaller_tpu_torch.snp_caller import call_snps

    rng = np.random.default_rng(21)
    L = 200_000
    ref = random_seq(rng, L)
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(900, L - 900, 1700))]
    reads = make_diploid_readset(rng, ref, snps=snps, depth=12,
                                 read_len=2000, error_rate=0.01)
    fa, bam_p = str(tmp_path / "ref.fa"), str(tmp_path / "reads.bam")
    write_fasta(fa, {"chr_t": ref})
    write_bam(bam_p, "chr_t", L, reads)
    bam = BamReader(bam_p)
    cap = max(decode_reads(bam, "chr_t", 0, 150_000).n_reads,
              decode_reads(bam, "chr_t", 50_000, L).n_reads)
    assert cap < decode_reads(bam, "chr_t", 0, L).n_reads
    chunks = [{"chrom": "chr_t", "start": 1, "end": 100_000,
               "ploidy": "diploid"},
              {"chrom": "chr_t", "start": 100_001, "end": L,
               "ploidy": "diploid"}]
    runs = {}
    for name, limit in (("capped", cap), ("whole", 1 << 15)):
        monkeypatch.setattr(sf, "_GROUP_MAX_READS", limit)
        out = str(tmp_path / name)
        os.makedirs(out)
        K3.reset_counters()
        call_snps(Config(bam=bam_p, ref=fa, mode="snps", cpu=1, output=out,
                         prefix="p", sample="S", device="cuda"),
                  BamReader(bam_p), [("chr_t", 1, L, "diploid")], [dict(c) for c in chunks],
                  out)
        runs[name] = (K3.SNP_PILEUP_LAUNCHES,
                      _snp_records(os.path.join(out,
                                                "p.unfiltered.snps.vcf.gz")))
    assert runs["capped"][0] == 2 and runs["whole"][0] == 1
    got, want = runs["capped"][1], runs["whole"][1]
    assert len(got) == len(want) > 50
    for x, y in zip(got, want):
        if x == y:
            continue
        assert x[:5] + x[6:7] + x[8:] == y[:5] + y[6:7] + y[8:], (x, y)
        # QUAL: one unit of %.3f, or implied probabilities within 2e-5
        qx, qy = float(x[5]), float(y[5])
        assert abs(qx - qy) <= 0.0010001 or \
            abs(10 ** (-qx / 10) - 10 ** (-qy / 10)) <= 2e-5, (x, y)
        px = [float(v) for v in x[7].split(";")[0][3:].split(",")]
        py = [float(v) for v in y[7].split(";")[0][3:].split(",")]
        assert np.abs(np.subtract(px, py)).max() <= 1.0001e-4, (x, y)


@pytest.mark.cuda
def test_dag_cpu2_on_card(tmp_path):
    """`--mode all --cpu 2` with --haploid_X on the two-contig fixture of
    tests/test_torch_dag.py, on cuda against the cpu run by chip_smoke's
    record rules; K1, K2 and K3 launch in this process, and no worker
    holds a CUDA context (nvidia-smi lists one process at most; no worker
    maps libcuda)."""
    _need_gpu()
    import chip_smoke
    from nanocaller_tpu_torch.caller import run
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.sim import write_contigs_fixture

    fa, bam_p, _, _ = write_contigs_fixture(
        str(tmp_path), [("chr1", 60000, 11, 500, 4000, False),
                        ("chrX", 30000, 12, 500, 4000, True)],
        depth=30, read_len=3000)
    outs = {}
    for dev in ("cuda", "cpu"):
        K.reset_counters()
        K3.reset_counters()
        with chip_smoke.CudaContextWatch() as watch:
            outs[dev] = run(Config(
                bam=bam_p, ref=fa, mode="all", cpu=2, haploid_X=True,
                output=str(tmp_path / dev), prefix="p", sample="S",
                device=dev, suppress_progress=True))
        if dev == "cuda":
            assert K3.SNP_PILEUP_LAUNCHES > 0 and K.NW_TB_LAUNCHES > 0 \
                and K.NW_WALK_LAUNCHES > 0
            assert len(watch.smi_pids) <= 1 and not watch.cuda_children
            assert len(watch.workers) >= 2
    unf = lambda p: p.replace(".snps.vcf.gz", ".unfiltered.snps.vcf.gz")
    for key, kind in (("snps", "snp"), ("phased_snps", "snp"),
                      ("indels", "indel"), ("final", "any")):
        n, _ = chip_smoke.compare_records(outs["cuda"][key], outs["cpu"][key],
                                          kind)
        assert n > 0
    chip_smoke.compare_records(unf(outs["cuda"]["snps"]),
                               unf(outs["cpu"]["snps"]), "snp")


class _DpCfg:
    # a per-device batch small enough that each cohort's rows spread over
    # both replicas
    batch_size = 16
    disable_coverage_normalization = False


@pytest.mark.cuda
def test_two_replicas_on_card(snp_group, snp_chunk):
    """Two replicas on cuda:0 (runtime/sharding.py): the group, chunk and
    dense routes' probabilities equal one replica's bit for bit, with one
    K3 or K5 launch a cohort and replica; the indel CNN's too."""
    from nanocaller_tpu_torch import indel_caller as I
    from nanocaller_tpu_torch.snp_caller import (infer_snp_batch,
                                                 infer_snp_chunk,
                                                 infer_snp_group)

    one, groups = snp_group
    two = SnpCallerState.create("ONT-HG002", device="cuda",
                                devices=["cuda:0", "cuda:0"])
    assert len(two.replicas) == 2
    for gf in groups.values():
        before = K3.SNP_PILEUP_LAUNCHES
        got = infer_snp_group(two, gf, _DpCfg())
        assert K3.SNP_PILEUP_LAUNCHES - before == \
            len(pileup_cohorts(two, gf, _DpCfg())) > \
            len(pileup_cohorts(one, gf, _DpCfg()))
        for g, w in zip(got, infer_snp_group(one, gf, _DpCfg())):
            np.testing.assert_array_equal(g, w)
    _state, chunks = snp_chunk
    feats, batch = chunks[24]
    np.testing.assert_array_equal(
        infer_snp_chunk(two, feats, _DpCfg(), "diploid"),
        infer_snp_chunk(one, feats, _DpCfg(), "diploid"))
    before = K5.SNP_DENSE_LAUNCHES
    got = infer_snp_batch(two, batch, _DpCfg(), "haploid")
    assert K5.SNP_DENSE_LAUNCHES - before == 2
    np.testing.assert_array_equal(
        got, infer_snp_batch(one, batch, _DpCfg(), "haploid"))
    x = np.random.default_rng(3).random((100, 15, 128, 2), np.float32)
    states = [I.IndelCallerState.create("ONT-HG002", device="cuda",
                                        devices=d)
              for d in (None, ["cuda:0", "cuda:0"])]
    got = [I._run_stacked(s, False, x, 16) for s in states]
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.cuda
def test_two_processes_on_card(tmp_path):
    """`--num_processes 2` with --device cuda: two processes on this card
    (cuda:(i mod cards)), joined by Gloo; process 0's merged VCFs hold
    the single cuda run's records (chip_smoke's rules, contig by contig)
    and both metrics.host00i.json its counts summed."""
    _need_gpu()
    import json
    import socket
    import subprocess
    import sys

    import chip_smoke
    from nanocaller_tpu_torch import cli
    from nanocaller_tpu_torch.sim import write_contigs_fixture

    fa, bam_p, _, _ = write_contigs_fixture(
        str(tmp_path), [("chr1", 10_000, 41, 300, 1500, False),
                        ("chrX", 9_500, 42, 300, 1500, True)],
        depth=30, read_len=3000)

    def argv(out, *extra):
        return ["--bam", bam_p, "--ref", fa, "--mode", "all", "--cpu", "2",
                "--haploid_X", "--device", "cuda", "--output",
                str(tmp_path / out), "--prefix", "p", "--sample", "S",
                "--suppress_progress_bar", *extra]

    one = cli.main(argv("one"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "localhost:%d" % s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanocaller_tpu_torch.cli",
         *argv("procs", "--coordinator", coord, "--num_processes", "2",
               "--process_id", str(i))], env=env, cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    for key, kind in (("snps", "snp"), ("phased_snps", "snp"),
                      ("indels", "indel"), ("final", "any")):
        got = one[key].replace(str(tmp_path / "one"), str(tmp_path / "procs"))
        n, _ = chip_smoke.compare_records(got, one[key], kind,
                                          by_contig=True)
        assert n > 0
    with open(tmp_path / "one" / "metrics.json") as fh:
        counts = json.load(fh)["counts"]
    for i in range(2):
        with open(tmp_path / "procs" / ("metrics.host%03d.json" % i)) as fh:
            assert json.load(fh)["global_counts"] == counts


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B", [("snp", 128), ("indel", 64)])
def test_train_step_cuda_matches_cpu(kind, B):
    """One train step of each model at the training CLIs' batch size from
    the same flax-like init and batch: loss within 2e-5 and every
    gradient within rtol 1e-4 / atol 1e-6 of the CPU's; two steps on the
    card bit-identical."""
    _need_gpu()
    import chip_smoke

    rng = np.random.default_rng(B)
    if kind == "snp":
        batch = {"x": rng.normal(size=(B, 5, 41, 5)).astype(np.float32),
                 "ref": np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)],
                 "base_labels": np.eye(2, dtype=np.float32)[
                     rng.integers(0, 2, (B, 4))],
                 "gt_label": np.eye(2, dtype=np.float32)[
                     rng.integers(0, 2, B)]}
    else:
        batch = {"x": rng.normal(size=(B, 15, 128, 2)).astype(np.float32),
                 "label": np.eye(4, dtype=np.float32)[
                     rng.integers(0, 4, B)]}
    state = chip_smoke.init_state(kind, 5)
    cpu = chip_smoke.one_step(kind, state, batch, "cpu")
    cuda = chip_smoke.one_step(kind, state, batch, "cuda")
    assert chip_smoke.steps_differ(cuda, cpu, kind) is None
    assert chip_smoke.steps_equal(cuda, chip_smoke.one_step(
        kind, state, batch, "cuda"))


@pytest.mark.cuda
def test_sharded_step_world_one_on_nccl():
    """The sharded SNP step in one NCCL process computes the unsharded
    step on the card bit for bit (loss, gradients, updated weights)."""
    _need_gpu()
    import chip_smoke
    from nanocaller_tpu_torch.runtime import sharding

    mesh = sharding.make_mesh(1)
    state, batch = sharding.demo_state(), sharding.demo_batch(mesh)
    out = sharding.shard_train_step_demo(1, device="cuda", state_dict=state,
                                         batch=batch)
    assert chip_smoke.steps_equal(
        (out["loss"], out["grads"], out["params"]),
        chip_smoke.one_step("snp", state, batch, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("ploidy,dedup", [("diploid", True),
                                          ("diploid", False),
                                          ("haploid", True)])
def test_call_chunk_on_card(tmp_path, ploidy, dedup):
    """snp_caller.call_chunk on cuda against cpu by chip_smoke's record
    rules: K3 on the chunk wire launches with dedup_transfer on, K5 with
    it off, and not the other."""
    _need_gpu()
    import chip_smoke
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.sim import make_fixture
    from nanocaller_tpu_torch.snp_caller import call_chunk

    fa, bam_p, _, _ = make_fixture(tmp_path, seed=17, L=40000, depth=30,
                                   read_len=2000, error_rate=0.03)
    chunk = {"chrom": "chr_t", "start": 5001, "end": 35000,
             "ploidy": ploidy}
    lines = {}
    for dev in ("cuda", "cpu"):
        cfg = Config(bam=bam_p, ref=fa, device=dev, dedup_transfer=dedup)
        state = SnpCallerState.create("ONT-HG002", device=dev)
        K3.reset_counters()
        K5.reset_counters()
        lines[dev] = call_chunk(state, BamReader(bam_p), FastaFile(fa),
                                chunk, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            k3, k5 = K3.BY_WIRE["chunk"], K5.SNP_DENSE_LAUNCHES
            assert (k3 > 0, k5 > 0) == (dedup, not dedup), (k3, k5)
    assert len(lines["cuda"]) > 10
    chip_smoke.compare_lines(lines["cuda"], lines["cpu"], "snp", "call_chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("ploidy", ["diploid", "haploid"])
def test_call_indel_chunk_on_card(tmp_path, ploidy):
    """indel_caller.call_indel_chunk on cuda against cpu by chip_smoke's
    record rules, its alignments through K1, K2 and K4."""
    _need_gpu()
    import chip_smoke
    from nanocaller_tpu_torch.config import Config
    from nanocaller_tpu_torch.indel_caller import (IndelCallerState,
                                                   call_indel_chunk)
    from nanocaller_tpu_torch.sim import make_fixture

    indels = [(p, "del", 2 + k % 5, ("het1", "het2", "hom")[k % 3])
              if k % 2 else (p, "ins", "ACGTTG"[: 1 + k % 6],
                             ("het1", "het2", "hom")[k % 3])
              for k, p in enumerate(range(1500, 18500, 2000))]
    fa, bam_p, _, _ = make_fixture(tmp_path, seed=19, L=20000, depth=30,
                                   read_len=2000, snps=[], indels=indels,
                                   error_rate=0.02, tag_haplotypes=True)
    chunk = {"chrom": "chr_t", "start": 1, "end": 20000, "ploidy": ploidy}
    lines = {}
    for dev in ("cuda", "cpu"):
        cfg = Config(bam=bam_p, ref=fa, device=dev)
        state = IndelCallerState.create("ONT-HG002", device=dev)
        K.reset_counters()
        lines[dev] = call_indel_chunk(state, BamReader(bam_p), FastaFile(fa),
                                      chunk, cfg)
        if dev == "cuda":
            assert min(K.NW_TB_LAUNCHES, K.NW_WALK_LAUNCHES,
                       K.NW_CIGAR_LAUNCHES) >= 1
    assert len(lines["cuda"]) >= 3
    chip_smoke.compare_lines(lines["cuda"], lines["cpu"], "indel",
                             "call_indel_chunk")
