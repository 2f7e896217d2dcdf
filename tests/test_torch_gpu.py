"""The CUDA kernels against their plain twins on the card, exactly.
K1 (nw_tb) and K2 (nw_walk): at the main path's buckets, at the edges of
K1's 32-lane column strips, with a batch that leaves the last CTA part
empty, with pad codes, and on tie-heavy pairs. K3 (snp_pileup), on its
three outputs: normal, deep and haploid cohorts of a simulated group,
random payloads (holes, dense exceptions, reads out of start order, a
read over every site, every band schedule, clamped windows), one row,
rows without neighbours, at the first and last site, deep rows with no
valid id, windows longer than the kernel's list, and the wrapper's
refusals; a SNP decode group over the payload caps, sent member by member
(one K3 launch a member), against its uncapped run; `--mode all --cpu 2`
on cuda against cpu, with no CUDA context in a worker. Skips without a
GPU.

Imports neither jax nor the JAX package, so that it also runs where only
the port is installed: `python -m pytest --noconftest tests/test_torch_gpu.py`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.align.batch_nw import BatchAligner, encode_pairs
from nanocaller_tpu_torch.align.nw import nw_align
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile, write_fasta
from nanocaller_tpu_torch.pileup import snp_pileup as K3
from nanocaller_tpu_torch.pileup.snp_features import (BAND_SCHEDULES,
                                                      get_snp_group_payloads)
from nanocaller_tpu_torch.sim import (BASES, TIE_KINDS, make_diploid_readset,
                                      random_group_wire, random_seq,
                                      tie_heavy_pairs, write_bam)
from nanocaller_tpu_torch.snp_caller import SnpCallerState, pileup_cohorts

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
    launches = [a for p, d, a, _, _ in pileup_cohorts(state, gf, _Cfg())
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
