"""The port's phasing modules (nanocaller_tpu_torch/phase/) and the
phasing hooks of its decode and indel features against the JAX package,
on the same seeded inputs: read selection, components, the exact wMEC
trellis (against the JAX package's Python DP and its native one), the
per-block refinement, phase_obs, phase_contig with and without
distrust, haplotag_reads, write_phased_vcf, decode_reads(sites=) and
get_indel_candidates(tags=) on an untagged BAM. Everything must be
equal: arrays, dicts and VCF bytes."""

import gzip
import os

import numpy as np
import pytest

import nanocaller_tpu.io.native as j_native
from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.io.vcf import VcfRecord as JVcfRecord
from nanocaller_tpu.phase import mec as JM
from nanocaller_tpu.phase import wmec as JW
from nanocaller_tpu.pileup.engine import decode_reads as j_decode_reads
from nanocaller_tpu.pileup.indel_features import \
    get_indel_candidates as j_get_indel_candidates
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.io.vcf import VcfRecord
from nanocaller_tpu_torch.phase import mec as PM
from nanocaller_tpu_torch.phase import wmec as PW
from nanocaller_tpu_torch.pileup.engine import (decode_reads,
                                                decode_reads_parallel)
from nanocaller_tpu_torch.pileup.indel_features import get_indel_candidates
from nanocaller_tpu_torch.sim import write_all_fixture

from test_wmec_prod import gen_block
from torch_jax_native import jax_native_lib
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 12000
CONTIG = "chr_t"
RW_FIELDS = ("flags", "strand", "read_start", "read_end", "hp", "ps",
             "ev_rid", "ev_pos", "ev_code", "ev_qpos", "del_rid",
             "del_start", "del_len", "ins_rid", "ins_pos", "ins_len")


def _block(seed, depth=8, n_sites=None):
    rng = np.random.default_rng(seed)
    n = n_sites or int(rng.integers(8, 40))
    rids, sidx, al, n_reads, _ = gen_block(rng, n, depth, 0.1, 3, 9)
    return rng, rids, sidx, al, n_reads, n


@pytest.mark.parametrize("seed", range(4))
def test_select_reads_equal(seed):
    _, rids, sidx, _, n_reads, _ = _block(seed, depth=24)
    for cap in (4, 10, 15):
        want = JW.select_reads(rids, sidx, n_reads, max_cov=cap)
        np.testing.assert_array_equal(
            PW.select_reads(rids, sidx, n_reads, max_cov=cap), want)


@pytest.mark.parametrize("seed", range(4))
def test_select_reads_connectivity_equal(seed):
    _, rids, sidx, _, n_reads, _ = _block(seed, depth=24)
    for cap in (4, 10, 15):
        want = JW.select_reads_connectivity(rids, sidx, n_reads, max_cov=cap)
        got = PW.select_reads_connectivity(rids, sidx, n_reads, max_cov=cap)
        np.testing.assert_array_equal(got, want)
        assert got.any()


@pytest.mark.parametrize("seed", range(3))
def test_components_equal(seed):
    rng, rids, sidx, _, _, n = _block(seed)
    # drop a stretch of observations so that the block splits
    keep = (sidx < n // 3) | (sidx > n // 3 + 2)
    np.testing.assert_array_equal(
        PW.components(rids[keep], sidx[keep], n),
        JW.components(rids[keep], sidx[keep], n))


@pytest.mark.parametrize("seed", range(6))
def test_wmec_exact_gt_equal(seed):
    rng, rids, sidx, al, _, n = _block(seed)
    g_in = rng.choice([1, 1, 2], n).astype(np.int8)
    gq = float(rng.choice([0.5, 3.0, 1e30]))
    got = PW.wmec_exact_gt(rids, sidx, al, n, g_in, gq)
    for native in (False, True):
        want = JW.wmec_exact_gt(rids, sidx, al, n, g_in, gq, native=native)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]


@pytest.mark.parametrize("seed", range(3))
def test_exact_refine_and_phase_obs_equal(seed):
    rng, rids, sidx, al, n_reads, n = _block(seed, depth=20, n_sites=60)
    comp = JW.components(rids, sidx, n)
    h = rng.integers(0, 2, n).astype(np.int8)
    np.testing.assert_array_equal(
        PW.exact_refine(rids, sidx, al, n, comp, h),
        JW.exact_refine(rids, sidx, al, n, comp, h))
    pos = np.arange(n, dtype=np.int64) * 150 + 40
    want = JM.phase_obs(rids, sidx, al, n_reads, pos)
    got = PM.phase_obs(rids, sidx, al, n_reads, pos)
    for k in ("site_pos", "hap_allele", "block_ps", "read_hp", "read_ps"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.n_blocks, got.mec_cost) == (want.n_blocks, want.mec_cost)
    assert got.n_blocks >= 1


def test_jax_native_lib_survives_a_cached_build_error(monkeypatch):
    """A worker that lost the collection-time build race: no library and
    a cached FileNotFoundError. The helper still loads the library."""
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_build_error", FileNotFoundError(
        2, "No such file or directory", "libncio.so.tmp"))
    assert j_native.get_lib() is None
    assert jax_native_lib(monkeypatch) is not None
    assert JW._block_cap(300_000, 15, 600_000_000) == 14


@pytest.mark.parametrize("n_sites,cap", [(18_310, 15), (18_311, 15),
                                          (36_621, 15), (300_000, 14)])
def test_block_cap_is_the_python_trellis_bound(n_sites, cap,
                                               monkeypatch):
    """The port caps a block as the JAX package does with its native
    library loaded: 16x the cell budget (the checkpointed trellis), so
    cap 15 holds up to 16 * 600,000,000 / 2**15 = 292,968 sites. Below
    18,311 sites both packages agreed before the port had the library
    (ROADMAP §C)."""
    from nanocaller_tpu_torch.io import native as p_native

    assert jax_native_lib(monkeypatch) is not None and \
        p_native.get_lib() is not None
    budget = 600_000_000
    assert PW._block_cap(n_sites, 15, budget) == \
        JW._block_cap(n_sites, 15, budget) == cap


@pytest.mark.parametrize("seed", range(2))
def test_exact_refine_past_the_python_trellis_bound(seed, monkeypatch):
    """exact_refine on a 100-site block with the cell budget lowered to
    300,000: 1x the budget would cap the block at 11 active reads, the
    native trellis's 16x keeps 15 (and runs the block in checkpoint mode
    only past its own 64,000,000-cell floor). Port and JAX package (both
    with their libraries) agree on the refined haplotype."""
    assert jax_native_lib(monkeypatch) is not None
    rng, rids, sidx, al, _n_reads, n = _block(100 + seed, depth=20,
                                              n_sites=100)
    comp = JW.components(rids, sidx, n)
    assert np.bincount(comp).max() >= 90
    assert PW._block_cap(100, 15, 300_000) == 15
    h = rng.integers(0, 2, n).astype(np.int8)
    got = PW.exact_refine(rids, sidx, al, n, comp, h, cell_budget=300_000)
    np.testing.assert_array_equal(
        got, JW.exact_refine(rids, sidx, al, n, comp, h,
                             cell_budget=300_000))
    assert (got != h).any()


@pytest.fixture(scope="module")
def phase_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_phase")
    fasta_p, bam_p, snps, indels, _ = write_all_fixture(
        str(tmp), L, seed=31, snp_every=300, indel_every=3000, depth=24,
        read_len=2500)
    ref = JFastaFile(fasta_p).fetch(CONTIG, 0, L)
    lines = []
    for k, (p, alt, gt) in enumerate(snps):
        # every seventh planted het typed hom and every fifth hom typed
        # het, for the distrust pass to re-type
        called = "1/1" if gt == "hom" else "0/1"
        if gt != "hom" and k % 7 == 0:
            called = "1/1"
        elif gt == "hom" and k % 5 == 0:
            called = "0/1"
        lines.append("%s\t%d\t.\t%s\t%s\t%.3f\tPASS\t.\tGT:DP\t%s:24\n"
                     % (CONTIG, p + 1, ref[p], alt, 20 + k % 9, called))
    header = ["##fileformat=VCFv4.2",
              "##contig=<ID=%s,length=%d>" % (CONTIG, L),
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    return str(tmp), fasta_p, bam_p, lines, header


def _windows(phase_fixture):
    _tmp, _fa, bam_p, lines, _h = phase_fixture
    sites = sorted(int(l.split("\t")[1]) - 1 for l in lines)
    want = j_decode_reads(JBamReader(bam_p), CONTIG, 0, L, sites=sites)
    got = decode_reads(BamReader(bam_p), CONTIG, 0, L, sites=sites)
    return want, got, sites


def test_decode_reads_sites_equal(phase_fixture):
    want, got, sites = _windows(phase_fixture)
    oracle = j_decode_reads(JBamReader(phase_fixture[2]), CONTIG, 0, L,
                            sites=sites, use_native=False)
    again = decode_reads_parallel(BamReader(phase_fixture[2]), CONTIG, 0, L,
                                  sites=sites)
    for w in (want, oracle, again):
        assert got.qnames == w.qnames
        for k in RW_FIELDS:
            np.testing.assert_array_equal(getattr(got, k), getattr(w, k),
                                          err_msg=k)
    assert set(np.unique(got.ev_pos).tolist()) <= set(sites)
    assert len(got.ev_pos) > 20 * len(sites)


class _Recs:
    def __init__(self, header, recs):
        self.header_lines = header
        self.recs = recs

    def __iter__(self):
        return iter(self.recs)


@pytest.mark.parametrize("distrust", [False, True])
def test_phase_contig_haplotags_and_vcf_equal(phase_fixture, distrust):
    tmp, _fa, _bam, lines, header = phase_fixture
    want_rw, got_rw, _ = _windows(phase_fixture)
    jrecs = [JVcfRecord.parse(l) for l in lines]
    precs = [VcfRecord.parse(l) for l in lines]
    want, want_map = JM.phase_contig(jrecs, want_rw, distrust=distrust,
                                     cell_budget=600_000_000)
    got, got_map = PM.phase_contig(precs, got_rw, distrust=distrust,
                                   cell_budget=600_000_000)
    for k in ("site_pos", "hap_allele", "block_ps", "read_hp", "read_ps"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.n_blocks, got.mec_cost) == (want.n_blocks, want.mec_cost)
    assert got_map == want_map and len(got_map) > 10
    # distrust re-types some of the mistyped sites (bare GT strings)
    assert any(isinstance(e, str) for e in got_map.values()) == distrust
    tags = PM.haplotag_reads(got_rw, got)
    assert tags == JM.haplotag_reads(want_rw, want) and len(tags) > 10
    paths = [os.path.join(tmp, "%s_%d.vcf.gz" % (side, distrust))
             for side in ("jax", "port")]
    JM.write_phased_vcf(_Recs(header, jrecs), paths[0], want_map)
    PM.write_phased_vcf(_Recs(header, precs), paths[1], got_map)
    with gzip.open(paths[0]) as a, gzip.open(paths[1]) as b:
        data = b.read()
        assert data == a.read() and data.count(b"|") > 10


def test_indel_candidates_take_tags(phase_fixture):
    """Tags injected in memory on an untagged BAM give the JAX function's
    IndelBatch on the same tags, and differ from no tags at all."""
    _tmp, fasta_p, bam_p, lines, _h = phase_fixture
    want_rw, got_rw, _ = _windows(phase_fixture)
    result, _ = PM.phase_contig([VcfRecord.parse(l) for l in lines], got_rw)
    tags = PM.haplotag_reads(got_rw, result)
    kw = dict(seq_type="ont", mincov=4, maxcov=160, ins_t=0.4, del_t=0.6,
              win_size=40, small_win_size=4)
    chunk = {"chrom": CONTIG, "start": 1, "end": L}
    want = j_get_indel_candidates(JBamReader(bam_p), JFastaFile(fasta_p),
                                  chunk, tags=tags, **kw)
    got = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p), chunk,
                               tags=tags, device="cpu", **kw)
    untagged = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p),
                                    chunk, device="cpu", **kw)
    assert len(want) >= 3 and got.pos == want.pos
    for k in ("x0", "x1", "x2"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.alleles == want.alleles and got.phase == want.phase
    assert any(p is not None for p in got.phase)
    assert all(p is None for p in untagged.phase)
