"""The port's SNP group path against the JAX package on a small fixture:
the group payload and the neighbour selection (exact), K3's plain twin
`snp_pileup_reference` against the JAX package: its column sites against
_device_select_neighbors_clamped and its tensor against what
_rid_matrix + _group_cell_codes + the _snp_forward_dense assembly give
(both exact), its read windows against brute force, and
infer_snp_group's probabilities (atol 2e-5); a decode group over the
payload caps, sent member by member, against the JAX package's
per-member fallback (the SNP VCF bytes)."""

import copy
import dataclasses
import gzip
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanocaller_tpu import snp_caller as J
from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.pileup.snp_features import SnpBatch
from nanocaller_tpu.pileup.snp_features import \
    SnpGroupFeatures as JSnpGroupFeatures
from nanocaller_tpu.pileup.snp_features import assemble_matrices_np
from nanocaller_tpu.pileup.snp_features import \
    get_snp_group_payload as j_get_snp_group_payload
from nanocaller_tpu_torch import snp_caller as P
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.pileup import snp_pileup as K3
from nanocaller_tpu_torch.pileup.engine import decode_reads
from nanocaller_tpu_torch.pileup.snp_features import (
    BAND_SCHEDULES, CENTER, WIDTH, get_snp_chunk_features,
    get_snp_group_payloads)
from nanocaller_tpu_torch.runtime.metrics import total
from nanocaller_tpu_torch.sim import random_group_wire

from fixtures import BASES, make_fixture, random_seq
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 100_000
# four members of 25 kb; the second carries no planted SNP and no
# candidate. A member's scan window reaches 50 kb beyond its edges, so
# the first member's window ends at 75 kb while the group's neighbour
# list runs on to 100 kb: ul_ont bands (±100 kb) meet the clamps.
MEMBERS = [{"chrom": "chr_t", "start": 1 + i * 25000,
            "end": (i + 1) * 25000, "ploidy": "diploid"} for i in range(4)]
EMPTY = [False, True, False, False]
WIRE_FIELDS = ("read_lo", "read_hi", "site_ref", "site_major", "site_minor",
               "minor_bits", "exc_site", "exc_rid", "exc_code", "hole_site",
               "hole_rid", "nbr_pos", "nbr_union")
# (seq_type, maxcov): ONT with every row normal; ul_ont (bands reaching
# ±100 kb, beyond each member's window) with maxcov below the depth, so
# that members carry deep rows
PAYLOADS = [("ont", 160), ("ul_ont", 24)]
# (seq_type, maxcov, ploidy) of the payloads built on both sides
BUILDS = [("ont", 160, "diploid"), ("ont", 160, "haploid"),
          ("ul_ont", 24, "diploid")]


class Cfg:
    batch_size = 128
    disable_coverage_normalization = False


@pytest.fixture(scope="module")
def snp_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_snp")
    ref = random_seq(np.random.default_rng(13), L)  # make_fixture's ref
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate([*range(700, 24000, 650),
                                   *range(50700, 99400, 650)])]
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=13, L=L, depth=30,
                                        read_len=2000, snps=snps,
                                        error_rate=0.01)
    return fasta_p, bam_p


def _remap(gf):
    gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
    return gf


@pytest.fixture(scope="module")
def payloads(snp_fixture):
    fasta_p, bam_p = snp_fixture
    out = {}
    for seq_type, maxcov, ploidy in BUILDS:
        mem = [dict(m, ploidy=ploidy) for m in MEMBERS]
        want = j_get_snp_group_payload(
            JBamReader(bam_p), JFastaFile(fasta_p), mem, seq_type=seq_type,
            maxcov=maxcov)
        [got] = get_snp_group_payloads(
            BamReader(bam_p), FastaFile(fasta_p), mem, seq_type=seq_type,
            maxcov=maxcov)
        out[seq_type, maxcov, ploidy] = (_remap(want), _remap(got))
    return out


@pytest.mark.parametrize("seq_type,maxcov", PAYLOADS)
def test_group_payload_identical(payloads, seq_type, maxcov):
    want, got = payloads[seq_type, maxcov, "diploid"]
    assert isinstance(want, JSnpGroupFeatures)
    for k in WIRE_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert (got.n_reads, got.maxcov, got.seq_type) == \
        (want.n_reads, want.maxcov, want.seq_type)
    assert [s is None for _, s in got.members] == EMPTY
    deep = 0
    for (_, a), (_, b) in zip(want.members, got.members):
        if a is None:
            assert b is None
            continue
        for k in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=k)
        deep += len(a.deep_idx)
    assert (deep > 0) == (maxcov == 24)
    assert len(got) == sum(len(s) for _, s in want.members if s)


def _rows(gf, deep=False):
    """The group's candidate rows (every row, or the deep ones with their
    read ids): (cand_site, cand_pos, lo, hi[, deep_rids])."""
    secs = [s for _, s in gf.members if s is not None]
    pick = [s.deep_idx if deep else np.arange(len(s)) for s in secs]
    cat = lambda f: np.concatenate([f(s, p) for s, p in zip(secs, pick)])
    rows = tuple(cat(f).astype(np.int32) for f in (
        lambda s, p: s.cand_site[p], lambda s, p: s.cand_pos32[p],
        lambda s, p: np.full(len(p), s.nbr_lo),
        lambda s, p: np.full(len(p), s.nbr_hi)))
    return rows + (cat(lambda s, p: s.deep_rids),) if deep else rows


_select_clamped_jit = jax.jit(J._device_select_neighbors_clamped,
                              static_argnums=(4,))
_select_jit = jax.jit(J._device_select_neighbors, static_argnums=(4,))


def _jax_soc(gf, rows):
    return np.asarray(_select_clamped_jit(
        *(jnp.asarray(a) for a in rows[:2]), jnp.asarray(gf.nbr_pos),
        jnp.asarray(gf.nbr_union), gf.seq_type,
        *(jnp.asarray(a) for a in rows[2:])))


@pytest.mark.parametrize("seq_type,maxcov", PAYLOADS)
def test_select_neighbors_identical(payloads, seq_type, maxcov):
    _, gf = payloads[seq_type, maxcov, "diploid"]
    rows = _rows(gf)
    want = _jax_soc(gf, rows)
    t = lambda a: torch.from_numpy(a)
    got = K3.select_neighbors_clamped(
        t(rows[0]), t(rows[1]), t(gf.nbr_pos), t(gf.nbr_union),
        K3.band_table(gf.seq_type), t(rows[2]), t(rows[3]))
    assert got.dtype == torch.int32 and got.shape == (len(rows[0]), WIDTH)
    np.testing.assert_array_equal(got.numpy(), want)
    # ul_ont: the clamps bite, some rows lose neighbours beyond their
    # member's window (ONT's ±50 kb bands never leave it)
    unclamped = np.asarray(_select_jit(
        jnp.asarray(rows[0]), jnp.asarray(rows[1]), jnp.asarray(gf.nbr_pos),
        jnp.asarray(gf.nbr_union), gf.seq_type))
    assert (unclamped != want).any() == (seq_type == "ul_ont")


@pytest.mark.parametrize("seq_type", sorted(BAND_SCHEDULES))
def test_band_table_packs_the_schedule(seq_type):
    table = K3.band_table(seq_type)
    assert table.dtype == np.int32 and table.shape == (2, K3.MAX_BANDS, 4)
    for side, rows in zip(("left", "right"), table):
        sched = BAND_SCHEDULES[seq_type][side]
        want = [(lo, hi, k, take == "last") for lo, hi, k, take in sched]
        assert [tuple(r) for r in rows[:len(sched)]] == want
        assert not rows[len(sched):].any()
        assert rows[:, 2].sum() == 20


def _jax_covering(rl, rh, hole_indptr, hole_rid, cand_site, S, R):
    """_group_body's covering-read list: the interval and hole test of
    every read at the centre site, then _rid_matrix."""
    N = rl.shape[0]
    s_c = jnp.clip(cand_site, 0, S)
    iv = (rl[None, :] <= s_c[:, None]) & (s_c[:, None] <= rh[None, :])
    if hole_rid.shape[0]:
        qn = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :],
                              iv.shape)
        lo = hole_indptr[s_c][:, None]
        hi = hole_indptr[s_c + 1][:, None]
        pos = J._lower_bound_rows(hole_rid, lo, hi, qn, int(N).bit_length(),
                                  hole_rid.shape[0])
        iv = iv & ~((pos < jnp.broadcast_to(hi, iv.shape))
                    & (hole_rid[jnp.clip(pos, 0, hole_rid.shape[0] - 1)]
                       == qn))
    rid, depth = J._rid_matrix(iv, R)
    return rid, jnp.arange(R)[None, :] < jnp.minimum(depth, R)[:, None]


# one compiled program per shape (op-by-op dispatch recompiles every
# primitive for each new shape)
_jax_covering_jit = jax.jit(_jax_covering, static_argnums=(5, 6))
_group_cell_codes_jit = jax.jit(J._group_cell_codes,
                                static_argnums=(12, 13))


def _jax_pileup(w, cand_site, soc, norm, deep_rids=None, R=None):
    """The JAX package's tensor: _group_body's covering-read list (or the
    deep rows' explicit ids), _group_cell_codes, then the
    _snp_forward_dense assembly (assemble_matrices_np) and the coverage
    scale. w: the host wire arrays under SnpGroupFeatures' names."""
    S, N = len(w.site_ref), len(w.read_lo)
    ar = np.arange(S + 2, dtype=np.int32)
    ext = lambda a: jnp.asarray(np.concatenate([a, [np.int8(4)]]))
    rl, rh = jnp.asarray(w.read_lo), jnp.asarray(w.read_hi)
    exc_indptr = jnp.asarray(np.searchsorted(w.exc_site, ar)
                             .astype(np.int32))
    hole_indptr = jnp.asarray(np.searchsorted(w.hole_site, ar)
                              .astype(np.int32))
    hole_rid = jnp.asarray(w.hole_rid)
    if deep_rids is None:
        rid, read_mask = _jax_covering_jit(rl, rh, hole_indptr, hole_rid,
                                           jnp.asarray(cand_site), S, R)
        read_mask = np.asarray(read_mask)
    else:
        rid = jnp.asarray(deep_rids)
        read_mask = np.ones(deep_rids.shape, bool)
    site_sel = jnp.where(jnp.asarray(soc) >= 0, jnp.asarray(soc), S)
    codes = np.asarray(_group_cell_codes_jit(
        rl, rh, jnp.asarray(w.minor_bits), ext(w.site_major),
        ext(w.site_minor), exc_indptr, jnp.asarray(w.exc_rid),
        jnp.asarray(w.exc_code), hole_indptr, hole_rid, site_sel, rid, S,
        int(N).bit_length()))
    col_valid = soc >= 0
    col_ref = np.where(col_valid, w.site_ref[np.clip(soc, 0, S - 1)],
                       4).astype(np.int8)
    B = len(cand_site)
    z = np.zeros(B, np.int32)
    batch = SnpBatch(contig="c", pos=z, codes=codes, read_mask=read_mask,
                     col_ref=col_ref, col_valid=col_valid,
                     center_ref=w.site_ref[cand_site], dp=z,
                     freq=z.astype(np.float32), fwd_dp=z, rev_dp=z,
                     sampled_depth=z, nbr_counts=z)
    x = assemble_matrices_np(batch)
    x[:, 1:, :, :4] *= norm[:, None, None, None]
    return x


def _port_pileup(w, rows, norm, deep_rids=None):
    """K3's wrapper on the CPU (its twin) → (x, soc, ref) as numpy."""
    wire = K3.group_wire(w, "cpu")
    n_valid = None
    if deep_rids is not None:
        deep_rids = torch.from_numpy(deep_rids)
        n_valid = torch.full((len(rows[0]),), deep_rids.shape[1],
                             dtype=torch.int32)
    out = K3.snp_pileup(wire, *(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (*rows, norm)),
                        deep_rids, n_valid)
    return tuple(o.numpy() for o in out)


def _check_against_jax(w, rows, norm, deep_rids=None, R=None):
    """The twin's soc against _device_select_neighbors_clamped and its x
    against the JAX package's tensor on that selection, both exactly;
    ref is the centre-ref one-hot."""
    x, soc, ref = _port_pileup(w, rows, norm, deep_rids)
    want_soc = _jax_soc(w, rows)
    np.testing.assert_array_equal(soc, want_soc)
    want = _jax_pileup(w, rows[0], want_soc, norm, deep_rids, R=R)
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(
        ref, np.eye(5, dtype=np.float32)[w.site_ref[rows[0]]][:, :4])
    return x, soc


@pytest.mark.parametrize("rows", ["normal", "deep", "random"])
def test_pileup_reference_matches_jax(payloads, rows):
    if rows == "random":
        # random payloads in the manner of tests/test_snp_group_payload.py
        # (TestCellCodeOracle): empty spans, holes, dense exceptions,
        # with or without a minor bitmask; reads out of start order, one
        # read over every site, every band schedule, clamped windows
        rng = np.random.default_rng(0)
        kinds = sorted(BAND_SCHEDULES)
        for trial in range(6):
            w, *sel, norm = random_group_wire(
                rng, S=int(rng.integers(3, 40)), N=int(rng.integers(2, 60)),
                B=int(rng.integers(1, 12)), bitmask=rng.random() < 0.8,
                seq_type=kinds[trial % len(kinds)], span_all=trial % 2 == 1,
                nbr_share=0.9)
            assert len(w.nbr_pos), "trial %d" % trial
            _check_against_jax(w, sel, norm, R=len(w.read_lo))
        return
    maxcov = 160 if rows == "normal" else 24
    seq_type = "ont" if rows == "normal" else "ul_ont"
    _, gf = payloads[seq_type, maxcov, "diploid"]
    sel = _rows(gf, deep=rows == "deep")
    norm = np.random.default_rng(5).uniform(0.3, 3.0, len(sel[0])) \
        .astype(np.float32)
    deep = sel[4] if rows == "deep" else None
    x, soc = _check_against_jax(gf, sel[:4], norm, deep, R=maxcov)
    assert x.shape == (len(sel[0]), 5, WIDTH, 5) and len(sel[0]) > 20
    assert np.abs(x[:, 1:]).sum() > 0 and (soc >= 0).sum() > 20 * len(soc)


def test_pileup_reference_without_neighbours():
    """A payload with no neighbour site: only the centre column is valid,
    and x equals the JAX package's tensor on that selection."""
    rng = np.random.default_rng(3)
    w, *sel, norm = random_group_wire(rng, S=30, N=50, B=7, nbr_share=0)
    assert len(w.nbr_pos) == 0
    x, soc, _ = _port_pileup(w, sel, norm)
    want_soc = np.full((7, WIDTH), -1, np.int32)
    want_soc[:, CENTER] = sel[0]
    np.testing.assert_array_equal(soc, want_soc)
    np.testing.assert_array_equal(
        x, _jax_pileup(w, sel[0], want_soc, norm, R=len(w.read_lo)))


@pytest.mark.parametrize("span_all", [False, True])
def test_read_windows_hold_every_covering_read(span_all):
    """read_windows against brute force: every read covering s (by its
    interval) lies in [k0, k1) of the read order, on reads out of start
    order, with empty reads, with or without one read over every site;
    k1 counts the reads starting at or before s; and group_wire ships
    the same arrays."""
    rng = np.random.default_rng(17 + span_all)
    w, *_ = random_group_wire(rng, S=60, N=300, B=1, max_span=8,
                              span_all=span_all)
    lo, hi = w.read_lo, w.read_hi
    assert (np.diff(lo) < 0).any() and (lo > hi).any()
    S = len(w.site_ref)
    order, k0, k1 = K3.read_windows(lo, hi, S)
    assert order.dtype == k0.dtype == k1.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(len(lo)))
    assert (np.diff(lo[order]) >= 0).all()
    for s in range(S + 1):
        covering = np.flatnonzero((lo <= s) & (s <= hi))
        assert set(covering) <= set(order[k0[s]:k1[s]]), s
        assert k1[s] == (lo <= s).sum()
    assert k0[S] >= k1[S]  # the trash site: no read
    if span_all:  # the read over every site opens every window early
        assert (k0[:-1] <= (lo == 0).sum()).all()
    else:
        assert (k1 - k0).max() < len(lo) // 2
    wire = K3.group_wire(w, "cpu")
    for got, want in zip((wire.order, wire.win_lo, wire.win_hi),
                         (order, k0, k1)):
        np.testing.assert_array_equal(got.numpy(), want)


def _searched_layout(read_lo, read_hi, S, exc_site, hole_site):
    """The oracle of the wire's site-indexed arrays: each by one binary
    search a site, over S + 1 sites (order, win_lo, win_hi) and S + 2 rows
    (exc_indptr, hole_indptr)."""
    lo = np.asarray(read_lo, np.int32)
    order = np.argsort(lo, kind="stable").astype(np.int32)
    hi_max = np.maximum.accumulate(np.asarray(read_hi, np.int32)[order]) \
        if len(order) else np.zeros(0, np.int32)
    sites = np.arange(S + 1, dtype=np.int32)
    rows = np.arange(S + 2, dtype=np.int32)
    i32 = lambda a: a.astype(np.int32)
    return {"order": order,
            "win_lo": i32(np.searchsorted(hi_max, sites, side="left")),
            "win_hi": i32(np.searchsorted(lo[order], sites, side="right")),
            "exc_indptr": i32(np.searchsorted(exc_site, rows)),
            "hole_indptr": i32(np.searchsorted(hole_site, rows))}


def _payload(S, read_lo, read_hi, exc_site, hole_site):
    """A group payload around the given keys (the other fields zero)."""
    i32 = lambda a: np.asarray(a, np.int32)
    zeros = lambda n, t=np.int32: np.zeros(n, t)
    return SimpleNamespace(
        read_lo=i32(read_lo), read_hi=i32(read_hi), site_ref=zeros(S, np.int8),
        site_major=zeros(S, np.int8), site_minor=zeros(S, np.int8),
        minor_bits=zeros(0, np.uint8), exc_site=i32(exc_site),
        exc_rid=zeros(len(exc_site)), exc_code=zeros(len(exc_site), np.int8),
        hole_site=i32(hole_site), hole_rid=zeros(len(hole_site)),
        nbr_pos=zeros(0), nbr_union=zeros(0), seq_type="ont")


def _cell_payload(rng):
    """One decode group of the benchmark's ont_snp_stream traffic, cut to
    one member with short halos (S = 2,001 sites, N = 864 reads): its
    depth, read length and exception share as the cell has them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "gen_snp", os.path.join(root, "benchmark", "nbench", "gen_snp.py"))
    gen_snp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_snp)
    with open(os.path.join(root, "benchmark", "traffic",
                           "ont_snp_stream.json")) as f:
        traffic = json.load(f)
    traffic.update(members_per_group=1, member_bp=300_000, halo_bp=20_000)
    group = gen_snp.make_group(rng, traffic, 160, "ont")
    return SimpleNamespace(**{k: v for k, v in group.items()
                              if k != "members"})


def _layout_case(case):
    rng = np.random.default_rng(41 + LAYOUT_CASES.index(case))
    if case == "cell":
        return _cell_payload(rng)
    if case == "tiny":  # N = 0, S = 1, E = 0, H = 0
        return _payload(1, [], [], [], [])
    if case in ("unsorted", "span_all"):
        w, *_ = random_group_wire(rng, S=60, N=300, B=1, max_span=8,
                                  span_all=case == "span_all")
        return w
    if case == "empty_reads":  # every read empty but one, which spans all
        lo, hi = np.ones(40, np.int32), np.zeros(40, np.int32)
        lo[7], hi[7] = 0, 29
        return _payload(30, lo, hi, [3, 3, 17], [5, 29])
    S = 20
    if case == "edges":  # keys at 0 and at S, the trash site
        return _payload(S, [S, 0, 5, 0, S], [S, 4, S, S - 1, S - 1],
                        [0, 0, 7, S, S], [0, S])
    # "outside": keys below 0 and past the last row
    return _payload(S, [-3, 30, 2, -1, 2**31 - 1], [5, 40, -9, 2**31 - 1, 1],
                    [-4, -1, 0, S + 1, S + 2, 2**31 - 1], [-2**31, S + 9])


LAYOUT_CASES = ["unsorted", "empty_reads", "span_all", "edges", "outside",
                "tiny", "cell"]


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_wire_counts_equal_binary_search(case):
    """group_wire's order, read windows and CSR row pointers, now prefix
    counts over the site axis, equal a binary search a site bit for bit
    and dtype for dtype: on reads out of start order, empty reads, one
    read over every site, keys at 0 and at the trash site S, keys outside
    [0, S], no read and no exception, and a payload at the benchmark
    cell's statistics."""
    w = _layout_case(case)
    S = len(w.site_ref)
    if case == "unsorted":
        assert (np.diff(w.read_lo) < 0).any() and (w.read_lo > w.read_hi).any()
    if case == "cell":
        assert S == 2001 and len(w.read_lo) == 864 and len(w.exc_site) > 5000
    want = _searched_layout(w.read_lo, w.read_hi, S, w.exc_site, w.hole_site)
    wire = K3.group_wire(w, "cpu")
    for name, a in want.items():
        got = getattr(wire, name).numpy()
        assert got.dtype == a.dtype == np.int32, name
        np.testing.assert_array_equal(got, a, err_msg=name)
    for got, a in zip(K3.read_windows(w.read_lo, w.read_hi, S),
                      (want["order"], want["win_lo"], want["win_hi"])):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("source", ["fixture", "random"])
def test_chunk_wire_keeps_its_csr(snp_fixture, source):
    """chunk_wire ships the chunk's own exc_indptr with the trash row's
    pointer appended, splits exc_packed into exc_rid and exc_code, and
    lays out the read windows and hole_indptr as the binary-search oracle
    does."""
    if source == "fixture":
        fasta_p, bam_p = snp_fixture
        feats = get_snp_chunk_features(
            BamReader(bam_p), FastaFile(fasta_p),
            {"chrom": "chr_t", "start": 1, "end": 50_000,
             "ploidy": "diploid"}, seq_type="ont", maxcov=160)
    else:
        w, *_ = random_group_wire(np.random.default_rng(23), S=50, N=200,
                                  B=1, max_span=10)
        feats = SimpleNamespace(**vars(w))
        feats.exc_packed = (w.exc_rid.astype(np.uint32) << 3) | w.exc_code
        feats.exc_indptr = np.searchsorted(
            w.exc_site, np.arange(len(w.site_ref) + 1)).astype(np.int32)
    S = len(feats.site_ref)
    assert len(feats.exc_indptr) == S + 1 and feats.exc_indptr[-1] > 0
    wire = K3.chunk_wire(feats, "cpu")
    assert wire.kind == "chunk"
    np.testing.assert_array_equal(
        wire.exc_indptr.numpy(),
        np.append(feats.exc_indptr, feats.exc_indptr[-1]).astype(np.int32))
    packed = np.asarray(feats.exc_packed, np.int64)
    np.testing.assert_array_equal(wire.exc_rid.numpy(), packed >> 3)
    np.testing.assert_array_equal(wire.exc_code.numpy(), packed & 7)
    want = _searched_layout(feats.read_lo, feats.read_hi, S,
                            np.zeros(0, np.int32), feats.hole_site)
    for name in ("order", "win_lo", "win_hi", "hole_indptr"):
        got = getattr(wire, name).numpy()
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)


@pytest.fixture(scope="module")
def states():
    return (J.SnpCallerState.create("ONT-HG002", mesh=None),
            P.SnpCallerState.create("ONT-HG002", device="cpu"))


@pytest.mark.parametrize("case", ["diploid", "haploid", "deep"])
def test_infer_snp_group_probabilities(payloads, states, case):
    key = {"diploid": ("ont", 160, "diploid"),
           "haploid": ("ont", 160, "haploid"),
           "deep": ("ul_ont", 24, "diploid")}[case]
    want_gf, got_gf = payloads[key]
    jstate, pstate = states
    cfgs = [Cfg()]
    if case == "diploid":
        per_row = Cfg()
        per_row.disable_coverage_normalization = True
        cfgs.append(per_row)
    for cfg in cfgs:
        want = J.infer_snp_group(jstate, want_gf, cfg)
        got = P.infer_snp_group(pstate, got_gf, cfg)
        assert [len(g) for g in got] == [len(w) for w in want]
        assert sum(len(g) for g in got) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-5)
        for g, w in zip(got, _member_scatter(pstate, got_gf, cfg)):
            assert g.shape == w.shape and np.array_equal(g, w)
    # the members the cases cover: a None one, and for "deep" two cohorts
    assert [s is None for _, s in got_gf.members] == EMPTY
    n_cohorts = len({(p, d) for p, d, *_ in P.pileup_cohorts(
        pstate, got_gf, Cfg())})
    assert n_cohorts == (2 if case == "deep" else 1)


def _member_scatter(state, gf, cfg):
    """infer_snp_group's per-member arrays built launch by launch, each
    launch's rows scattered member by member into an array of its own."""
    outs = [np.zeros((len(sec) if sec is not None else 0, 4), np.float32)
            for _oi, sec in gf.members]
    with torch.inference_mode():
        for ploidy, _deep, args, mis, js, r in P.pileup_cohorts(state, gf,
                                                                 cfg):
            x, _soc, ref = K3.snp_pileup(*args)
            probs = P._snp_cnn(state.replicas[r], ploidy, x, ref,
                               cfg.batch_size).numpy()
            for mi in np.unique(mis):
                outs[mi][js[mis == mi]] = probs[mis == mi]
    return outs


def test_empty_group_gives_empty_members(snp_fixture, states):
    fasta_p, bam_p = snp_fixture
    [gf] = get_snp_group_payloads(BamReader(bam_p), FastaFile(fasta_p),
                                  MEMBERS[1:2], maxcov=160)
    assert len(gf) == 0 and [s for _, s in gf.members] == [None]
    outs = P.infer_snp_group(states[1], _remap(gf), Cfg())
    assert [o.shape for o in outs] == [(0, 4)]


def test_wrapper_rejects_bad_inputs():
    w, *host = random_group_wire(np.random.default_rng(1), S=20, N=30, B=5)
    wire = K3.group_wire(w, "cpu")
    args = [torch.from_numpy(a) for a in host]
    K3.snp_pileup(wire, *args)  # the good call

    def bad(i, t):
        return K3.snp_pileup(wire, *args[:i], t, *args[i + 1:])

    for i, name in enumerate(("cand_site", "cand_pos", "lo_c", "hi_c")):
        with pytest.raises(TypeError, match=name):  # refused, not cast
            bad(i, args[i].long())
        with pytest.raises(ValueError, match="shape"):
            bad(i, args[i][:-1])
    with pytest.raises(TypeError, match="norm"):
        bad(4, args[4].double())
    with pytest.raises(ValueError, match="contiguous"):
        bad(1, torch.stack([args[1], args[1]], 1)[:, 0])
    for field, t in (("nbr_pos", wire.nbr_pos.long()),
                     ("bands", wire.bands[:, :6].contiguous()),
                     ("win_lo", wire.win_lo[:-1])):
        with pytest.raises((TypeError, ValueError), match=field):
            K3.snp_pileup(dataclasses.replace(wire, **{field: t}), *args)
    for field in ("nbr_pos", "nbr_union"):
        bad_w = copy.copy(w)
        setattr(bad_w, field, getattr(w, field)[::-1].copy())
        with pytest.raises(ValueError, match=field + " must be sorted"):
            K3.group_wire(bad_w, "cpu")
    before = total("k3.launches")
    K3.snp_pileup(wire, *args)
    assert total("k3.launches") == before  # the twin is no launch


@pytest.mark.parametrize("seed", range(3))
def test_site_depth_counts_covering_reads(seed):
    """site_depth against a plain count of the covered (site, read) cells
    of random payloads with empty spans and holes."""
    rng = np.random.default_rng(60 + seed)
    w, *_ = random_group_wire(rng, S=int(rng.integers(3, 50)),
                              N=int(rng.integers(2, 80)), B=1)
    S = len(w.site_ref)
    s = np.arange(S)[:, None]
    covered = (w.read_lo[None, :] <= s) & (s <= w.read_hi[None, :])
    covered[w.hole_site, w.hole_rid] = False
    np.testing.assert_array_equal(K3.site_depth(w), covered.sum(axis=1))


def test_pileup_cohorts_refuse_rows_deeper_than_maxcov(payloads, states):
    """A normal row deeper than the payload's maxcov is refused on the
    host, before any launch, whatever the device."""
    _, gf = payloads["ont", 160, "diploid"]
    state = states[1]
    assert P.pileup_cohorts(state, gf, Cfg())
    shallow = copy.copy(gf)
    depth = K3.site_depth(gf)
    shallow.maxcov = max(int(depth[sec.cand_site].max())
                         for _, sec in gf.members if sec is not None) - 1
    with pytest.raises(ValueError, match="deeper than maxcov"):
        P.pileup_cohorts(state, shallow, Cfg())


# A2a: a decode group over the payload caps. Two 100 kb members of a
# 200 kb contig: each member's scan window (±50 kb) holds ~3/4 of the
# contig's reads, the group's window all of them, so a read cap between
# the two sends the group member by member in both packages.
A2A_L = 200_000
A2A_CHUNKS = [{"chrom": "chr_t", "start": 1, "end": 100_000,
               "ploidy": "diploid"},
              {"chrom": "chr_t", "start": 100_001, "end": A2A_L,
               "ploidy": "diploid"}]


@pytest.fixture(scope="module")
def a2a_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_snp_a2a")
    ref = random_seq(np.random.default_rng(21), A2A_L)
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(900, A2A_L - 900, 1700))]
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=21, L=A2A_L, depth=12,
                                        read_len=2000, snps=snps,
                                        error_rate=0.01)
    bam = BamReader(bam_p)
    n = lambda lo, hi: decode_reads(bam, "chr_t", lo, hi).n_reads
    group = n(0, A2A_L)
    cap = max(n(0, 150_000), n(50_000, A2A_L))
    assert cap < group
    return str(tmp), fasta_p, bam_p, cap


def _call_snps(side, a2a_fixture, out, cap, monkeypatch):
    from nanocaller_tpu.config import Config as JConfig
    from nanocaller_tpu.pileup import snp_features as j_sf
    from nanocaller_tpu_torch.config import Config as PConfig
    from nanocaller_tpu_torch.pileup import snp_features as p_sf

    tmp, fasta_p, bam_p, _ = a2a_fixture
    kw = dict(bam=bam_p, ref=fasta_p, mode="snps", cpu=1, batch_size=128,
              output=os.path.join(tmp, out), prefix="p", sample="S")
    os.makedirs(kw["output"], exist_ok=True)
    regions = [("chr_t", 1, A2A_L, "diploid")]
    chunks = [dict(c) for c in A2A_CHUNKS]
    if side == "jax":
        monkeypatch.setattr(j_sf, "_GROUP_MAX_READS", cap)
        J.call_snps(JConfig(**kw), JBamReader(bam_p), JFastaFile(fasta_p),
                    regions, chunks, kw["output"])
    else:
        monkeypatch.setattr(p_sf, "_GROUP_MAX_READS", cap)
        P.call_snps(PConfig(device="cpu", **kw), BamReader(bam_p), regions,
                    chunks, kw["output"])
    names = ("p.unfiltered.snps.vcf.gz", "p.snps.vcf.gz")
    out = []
    for name in names:
        with gzip.open(os.path.join(kw["output"], name)) as fh:
            out.append(fh.read())
    return out


def _pr_rounding_cases(a, b):
    """Records of two SNP VCF texts, equal field for field except PR
    values (%.4f) one unit apart: the parity bar's rounding exception
    (ROADMAP "Parity bar"). Returns those cases; fails on any other
    difference."""
    ra = [l.split("\t") for l in a.decode().splitlines()]
    rb = [l.split("\t") for l in b.decode().splitlines()]
    assert len(ra) == len(rb)
    cases = []
    for x, y in zip(ra, rb):
        if x == y:
            continue
        assert x[:7] == y[:7] and x[8:] == y[8:], (x, y)
        ix, iy = x[7].split(";"), y[7].split(";")
        assert ix[1:] == iy[1:], (x, y)
        for u, v in zip(ix[0][3:].split(","), iy[0][3:].split(",")):
            assert abs(float(u) - float(v)) <= 1.0001e-4, (x, y)
        cases.append(int(x[1]))
    return cases


def test_group_over_caps_goes_member_by_member(a2a_fixture, monkeypatch):
    """With the read cap lowered under the group's decoded reads in both
    packages, the port sends each member as a group of one (one K3 cohort
    each), and its SNP VCFs equal its uncapped group run byte for byte
    and the JAX package's per-member fallback record for record: on this
    fixture one PR value of the JAX CNN and the port's straddles a %.4f
    rounding (position 2601: 0.0245 vs 0.0244), the parity bar's
    exception, which the JAX package's own group run shares."""
    from nanocaller_tpu_torch.pileup import snp_features as p_sf

    _tmp, fasta_p, bam_p, cap = a2a_fixture
    payloads = []
    real = p_sf.get_snp_group_payloads
    monkeypatch.setattr(p_sf, "get_snp_group_payloads", lambda *a, **k: (
        payloads.append(real(*a, **k)) or payloads[-1]))
    want = _call_snps("jax", a2a_fixture, "jax", cap, monkeypatch)
    got = _call_snps("port", a2a_fixture, "port", cap, monkeypatch)
    assert [len(p) for p in payloads] == [2]  # one payload a member
    assert [[oi for oi, _ in gf.members] for gf in payloads[0]] == [[0], [1]]
    assert got[1].count(b"\tPASS\t") >= 20
    assert [_pr_rounding_cases(g, w) for g, w in zip(got, want)] == \
        [[2601], []]
    payloads.clear()
    whole = _call_snps("port", a2a_fixture, "port_whole", 1 << 15,
                       monkeypatch)
    assert [len(p) for p in payloads] == [1] and whole == got
