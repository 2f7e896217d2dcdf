"""SNP candidate scan + the group-level device payload.

The group path of nanocaller_tpu/pileup/snp_features.py: the per-column
candidate scan (generate_SNP_pileups.py:103-279 as vectorized numpy
scans), several coordinate-adjacent chunks scanned off ONE decoded
window, and the interval + top-2-bitmask + exception/hole encoding of
their observations that the device turns into pileups
(pileup/snp_pileup.py, kernel K3).

Semantics parity notes (all cites into the reference NanoCaller):
- base codes A0 G1 T2 C3 other4            generate_SNP_pileups.py:104
- scan halo ±50 kb regardless of seq type  generate_SNP_pileups.py:137,156
- nbr-site thresholds per ploidy           generate_SNP_pileups.py:170-179
- candidate threshold + window gate        generate_SNP_pileups.py:183-186
- neighbor band schedules, 20/side         generate_SNP_pileups.py:6-101
- ref base valid only if uppercase AGTC    generate_SNP_pileups.py:137
- maxcov downsampling (reference draws from the unseeded stdlib RNG at
  :216, i.e. is nondeterministic across runs; a position-keyed
  deterministic RNG is used instead)

The group window is decoded in two native phases (engine.deferred_decode:
per-column counts for the scan, then per-read codes at the candidate ∪
neighbor sites only). A group over the payload caps, or one whose
neighbor lists fail the cross-check, is sent as one single-member group
per member, as the JAX package sends it as per-member payloads; a member
still over the caps on its own raises NotImplementedError (ROADMAP B6,
the per-chunk kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import (ReadWindow, SiteCodes, column_counts, decode_reads,
                     deferred_decode)

NBR_SIZE = 20
WIDTH = 2 * NBR_SIZE + 1  # 41
CENTER = NBR_SIZE  # candidate column index after padding
SNP_HALO = 50000

# reference FASTA char → code; lowercase (soft-masked) and N map to 4,
# matching the reference's `s.upper() if s in 'AGTC' else '*'` quirk.
REF_CODE_LUT = np.full(256, 4, dtype=np.int8)
for _b, _c in (("A", 0), ("G", 1), ("T", 2), ("C", 3)):
    REF_CODE_LUT[ord(_b)] = _c

# Band schedules from get_cnd_pos (generate_SNP_pileups.py:6-101).
# Each band: (lo_offset, hi_offset, k, take) meaning positions in
# [v+lo_offset, v+hi_offset) and take 'first' or 'last' k of the
# ascending-sorted band members. Left bands are listed far→near and right
# bands near→far so concatenation is ascending in position.
BAND_SCHEDULES = {
    "ont": {
        "left": [
            (-50000 + 1, -20000, 6, "last"),
            (-20000, -10000, 5, "last"),
            (-10000, -5000, 4, "last"),
            (-5000, -2000, 3, "last"),
            (-2000, 0, 2, "first"),
        ],
        "right": [
            (1, 2000 + 1, 2, "last"),
            (2000 + 1, 5000 + 1, 3, "first"),
            (5000 + 1, 10000 + 1, 4, "first"),
            (10000 + 1, 20000 + 1, 5, "first"),
            (20000 + 1, 50000, 6, "first"),
        ],
    },
    "short_ont": {
        "left": [
            (-50000 + 1, -5000, 5, "last"),
            (-5000, -2000, 10, "last"),
            (-2000, 0, 5, "last"),
        ],
        "right": [
            (1, 2000 + 1, 5, "first"),
            (2000 + 1, 5000 + 1, 10, "first"),
            (5000 + 1, 50000, 5, "first"),
        ],
    },
    "ul_ont": {
        "left": [
            (-100000 + 1, -50000, 3, "last"),
            (-50000, -40000, 3, "last"),
            (-40000, -20000, 4, "last"),
            (-20000, -10000, 3, "last"),
            (-10000, -5000, 3, "last"),
            (-5000, -2000, 2, "last"),
            (-2000, 0, 2, "first"),
        ],
        "right": [
            (1, 2000 + 1, 2, "last"),
            (2000 + 1, 5000 + 1, 2, "first"),
            (5000 + 1, 10000 + 1, 3, "first"),
            (10000 + 1, 20000 + 1, 3, "first"),
            (20000 + 1, 40000 + 1, 4, "first"),
            (40000 + 1, 50000 + 1, 3, "first"),
            (50000 + 1, 100000, 3, "first"),
        ],
    },
    "ul_ont_extreme": {
        "left": [
            (-300000 + 1, -200000, 2, "last"),
            (-200000, -100000, 4, "last"),
            (-100000, -75000, 4, "last"),
            (-75000, -50000, 3, "last"),
            (-50000, -20000, 3, "last"),
            (-20000, -10000, 2, "last"),
            (-10000, 0, 2, "first"),
        ],
        "right": [
            (1, 10000 + 1, 2, "last"),
            (10000 + 1, 20000 + 1, 2, "first"),
            (20000 + 1, 50000 + 1, 3, "first"),
            (50000 + 1, 75000 + 1, 3, "first"),
            (75000 + 1, 100000 + 1, 4, "first"),
            (100000 + 1, 200000 + 1, 4, "first"),
            (200000 + 1, 300000, 2, "first"),
        ],
    },
    "pacbio": {
        "left": [
            (-20000 + 1, -10000, 6, "last"),
            (-10000, -5000, 5, "last"),
            (-5000, -2000, 5, "last"),
            (-2000, 0, 4, "first"),
        ],
        "right": [
            (1, 2000 + 1, 4, "last"),
            (2000 + 1, 5000 + 1, 5, "first"),
            (5000 + 1, 10000 + 1, 5, "first"),
            (10000 + 1, 20000, 6, "first"),
        ],
    },
}


def select_neighbors(cand_pos, nbr_pos, seq_type):
    """Vectorized band-quota neighbor selection.

    cand_pos: (B,) candidate positions. nbr_pos: sorted (M,) neighbor
    site positions. Returns (nbr_idx (B, 41) int32 with -1 padding and
    the candidate marked -2 at column 20 — callers place candidate data
    there — plus left/right counts (B,)).

    Column layout matches the reference's zero-padding
    (generate_SNP_pileups.py:254): left neighbors right-aligned ending
    at column 19, candidate at 20, right neighbors from 21.
    """
    cand_pos = np.asarray(cand_pos, dtype=np.int64)
    nbr_pos = np.asarray(nbr_pos, dtype=np.int64)
    B = len(cand_pos)
    sched = BAND_SCHEDULES[seq_type]
    out = np.full((B, WIDTH), -1, dtype=np.int64)
    out[:, CENTER] = -2
    counts = {}
    for side in ("left", "right"):
        sel_parts = []
        val_parts = []
        for lo_off, hi_off, k, take in sched[side]:
            i0 = np.searchsorted(nbr_pos, cand_pos + lo_off, side="left")
            i1 = np.searchsorted(nbr_pos, cand_pos + hi_off, side="left")
            cnt = np.minimum(i1 - i0, k)
            start = i0 if take == "first" else i1 - cnt
            ranks = np.arange(k)
            idx = start[:, None] + ranks[None, :]
            valid = ranks[None, :] < cnt[:, None]
            sel_parts.append(np.where(valid, idx, 0))
            val_parts.append(valid)
        sel = np.concatenate(sel_parts, axis=1)
        val = np.concatenate(val_parts, axis=1)
        # compact valid entries left, preserving (ascending) order
        order = np.argsort(~val, axis=1, kind="stable")
        sel = np.take_along_axis(sel, order, axis=1)
        val = np.take_along_axis(val, order, axis=1)
        n = val.sum(axis=1)
        counts[side] = n
        ranks = np.arange(sel.shape[1])
        if side == "left":
            cols = CENTER - n[:, None] + ranks[None, :]
        else:
            cols = np.broadcast_to(CENTER + 1 + ranks[None, :], sel.shape)
        flat_rows = np.repeat(np.arange(B), sel.shape[1])
        vmask = val.ravel()
        out[flat_rows[vmask], cols.ravel()[vmask]] = sel.ravel()[vmask]
    return out, counts["left"], counts["right"]


@dataclass
class SnpChunkScan:
    """Shared intermediates of the candidate scan (before payload
    assembly): one per group member, produced by `_scan_group` and
    consumed by `_assemble_group_payload`."""

    contig: str
    scan_start: int
    ref_codes: np.ndarray  # int8 over the scan window
    cand_pos: np.ndarray  # int64[B]
    nbr_counts: np.ndarray  # int32[B]
    union_sites: np.ndarray  # int64[S] sorted (nbr ∪ cand)
    sc: "SiteCodes"
    rw: "ReadWindow"
    cand_site_i: np.ndarray  # int64[B] index into union_sites
    nbr_site_of_col: np.ndarray  # int64[B, 41]; -1 pad, center untouched(-2→set)
    nbr_pos: np.ndarray  # int64[M] neighbor-eligible site positions (sorted)
    dp: np.ndarray  # int32[B]
    freq: np.ndarray  # float32[B]
    fwd_dp: np.ndarray  # int32[B, 4]
    rev_dp: np.ndarray  # int32[B, 4]
    counts_c: np.ndarray  # int64[B] raw center depth (pre-sampling)


@dataclass
class _ScanP1:
    """Phase-1 scan result: candidate/neighbor selection from counts
    alone (no per-read events needed)."""

    cand_pos: np.ndarray
    nbr_pos: np.ndarray
    nbr_idx_mat: np.ndarray
    nbr_counts: np.ndarray
    dp: np.ndarray
    freq: np.ndarray


def _scan_phase1(counts, ref_codes, scan_start, scan_end, cand_lo, cand_hi,
                 contig, *, seq_type, mincov, min_allele_freq, min_nbr_sites,
                 threshold, ploidy, exclude):
    """Candidate + neighbor selection over [scan_start, scan_end) from
    per-column counts; None when the chunk yields no candidates."""
    n_aligned = counts[:, :5].sum(axis=1)
    base_counts = counts[:, :4].astype(np.float32)
    ref_valid = ref_codes < 4
    # max alt count: mask out the ref base channel per column
    masked = base_counts.copy()
    cols = np.arange(len(ref_codes))
    masked[cols[ref_valid], ref_codes[ref_valid].astype(np.int64)] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        alt_freq = np.where(n_aligned > 0, masked.max(axis=1) / n_aligned, 0.0)

    ok = ref_valid & (n_aligned >= mincov)
    if exclude is not None:
        ok &= ~exclude.mask(contig, np.arange(scan_start, scan_end))
    if ploidy == "haploid":
        nbr_mask = ok & (alt_freq >= threshold[0])
    else:
        nbr_mask = ok & (alt_freq >= threshold[0]) & (alt_freq < threshold[1])
    pos_all = np.arange(scan_start, scan_end, dtype=np.int64)
    in_window = (pos_all >= cand_lo) & (pos_all <= cand_hi)
    cand_mask = ok & in_window & (alt_freq >= min_allele_freq)

    nbr_pos = pos_all[nbr_mask]
    cand_pos = pos_all[cand_mask]
    if len(cand_pos) == 0:
        return None

    nbr_idx_mat, n_left, n_right = select_neighbors(cand_pos, nbr_pos, seq_type)
    nbr_counts = (1 + n_left + n_right).astype(np.int32)
    keep = nbr_counts >= min_nbr_sites
    if not keep.any():
        return None
    return _ScanP1(
        cand_pos=cand_pos[keep],
        nbr_pos=nbr_pos,
        nbr_idx_mat=nbr_idx_mat[keep],
        nbr_counts=nbr_counts[keep],
        dp=n_aligned[cand_mask][keep].astype(np.int32),
        freq=alt_freq[cand_mask][keep].astype(np.float32))


def _scan_phase2(contig, scan_start, ref_codes, rw, p1: _ScanP1):
    """Event-dependent tail of the scan: SiteCodes over the union sites,
    strand-split depths, per-candidate CSR depths → SnpChunkScan."""
    cand_pos = p1.cand_pos
    nbr_pos = p1.nbr_pos
    union_sites = np.union1d(nbr_pos, cand_pos)
    sc = SiteCodes(rw, union_sites)
    cand_site_i = np.searchsorted(union_sites, cand_pos)
    if len(nbr_pos):
        nbr_site_of_col = np.where(
            p1.nbr_idx_mat >= 0,
            np.searchsorted(union_sites,
                            nbr_pos[np.maximum(p1.nbr_idx_mat, 0)]),
            -1)
    else:
        # no neighbor-band sites anywhere (e.g. hom-only contig):
        # every non-center column stays padding
        nbr_site_of_col = np.full_like(p1.nbr_idx_mat, -1)

    B = len(cand_pos)

    # strand-split counts + per-candidate read lists, vectorized over the
    # SiteCodes CSR (a per-candidate python loop here was ~35% of host
    # feature time at 45×). Candidate-site observations are selected via
    # a site→candidate map; counts become two bincounts over fused
    # (candidate, base) keys; read lists scatter through a ragged arange.
    S = len(union_sites)
    cand_of_site = np.full(S, -1, dtype=np.int64)
    cand_of_site[cand_site_i] = np.arange(B)
    obs_site = np.repeat(np.arange(S, dtype=np.int64), np.diff(sc.indptr))
    obs_cand = cand_of_site[obs_site]
    sel = obs_cand >= 0
    ci = obs_cand[sel]
    ccode_all = sc.code[sel].astype(np.int64)
    crev = rw.strand[sc.rid[sel]].astype(bool)
    # guard both ends: SNP SiteCodes codes are 0-4 today, but the indel
    # pseudo-event convention uses -1, and a negative code here would
    # corrupt the fused bincount key (advisor finding r1)
    base_ok = (ccode_all >= 0) & (ccode_all < 4)
    fwd_dp = np.bincount(ci[base_ok & ~crev] * 4 + ccode_all[base_ok & ~crev],
                         minlength=B * 4).astype(np.int32).reshape(B, 4)
    rev_dp = np.bincount(ci[base_ok & crev] * 4 + ccode_all[base_ok & crev],
                         minlength=B * 4).astype(np.int32).reshape(B, 4)

    counts_c = (sc.indptr[cand_site_i + 1]
                - sc.indptr[cand_site_i]).astype(np.int64)
    return SnpChunkScan(
        contig=contig, scan_start=scan_start, ref_codes=ref_codes,
        cand_pos=cand_pos, nbr_counts=p1.nbr_counts, union_sites=union_sites,
        sc=sc, rw=rw, cand_site_i=cand_site_i,
        nbr_site_of_col=nbr_site_of_col, nbr_pos=nbr_pos,
        dp=p1.dp, freq=p1.freq,
        fwd_dp=fwd_dp, rev_dp=rev_dp, counts_c=counts_c)



def _member_window(rw_g: ReadWindow, contig, m_lo, m_hi):
    """Restrict a group-decoded ReadWindow to the reads overlapping
    [m_lo, m_hi), remapping read ids to the member-local position-ordered
    id space — exactly the reads (and order) a standalone decode of that
    window accepts, so downstream arrays are element-identical."""
    mask = (rw_g.read_start < m_hi) & (rw_g.read_end > m_lo)
    sel = np.flatnonzero(mask)
    g2l = np.cumsum(mask) - 1  # valid at mask positions only
    evm = mask[rw_g.ev_rid] if len(rw_g.ev_rid) else np.zeros(0, bool)
    dm = mask[rw_g.del_rid] if len(rw_g.del_rid) else np.zeros(0, bool)
    im = mask[rw_g.ins_rid] if len(rw_g.ins_rid) else np.zeros(0, bool)
    return ReadWindow(
        contig=contig, start=m_lo, end=m_hi,
        qnames=[rw_g.qnames[i] for i in sel],
        flags=rw_g.flags[sel], strand=rw_g.strand[sel],
        read_start=rw_g.read_start[sel], read_end=rw_g.read_end[sel],
        hp=rw_g.hp[sel], ps=rw_g.ps[sel],
        ev_rid=g2l[rw_g.ev_rid[evm]].astype(np.int32),
        ev_pos=rw_g.ev_pos[evm], ev_code=rw_g.ev_code[evm],
        ev_qpos=rw_g.ev_qpos[evm],
        del_rid=g2l[rw_g.del_rid[dm]].astype(np.int32),
        del_start=rw_g.del_start[dm], del_len=rw_g.del_len[dm],
        ins_rid=g2l[rw_g.ins_rid[im]].astype(np.int32),
        ins_pos=rw_g.ins_pos[im], ins_len=rw_g.ins_len[im],
        seqs=[])


def _scan_group(
    bam,
    fasta,
    members,
    *,
    seq_type="ont",
    mincov=4,
    maxcov=160,
    min_allele_freq=0.15,
    min_nbr_sites=1,
    threshold=(0.4, 0.6),
    exclude=None,
):
    """Per-member SnpChunkScans off ONE decoded window, plus the
    group-level intermediates the group-payload assembler consumes (the
    group ReadWindow, reference codes and member scan windows). Returns
    (scans, rw_g, ref_codes_g, g_lo, windows) where scans/windows align
    with members; rw_g is None when no member yielded candidates.

    Each member's scan runs over exactly its own ±SNP_HALO window with
    its own read-id space (_member_window), so every per-member array
    equals a standalone scan of that chunk. The window is decoded in two
    native phases: counts for the scan, then events at the members'
    candidate and neighbor sites."""
    contig = members[0]["chrom"]
    g_lo = max(0, min(m["start"] for m in members) - 1 - SNP_HALO)
    g_hi = max(m["end"] for m in members) + SNP_HALO

    dd = deferred_decode(bam, contig, g_lo, g_hi)
    rw_g = None
    ref_str = fasta.fetch(contig, g_lo, g_hi)
    g_hi = min(g_hi, g_lo + len(ref_str))
    ref_codes_g = REF_CODE_LUT[np.frombuffer(ref_str.encode(), dtype=np.uint8)]
    if dd is not None:
        counts_g = dd.counts(g_lo, g_hi)
    else:  # a CRAM layout the C++ decoder does not implement
        rw_g = decode_reads(bam, contig, g_lo, g_hi)
        counts_g = column_counts(rw_g, g_lo, g_hi)

    p1s = []
    site_parts = []
    for m in members:
        m_lo = max(0, m["start"] - 1 - SNP_HALO)
        m_hi = min(m["end"] + SNP_HALO, g_hi)
        counts_m = counts_g[m_lo - g_lo: m_hi - g_lo]
        ref_m = ref_codes_g[m_lo - g_lo: m_hi - g_lo]
        p1 = _scan_phase1(
            counts_m, ref_m, m_lo, m_hi, m["start"] - 1, m["end"] - 1,
            contig, seq_type=seq_type, mincov=mincov,
            min_allele_freq=min_allele_freq, min_nbr_sites=min_nbr_sites,
            threshold=threshold, ploidy=m.get("ploidy", "diploid"),
            exclude=exclude)
        p1s.append((m_lo, m_hi, ref_m, p1))
        if p1 is not None:
            site_parts.append(p1.nbr_pos)
            site_parts.append(p1.cand_pos)

    windows = [(m_lo, m_hi) for m_lo, m_hi, _, _ in p1s]
    if not site_parts:
        if dd is not None:
            dd.close()
        return [None] * len(members), None, ref_codes_g, g_lo, windows
    if dd is not None:
        rw_g = dd.finish(np.unique(np.concatenate(site_parts)))

    out = []
    for m_lo, m_hi, ref_m, p1 in p1s:
        if p1 is None:
            out.append(None)
            continue
        rw_m = _member_window(rw_g, contig, m_lo, m_hi)
        out.append(_scan_phase2(contig, m_lo, ref_m, rw_m, p1))
    return out, rw_g, ref_codes_g, g_lo, windows


def _encode_interval_exceptions(sc, n_reads, S):
    """Interval + exception + top-2-bitmask encoding of a SiteCodes
    observation set (SnpGroupFeatures docstring): per-read observed-site
    span, per-site top-2 codes, one bit per covered cell selecting
    top-2, explicit exceptions for the residue, and the rare in-span
    unobserved (site, rid) holes.

    Returns (read_lo, read_hi, site_major, site_minor, minor_bits,
    exc_site, exc_rid, exc_code, hole_site, hole_rid) — exceptions
    sorted by (site, rid) since the SiteCodes triplets are."""
    obs_site = np.repeat(np.arange(S, dtype=np.int64),
                         np.diff(sc.indptr)).astype(np.int32)
    read_lo = np.full(n_reads, np.iinfo(np.int32).max, np.int32)
    read_hi = np.zeros(n_reads, np.int32)
    obs_cnt = np.bincount(sc.rid, minlength=n_reads)
    if len(obs_site):
        np.minimum.at(read_lo, sc.rid, obs_site)
        np.maximum.at(read_hi, sc.rid, obs_site)
    # reads with no observation at any union site: empty span lo=1 > hi=0
    read_lo[obs_cnt == 0] = 1
    read_hi[obs_cnt == 0] = 0
    # per-site top-2 observed codes (ties: smaller code — argmax on
    # the bincount); obs matching top-1 ship as nothing, obs matching
    # top-2 ship as one bit, the rest as explicit exceptions
    code_hist = np.bincount(obs_site.astype(np.int64) * 8
                            + sc.code.astype(np.int64),
                            minlength=S * 8).reshape(S, 8)
    site_major = code_hist.argmax(axis=1).astype(np.int8)
    hist2 = code_hist.copy()
    hist2[np.arange(S), site_major] = -1
    site_minor = hist2.argmax(axis=1).astype(np.int8)
    has_minor = hist2[np.arange(S), site_minor] > 0
    site_minor = np.where(has_minor, site_minor, site_major).astype(np.int8)

    spans = np.where(read_hi >= read_lo,
                     read_hi.astype(np.int64) - read_lo + 1, 0)
    span_start = np.zeros(n_reads, np.int64)
    if n_reads > 1:
        np.cumsum(spans[:-1], out=span_start[1:])
    total_span = int(spans.sum())
    minor_bits = np.zeros((total_span + 7) // 8, np.uint8)
    is_minor = (sc.code == site_minor[obs_site]) \
        & (site_minor != site_major)[obs_site]
    if is_minor.any():
        bit = (span_start[sc.rid[is_minor]]
               + obs_site[is_minor] - read_lo[sc.rid[is_minor]])
        np.bitwise_or.at(minor_bits, bit >> 3,
                         (1 << (bit & 7)).astype(np.uint8))

    exc = (sc.code != site_major[obs_site]) & ~is_minor
    exc_site = obs_site[exc]
    exc_rid = sc.rid[exc]
    exc_code = sc.code[exc]
    span = np.where(obs_cnt > 0, read_hi - read_lo + 1, 0)
    n_holes = int(span.sum() - len(obs_site))
    hole_site = np.zeros(0, np.int32)
    hole_rid = np.zeros(0, np.int32)
    if n_holes:
        # rare path (N skip-ops): per affected read, sites in span minus
        # observed sites. One rid-sort makes each read's observed sites
        # an O(1) slice (a per-read boolean scan over all observations
        # degraded to O(E * n_affected) on N-heavy windows)
        hs, hr = [], []
        per_read_holes = span - obs_cnt
        order = np.argsort(sc.rid, kind="stable")
        obs_by_rid = obs_site[order]
        starts = np.searchsorted(sc.rid[order],
                                 np.arange(n_reads + 1, dtype=sc.rid.dtype))
        for r in np.flatnonzero(per_read_holes > 0):
            got = obs_by_rid[starts[r]:starts[r + 1]]
            missing = np.setdiff1d(
                np.arange(read_lo[r], read_hi[r] + 1, dtype=np.int32), got)
            hs.append(missing)
            hr.append(np.full(len(missing), r, np.int32))
        hole_site = np.concatenate(hs).astype(np.int32)
        hole_rid = np.concatenate(hr)
    return (read_lo, read_hi, site_major, site_minor, minor_bits,
            exc_site, exc_rid, exc_code, hole_site, hole_rid)


@dataclass
class SnpGroupMember:
    """Per-member section of a group-level payload (SnpGroupFeatures).

    Candidate/site indices live in the GROUP union-site space; each
    member keeps its own semantics (own neighbor window clamp, own
    coverage normalizer). Also carries the host decode fields that
    snp_caller.decode_diploid / decode_haploid read."""

    contig: str
    ploidy: str
    cand_site: np.ndarray  # int32[B] GROUP union-site index
    cand_pos32: np.ndarray  # int32[B]
    # clamp of on-device neighbor selection to this member's scan
    # window: indices into the group nbr arrays (nbr_pos[nbr_lo:nbr_hi]
    # == the member's own neighbor-site list, verified at assembly)
    nbr_lo: int
    nbr_hi: int
    deep_idx: np.ndarray  # int64[Bd]
    deep_rids: np.ndarray  # int32[Bd, maxcov] GROUP read ids (ascending)
    # host-side decode fields
    pos: np.ndarray
    center_ref: np.ndarray
    dp: np.ndarray
    freq: np.ndarray
    fwd_dp: np.ndarray
    rev_dp: np.ndarray
    sampled_depth: np.ndarray
    nbr_counts: np.ndarray
    maxcov: int = 160

    @property
    def coverage(self):
        return float(np.mean(self.sampled_depth)) if len(self.pos) else 0.0

    def __len__(self):
        return len(self.pos)


@dataclass
class SnpGroupFeatures:
    """GROUP-level observation payload of one decode group.

    One interval+exception+bitmask observation table per decode group,
    shipped to the device once; every candidate row then computes each
    (site, read) cell code directly from it — interval test, hole CSR,
    exception CSR, else the top-2 bit picks the site's minor or major
    code — with no dense site×read table (kernel K3,
    pileup/snp_pileup.py). Covering-read sets, their ascending order and
    all cell codes are preserved exactly under the member→group id
    remap. Members without candidates are (chunk, None).

    Cell-code semantics: a read q covers union site s iff
    read_lo[q] ≤ s ≤ read_hi[q] and (s, q) is not a hole; a covered
    cell's code is exc_code at an exception-CSR hit, else site_minor[s]
    where bit span_start[q] + s − read_lo[q] of minor_bits is set
    (span_start: the exclusive cumsum of the read span lengths), else
    site_major[s]. Reads with no observation carry lo = 1 > hi = 0.
    """

    contig: str
    seq_type: str
    maxcov: int
    n_reads: int
    # observation wire (group union-site space; semantics above)
    read_lo: np.ndarray  # int32[N] first observed union-site index
    read_hi: np.ndarray  # int32[N] last observed union-site index (incl.)
    site_ref: np.ndarray  # int8[S]
    site_major: np.ndarray  # int8[S]
    site_minor: np.ndarray  # int8[S]
    minor_bits: np.ndarray  # uint8[ceil(total_span/8)]
    exc_site: np.ndarray  # int32[E] sorted by (site, rid)
    exc_rid: np.ndarray  # int32[E]
    exc_code: np.ndarray  # int8[E]
    hole_site: np.ndarray  # int32[H] sorted by (site, rid)
    hole_rid: np.ndarray  # int32[H]
    nbr_pos: np.ndarray  # int32[M] sorted neighbor site positions (union)
    nbr_union: np.ndarray  # int32[M] group union-site index per neighbor
    members: list  # [(orig_idx, SnpGroupMember)]

    def __len__(self):
        return sum(len(m) for _, m in self.members if m is not None)


# group-payload caps of the JAX package (its (batch × reads) device
# mask), kept so that both packages send the same groups whole: a group
# beyond them goes member by member
_GROUP_MAX_READS = 1 << 15
_GROUP_MAX_SITES = 1 << 19


def get_snp_group_payloads(
    bam,
    fasta,
    members,
    *,
    seq_type="ont",
    mincov=4,
    maxcov=160,
    min_allele_freq=0.15,
    min_nbr_sites=1,
    threshold=(0.4, 0.6),
    exclude=None,
):
    """Scan a group off one decoded window and build its payloads: a list
    of SnpGroupFeatures whose members, in order, are `members` as
    (member dict, SnpGroupMember or None).

    One payload for the whole group, or — where it is over the payload
    caps or its neighbor lists fail the cross-check — one single-member
    payload per member, built from that member's own scan (its reads,
    id space and sites are a standalone scan's), which the caller sends
    through the same group path. A group without candidates gives one
    payload of empty members. A member over the caps on its own raises
    NotImplementedError: the per-chunk kernels (ROADMAP B6) are not
    ported."""
    scans, rw_g, ref_codes_g, g_lo, windows = _scan_group(
        bam, fasta, members, seq_type=seq_type, mincov=mincov,
        maxcov=maxcov, min_allele_freq=min_allele_freq,
        min_nbr_sites=min_nbr_sites, threshold=threshold, exclude=exclude)
    if rw_g is None:
        return [_empty_group(members, seq_type, maxcov)]
    gf = _assemble_group_payload(members, scans, rw_g, ref_codes_g, g_lo,
                                 windows, maxcov, seq_type)
    if gf is not None:
        return [gf]
    out = []
    for m, scan, (m_lo, m_hi) in zip(members, scans, windows):
        if scan is None:
            out.append(_empty_group([m], seq_type, maxcov))
            continue
        one = _assemble_group_payload(
            [m], [scan], scan.rw, ref_codes_g[m_lo - g_lo: m_hi - g_lo],
            m_lo, [(m_lo, m_hi)], maxcov, seq_type)
        if one is None:
            raise NotImplementedError(
                "SNP chunk %s:%d-%d is over the payload caps on its own "
                "(%d decoded reads, %d sites; caps %d and %d): its "
                "per-chunk path needs the SNP per-chunk kernels, not "
                "ported yet (ROADMAP B6)"
                % (m["chrom"], m["start"], m["end"], scan.rw.n_reads,
                   len(scan.union_sites), _GROUP_MAX_READS,
                   _GROUP_MAX_SITES))
        out.append(one)
    return out


def _assemble_group_payload(members, scans, rw_g, ref_codes_g, g_lo,
                            windows, maxcov, seq_type):
    """Build SnpGroupFeatures from a completed group scan; None when a
    feasibility cap or a cross-check fails (the caller then goes member
    by member)."""
    contig = members[0]["chrom"]
    live = [s for s in scans if s is not None]
    union_g = np.unique(np.concatenate([s.union_sites for s in live]))
    S = len(union_g)
    n_reads = rw_g.n_reads
    if n_reads > _GROUP_MAX_READS or S > _GROUP_MAX_SITES:
        return None
    sc_g = SiteCodes(rw_g, union_g)
    (read_lo, read_hi, site_major, site_minor, minor_bits,
     exc_site, exc_rid, exc_code, hole_site, hole_rid) = \
        _encode_interval_exceptions(sc_g, n_reads, S)
    site_ref = ref_codes_g[union_g - g_lo].astype(np.int8)
    nbr_pos_g = np.unique(np.concatenate([s.nbr_pos for s in live])) \
        if any(len(s.nbr_pos) for s in live) else np.zeros(0, np.int64)
    nbr_union_g = np.searchsorted(union_g, nbr_pos_g).astype(np.int32)

    out_members = []
    for m, scan, (m_lo, m_hi) in zip(members, scans, windows):
        if scan is None:
            out_members.append((m, None))
            continue
        cand_site = np.searchsorted(union_g, scan.cand_pos).astype(np.int32)
        nbr_lo = int(np.searchsorted(nbr_pos_g, m_lo))
        nbr_hi = int(np.searchsorted(nbr_pos_g, m_hi))
        # the member's own neighbor list must equal its window slice of
        # the group list (guaranteed by phase1's pure per-column
        # thresholds; verified defensively — a mismatch means no group
        # payload, not silent divergence)
        if not np.array_equal(nbr_pos_g[nbr_lo:nbr_hi], scan.nbr_pos):
            return None
        counts_c = scan.counts_c
        deep_idx = np.flatnonzero(counts_c > maxcov)
        deep_rids = np.zeros((len(deep_idx), maxcov), np.int32)
        for k, i in enumerate(deep_idx):
            # the JAX package's position-keyed RNG stream; pick indices
            # address the site's ascending covering-read list, so the
            # same PHYSICAL reads are sampled
            rids_g, _codes = sc_g.at(int(cand_site[i]))
            if len(rids_g) != int(counts_c[i]):
                return None
            rng = np.random.default_rng((812 << 32) | int(scan.cand_pos[i]))
            pick = rng.choice(int(counts_c[i]), size=maxcov, replace=False)
            pick.sort()
            deep_rids[k] = rids_g[pick]
        out_members.append((m, SnpGroupMember(
            contig=contig,
            ploidy=m.get("ploidy", "diploid"),
            cand_site=cand_site,
            cand_pos32=scan.cand_pos.astype(np.int32),
            nbr_lo=nbr_lo,
            nbr_hi=nbr_hi,
            deep_idx=deep_idx,
            deep_rids=deep_rids,
            pos=scan.cand_pos,
            center_ref=site_ref[cand_site].copy(),
            dp=scan.dp,
            freq=scan.freq,
            fwd_dp=scan.fwd_dp,
            rev_dp=scan.rev_dp,
            sampled_depth=np.minimum(counts_c, maxcov).astype(np.int32),
            nbr_counts=scan.nbr_counts,
            maxcov=maxcov,
        )))
    return SnpGroupFeatures(
        contig=contig,
        seq_type=seq_type,
        maxcov=maxcov,
        n_reads=n_reads,
        read_lo=read_lo,
        read_hi=read_hi,
        site_ref=site_ref,
        site_major=site_major,
        site_minor=site_minor,
        minor_bits=minor_bits,
        exc_site=exc_site.astype(np.int32),
        exc_rid=exc_rid.astype(np.int32),
        exc_code=exc_code.astype(np.int8),
        hole_site=hole_site,
        hole_rid=hole_rid,
        nbr_pos=nbr_pos_g.astype(np.int32),
        nbr_union=nbr_union_g,
        members=out_members,
    )

def _empty_group(members, seq_type, maxcov):
    i32 = lambda: np.zeros(0, np.int32)
    i8 = lambda: np.zeros(0, np.int8)
    return SnpGroupFeatures(
        contig=members[0]["chrom"], seq_type=seq_type, maxcov=maxcov,
        n_reads=0, read_lo=i32(), read_hi=i32(), site_ref=i8(),
        site_major=i8(), site_minor=i8(), minor_bits=np.zeros(0, np.uint8),
        exc_site=i32(), exc_rid=i32(), exc_code=i8(), hole_site=i32(),
        hole_rid=i32(), nbr_pos=i32(), nbr_union=i32(),
        members=[(m, None) for m in members])
