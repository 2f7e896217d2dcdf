"""SNP candidate scan and the SNP stage's host payloads.

nanocaller_tpu/pileup/snp_features.py's scan and representations: the
per-column candidate scan (generate_SNP_pileups.py:103-279 as vectorized
numpy scans), run over one chunk or over several coordinate-adjacent
chunks off ONE decoded window, and three payloads of its observations:
- SnpGroupFeatures, a decode group's interval + top-2-bitmask +
  exception/hole encoding (the main path; kernel K3 on a group wire,
  pileup/snp_pileup.py);
- SnpChunkFeatures, the same encoding for one chunk, its exceptions as a
  site CSR of (rid << 3) | code (--no_snp_group_payload,
  snp_group_span <= -1, and a chunk over the group payload caps on its
  own; K3 on a chunk wire);
- SnpBatch, the dense per-candidate (R, 41) read-code matrices (the
  oracle path, --no_dedup_transfer, and a chunk whose site x read table
  is over _TABLE_CELL_CAP cells; kernel K5, pileup/snp_dense.py).

Semantics parity notes (all cites into the reference NanoCaller):
- base codes A0 G1 T2 C3 other4            generate_SNP_pileups.py:104
- scan halo ±50 kb regardless of seq type  generate_SNP_pileups.py:137,156
- nbr-site thresholds per ploidy           generate_SNP_pileups.py:170-179
- candidate threshold + window gate        generate_SNP_pileups.py:183-186
- neighbor band schedules, 20/side         generate_SNP_pileups.py:6-101
- tensor formula incl. sign flip           generate_SNP_pileups.py:221-254
- ref base valid only if uppercase AGTC    generate_SNP_pileups.py:137
- maxcov downsampling (reference draws from the unseeded stdlib RNG at
  :216, i.e. is nondeterministic across runs; a position-keyed
  deterministic RNG is used instead)

A window is decoded in two native phases (engine.deferred_decode:
per-column counts for the scan, then per-read codes at the candidate ∪
neighbor sites only). A group over the payload caps, or one whose
neighbor lists fail the cross-check, is sent as one single-member group
per member; a member over the caps on its own goes as its
SnpChunkFeatures (or SnpBatch), as the JAX package's per-member fallback
builds it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import (ReadWindow, SiteCodes, _ragged_arange, column_counts,
                     decode_reads, deferred_decode)

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
class SnpBatch:
    """Dense batch of SNP candidate features (host arrays)."""

    contig: str
    pos: np.ndarray  # int64[B] 0-based
    codes: np.ndarray  # int8[B, Rmax, 41] read base codes (4 = missing/other)
    read_mask: np.ndarray  # bool[B, Rmax]
    col_ref: np.ndarray  # int8[B, 41] (4 at padded columns)
    col_valid: np.ndarray  # bool[B, 41]
    center_ref: np.ndarray  # int8[B]
    dp: np.ndarray  # int32[B] aligned depth (non-del)
    freq: np.ndarray  # float32[B] max alt-allele freq
    fwd_dp: np.ndarray  # int32[B, 4]
    rev_dp: np.ndarray  # int32[B, 4]
    sampled_depth: np.ndarray  # int32[B] reads used after maxcov sampling
    nbr_counts: np.ndarray  # int32[B] 1 + len(left) + len(right)

    @property
    def coverage(self):
        """Region coverage = mean sampled depth (generate_SNP_pileups.py:274)."""
        return float(np.mean(self.sampled_depth)) if len(self.pos) else 0.0

    def __len__(self):
        return len(self.pos)


def assemble_matrices_np(batch: SnpBatch):
    """Numpy oracle of the dense pileup assembly (kernel K5 before the
    coverage scale); returns float32 (B,5,41,5).

    Mirrors generate_SNP_pileups.py:247-254 exactly.
    """
    codes = batch.codes.astype(np.int64)
    center = codes[:, :, CENTER]
    grp = (center[..., None] == np.arange(4)).astype(np.float32)
    grp *= batch.read_mask[..., None]
    oh = np.eye(5, dtype=np.float32)[codes]  # (B,R,41,5)
    mat = np.einsum("brg,brwc->bgwc", grp, oh)[..., :4]
    ref_eq = (batch.center_ref[:, None] == np.arange(4)).astype(np.float32)
    ch4 = ref_eq[:, :, None] * batch.col_valid[:, None, :]
    mat = np.concatenate([mat, ch4[..., None]], axis=-1)  # (B,4,41,5)
    total_ref = np.eye(5, dtype=np.float32)[batch.col_ref.astype(np.int64)]
    total_ref[..., 4] = 0.0
    flip = 1.0 - 2.0 * total_ref
    data = np.concatenate([total_ref[:, None], mat * flip[:, None]], axis=1)
    return data.astype(np.float32)


@dataclass
class SnpChunkScan:
    """Shared intermediates of the candidate scan (before payload
    assembly): one per chunk, produced by `_scan_chunk` or, one per
    group member, by `_scan_group`, and consumed by the assemblers
    (`_assemble_dense`, `_assemble_chunk_features`,
    `_assemble_group_payload`)."""

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


def _scan_chunk(
    bam,
    fasta,
    chunk,
    *,
    seq_type="ont",
    mincov=4,
    maxcov=160,
    min_allele_freq=0.15,
    min_nbr_sites=1,
    threshold=(0.4, 0.6),
    ploidy="diploid",
    exclude=None,
    rw: ReadWindow = None,
):
    """Candidate scan of one chunk; None when it has no candidate.

    chunk: dict with 'chrom', 'start', 'end' (1-based inclusive, like the
    reference's chunk dicts). Given `rw`, its reads are scanned instead
    of a decode of the chunk's window.
    """
    contig = chunk["chrom"]
    # 0-based scan window, 1-based parity with :137/:156
    scan_start = max(0, chunk["start"] - 1 - SNP_HALO)
    scan_end = chunk["end"] + SNP_HALO
    cand_lo, cand_hi = chunk["start"] - 1, chunk["end"] - 1  # 0-based incl.

    # two-phase decode: counts now, per-read codes only at the candidate
    # ∪ neighbor sites later (None for a CRAM layout the C++ decoder does
    # not implement: one Python decode then)
    dd = deferred_decode(bam, contig, scan_start, scan_end) if rw is None \
        else None
    if rw is None and dd is None:
        rw = decode_reads(bam, contig, scan_start, scan_end)
    ref_str = fasta.fetch(contig, scan_start, scan_end)
    scan_end = min(scan_end, scan_start + len(ref_str))
    ref_codes = REF_CODE_LUT[np.frombuffer(ref_str.encode(), dtype=np.uint8)]

    counts = dd.counts(scan_start, scan_end) if dd is not None \
        else column_counts(rw, scan_start, scan_end)
    p1 = _scan_phase1(
        counts, ref_codes, scan_start, scan_end, cand_lo, cand_hi, contig,
        seq_type=seq_type, mincov=mincov, min_allele_freq=min_allele_freq,
        min_nbr_sites=min_nbr_sites, threshold=threshold, ploidy=ploidy,
        exclude=exclude)
    if p1 is None:
        if dd is not None:
            dd.close()
        return None
    if dd is not None:
        rw = dd.finish(np.union1d(p1.nbr_pos, p1.cand_pos))
    return _scan_phase2(contig, scan_start, ref_codes, rw, p1)



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


def get_snp_candidates(
    bam,
    fasta,
    chunk,
    *,
    seq_type="ont",
    mincov=4,
    maxcov=160,
    min_allele_freq=0.15,
    min_nbr_sites=1,
    threshold=(0.4, 0.6),
    ploidy="diploid",
    exclude=None,
    rw: ReadWindow = None,
):
    """Scan one chunk and build its dense SnpBatch (possibly empty): the
    oracle path (--no_dedup_transfer), equal in probabilities to
    get_snp_chunk_features by construction."""
    scan = _scan_chunk(
        bam, fasta, chunk, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
        min_allele_freq=min_allele_freq, min_nbr_sites=min_nbr_sites,
        threshold=threshold, ploidy=ploidy, exclude=exclude, rw=rw)
    if scan is None:
        return _empty_batch(chunk["chrom"])
    return _assemble_dense(scan, maxcov)


def _assemble_dense(scan: SnpChunkScan, maxcov) -> SnpBatch:
    """Materialize the per-candidate (maxcov, 41) code matrices on the
    host (mirrors generate_SNP_pileups.py:221-254): a normal row lists
    its covering reads in ascending id order, a deep row (depth > maxcov)
    its position-keyed sample."""
    ref_codes = scan.ref_codes
    scan_start = scan.scan_start
    cand_pos = scan.cand_pos
    sc = scan.sc
    cand_site_i = scan.cand_site_i
    nbr_site_of_col = scan.nbr_site_of_col
    counts_c = scan.counts_c
    B = len(cand_pos)

    Rmax = maxcov
    codes = np.full((B, Rmax, WIDTH), 4, dtype=np.int8)
    read_mask = np.zeros((B, Rmax), dtype=bool)
    col_ref = np.full((B, WIDTH), 4, dtype=np.int8)
    col_valid = np.zeros((B, WIDTH), dtype=bool)
    rid_mat = np.full((B, Rmax), -1, dtype=np.int64)
    take = counts_c.copy()
    deep = counts_c > maxcov
    take[deep] = 0  # deep sites go through the seeded-downsampling loop
    nz = np.flatnonzero(take > 0)
    if len(nz):
        row = np.repeat(nz, take[nz])
        pos_in_row = _ragged_arange(take[nz])
        src = np.repeat(sc.indptr[cand_site_i[nz]].astype(np.int64),
                        take[nz]) + pos_in_row
        rid_mat[row, pos_in_row] = sc.rid[src]
        codes[row, pos_in_row, CENTER] = sc.code[src]
        read_mask[row, pos_in_row] = True
    sampled_depth = np.minimum(counts_c, maxcov).astype(np.int32)
    col_ref[:, CENTER] = ref_codes[cand_pos - scan_start]
    col_valid[:, CENTER] = True
    for i in np.flatnonzero(deep):
        # maxcov downsampling (deterministic, position-keyed)
        rids, ccodes = sc.at(cand_site_i[i])
        rng = np.random.default_rng((812 << 32) | int(cand_pos[i]))
        pick = rng.choice(len(rids), size=maxcov, replace=False)
        pick.sort()
        read_mask[i, :maxcov] = True
        rid_mat[i, :maxcov] = rids[pick]
        codes[i, :maxcov, CENTER] = ccodes[pick]

    # neighbor-column codes for all candidates in one (site, rid)-key
    # lookup: the SiteCodes triplets are sorted by (site, rid), so one
    # searchsorted over encoded keys replaces B×41 per-column queries
    nbr_valid = nbr_site_of_col >= 0
    if nbr_valid.any():
        n_reads = scan.rw.n_reads
        data_keys = sc.indexed_keys(n_reads)
        qi, qw = np.nonzero(nbr_valid)
        sites_q = nbr_site_of_col[qi, qw].astype(np.int64)
        col_ref[qi, qw] = ref_codes[scan.union_sites[sites_q] - scan_start]
        col_valid[qi, qw] = True
        rids_q = rid_mat[qi]  # (Q, Rmax)
        valid_r = rids_q >= 0
        flat = (sites_q[:, None] * n_reads + rids_q)[valid_r]
        pos = np.searchsorted(data_keys, flat)
        ok = pos < len(data_keys)
        ok[ok] = data_keys[pos[ok]] == flat[ok]
        vals = np.full(len(flat), 4, dtype=np.int8)
        vals[ok] = sc.code[pos[ok]]
        out_block = np.full(rids_q.shape, 4, dtype=np.int8)
        out_block[valid_r] = vals
        codes[qi[:, None], np.arange(Rmax)[None, :], qw[:, None]] = out_block

    return SnpBatch(
        contig=scan.contig,
        pos=cand_pos,
        codes=codes,
        read_mask=read_mask,
        col_ref=col_ref,
        col_valid=col_valid,
        center_ref=col_ref[:, CENTER].copy(),
        dp=scan.dp,
        freq=scan.freq,
        fwd_dp=scan.fwd_dp,
        rev_dp=scan.rev_dp,
        sampled_depth=sampled_depth,
        nbr_counts=scan.nbr_counts,
    )


@dataclass
class SnpChunkFeatures:
    """One chunk's observation payload (the per-chunk path).

    The interval + top-2-bitmask + exception/hole encoding of
    SnpGroupFeatures (whose docstring gives the cell-code semantics) over
    the chunk's own union sites and read ids, with the exceptions as a
    site CSR of (rid << 3) | code; the candidates' union-site indices and
    positions, the neighbor arrays the on-device band-quota selection
    reads (select_neighbors' twin), the deep rows' sampled read ids, and
    the host decode fields of SnpBatch.
    """

    contig: str
    read_lo: np.ndarray  # int32[N] first observed union-site index
    read_hi: np.ndarray  # int32[N] last observed union-site index (incl.)
    exc_packed: np.ndarray  # uint16|uint32[E] (rid << 3) | code
    exc_indptr: np.ndarray  # int32[S+1] CSR row pointers over union sites
    hole_site: np.ndarray  # int32[H] unobserved in-span (site, rid) pairs
    hole_rid: np.ndarray  # int32[H]
    site_ref: np.ndarray  # int8[S] reference code per union site
    site_major: np.ndarray  # int8[S] top-1 observed code per site
    site_minor: np.ndarray  # int8[S] top-2 observed code (== top-1 if none)
    minor_bits: np.ndarray  # uint8[ceil(total_span/8)]
    n_reads: int
    cand_site: np.ndarray  # int32[B] union-site index of the candidate
    cand_pos32: np.ndarray  # int32[B] 0-based genomic position
    nbr_pos: np.ndarray  # int32[M] sorted neighbor site positions
    nbr_union: np.ndarray  # int32[M] union-site index of each neighbor
    seq_type: str
    deep_idx: np.ndarray  # int64[Bd] candidate indices (sorted)
    deep_rids: np.ndarray  # int32[Bd, maxcov] sampled read ids (asc)
    # host-side decode fields (SnpBatch's)
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


# a chunk whose (S + 1) × N site × read table would exceed this many
# cells goes as the dense SnpBatch instead (the JAX package's cap on its
# dense device table, kept so that both packages choose the same path)
_TABLE_CELL_CAP = 1 << 27


def get_snp_chunk_features(
    bam,
    fasta,
    chunk,
    *,
    seq_type="ont",
    mincov=4,
    maxcov=160,
    min_allele_freq=0.15,
    min_nbr_sites=1,
    threshold=(0.4, 0.6),
    ploidy="diploid",
    exclude=None,
    rw: ReadWindow = None,
):
    """Scan one chunk and build its SnpChunkFeatures, or a dense SnpBatch
    when its site×read table would exceed _TABLE_CELL_CAP cells."""
    scan = _scan_chunk(
        bam, fasta, chunk, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
        min_allele_freq=min_allele_freq, min_nbr_sites=min_nbr_sites,
        threshold=threshold, ploidy=ploidy, exclude=exclude, rw=rw)
    if scan is None:
        return _empty_chunk_features(chunk["chrom"], maxcov)
    return _assemble_chunk_features(scan, maxcov, seq_type)


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


def _assemble_chunk_features(scan: SnpChunkScan, maxcov, seq_type):
    """SnpChunkFeatures from a completed scan, or its dense SnpBatch when
    the chunk's site×read table is over _TABLE_CELL_CAP cells."""
    sc = scan.sc
    S = len(scan.union_sites)
    n_reads = scan.rw.n_reads
    if (S + 1) * max(n_reads, 1) > _TABLE_CELL_CAP:
        return _assemble_dense(scan, maxcov)

    ev_dtype = np.uint16 if n_reads < (1 << 13) else np.uint32
    site_ref = scan.ref_codes[scan.union_sites - scan.scan_start].astype(
        np.int8)
    (read_lo, read_hi, site_major, site_minor, minor_bits,
     exc_site, exc_rid, exc_code, hole_site, hole_rid) = \
        _encode_interval_exceptions(sc, n_reads, S)
    exc_packed = ((exc_rid.astype(np.int64) << 3)
                  | exc_code.astype(np.int64)).astype(ev_dtype)
    exc_indptr = np.searchsorted(
        exc_site, np.arange(S + 1, dtype=np.int32)).astype(np.int32)
    counts_c = scan.counts_c
    deep_idx = np.flatnonzero(counts_c > maxcov)
    deep_rids = np.zeros((len(deep_idx), maxcov), np.int32)
    for k, i in enumerate(deep_idx):
        # the position-keyed RNG stream of the dense path, so both sample
        # the same reads
        lo = int(sc.indptr[scan.cand_site_i[i]])
        rng = np.random.default_rng((812 << 32) | int(scan.cand_pos[i]))
        pick = rng.choice(int(counts_c[i]), size=maxcov, replace=False)
        pick.sort()
        deep_rids[k] = sc.rid[lo + pick]

    return SnpChunkFeatures(
        contig=scan.contig,
        read_lo=read_lo,
        read_hi=read_hi,
        exc_packed=exc_packed,
        exc_indptr=exc_indptr,
        hole_site=hole_site,
        hole_rid=hole_rid,
        site_ref=site_ref,
        site_major=site_major,
        site_minor=site_minor,
        minor_bits=minor_bits,
        n_reads=n_reads,
        cand_site=scan.cand_site_i.astype(np.int32),
        cand_pos32=scan.cand_pos.astype(np.int32),
        nbr_pos=scan.nbr_pos.astype(np.int32),
        nbr_union=np.searchsorted(scan.union_sites,
                                  scan.nbr_pos).astype(np.int32),
        seq_type=seq_type,
        deep_idx=deep_idx,
        deep_rids=deep_rids,
        pos=scan.cand_pos,
        center_ref=site_ref[scan.cand_site_i].copy(),
        dp=scan.dp,
        freq=scan.freq,
        fwd_dp=scan.fwd_dp,
        rev_dp=scan.rev_dp,
        sampled_depth=np.minimum(counts_c, maxcov).astype(np.int32),
        nbr_counts=scan.nbr_counts,
        maxcov=maxcov,
    )


def get_snp_group_features(
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
    dedup=True,
):
    """Scan a group of adjacent chunks off one decoded window and build
    each member's own payload (SnpChunkFeatures, or the dense SnpBatch
    where dedup=False or the member is over _TABLE_CELL_CAP): the list,
    aligned with members, equals get_snp_chunk_features /
    get_snp_candidates chunk by chunk."""
    scans, _rw, _ref, _lo, _w = _scan_group(
        bam, fasta, members, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
        min_allele_freq=min_allele_freq, min_nbr_sites=min_nbr_sites,
        threshold=threshold, exclude=exclude)
    out = []
    for m, scan in zip(members, scans):
        if scan is None:
            out.append(_empty_chunk_features(m["chrom"], maxcov) if dedup
                       else _empty_batch(m["chrom"]))
        elif not dedup:
            out.append(_assemble_dense(scan, maxcov))
        else:
            out.append(_assemble_chunk_features(scan, maxcov, seq_type))
    return out


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
    """Scan a group off one decoded window and build its payloads, in
    member order: SnpGroupFeatures, whose members are (member dict,
    SnpGroupMember or None), or (member dict, SnpChunkFeatures |
    SnpBatch) for a member over the payload caps on its own.

    One payload for the whole group, or — where it is over the payload
    caps or its neighbor lists fail the cross-check — one single-member
    payload per member, built from that member's own scan (its reads,
    id space and sites are a standalone scan's), which the caller sends
    through the same group path. A member that is itself over the caps
    comes back as the JAX package's per-member fallback builds it
    (_assemble_chunk_features of its scan). A group without candidates
    gives one payload of empty members."""
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
        out.append(one if one is not None else
                   (m, _assemble_chunk_features(scan, maxcov, seq_type)))
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


def _empty_chunk_features(contig, maxcov):
    i32 = lambda: np.zeros(0, np.int32)
    i8 = lambda: np.zeros(0, np.int8)
    return SnpChunkFeatures(
        contig=contig, read_lo=i32(), read_hi=i32(),
        exc_packed=np.zeros(0, np.uint16), exc_indptr=np.zeros(1, np.int32),
        hole_site=i32(), hole_rid=i32(), site_ref=i8(), site_major=i8(),
        site_minor=i8(), minor_bits=np.zeros(0, np.uint8), n_reads=0,
        cand_site=i32(), cand_pos32=i32(), nbr_pos=i32(), nbr_union=i32(),
        seq_type="ont", deep_idx=np.zeros(0, np.int64),
        deep_rids=np.zeros((0, maxcov), np.int32), pos=np.zeros(0, np.int64),
        center_ref=i8(), dp=i32(), freq=np.zeros(0, np.float32),
        fwd_dp=np.zeros((0, 4), np.int32), rev_dp=np.zeros((0, 4), np.int32),
        sampled_depth=i32(), nbr_counts=i32(), maxcov=maxcov)


def _empty_batch(contig):
    return SnpBatch(
        contig=contig, pos=np.zeros(0, np.int64),
        codes=np.zeros((0, 1, WIDTH), np.int8),
        read_mask=np.zeros((0, 1), bool),
        col_ref=np.zeros((0, WIDTH), np.int8),
        col_valid=np.zeros((0, WIDTH), bool),
        center_ref=np.zeros(0, np.int8), dp=np.zeros(0, np.int32),
        freq=np.zeros(0, np.float32), fwd_dp=np.zeros((0, 4), np.int32),
        rev_dp=np.zeros((0, 4), np.int32),
        sampled_depth=np.zeros(0, np.int32),
        nbr_counts=np.zeros(0, np.int32))
