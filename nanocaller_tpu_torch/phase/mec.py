"""Weighted-MEC read-based phasing of heterozygous SNPs.

Replaces `whatshap phase` + `whatshap haplotag`
(indelCaller.py:238,243-251): builds the het-SNP × read allele matrix
from the already-decoded pileup (no BAM round-trip), partitions sites
into phase blocks (connected components via shared reads), seeds each
block with adjacent-pair cis/trans majority votes, then refines with
alternating read-assignment / site-flip passes (MEC descent). Phase-set
IDs follow the WhatsHap convention: PS = position (1-based) of the
block's first variant.

`--enable_whatshap` (whatshap's `--distrust-genotypes
--include-homozygous`, indelCaller.py:228) is reproduced as a
post-phasing regenotyping pass: with the MEC read partition fixed,
each site's genotype is re-scored against the per-haplotype allele
support — hets may collapse to hom (0/0 results are dropped from the
phased VCF, matching the reference's `bcftools view -e 'GT="0\\0"'`,
indelCaller.py:241) and hom-alt calls may open up to phased hets.
The decision rule follows whatshap's wMEC genotype-cost formulation:
each read observation carries a phred weight w = 10*log10((1-eps)/eps)
(eps = per-base error rate), and a genotype flips only when the read
evidence advantage (mismatch-count delta x w) exceeds the cost of
changing the genotype. The input VCF here is NanoCaller's, whose FORMAT
is GT:DP:VF:AD:ADF:ADR (snpCaller.py:135-197) — no GL/PL — so whatshap
prices every genotype change at its constant `--default-gq` (30 phred);
we match that exactly (default_gq parameter, default 30.0).

A copy of nanocaller_tpu/phase/mec.py on the port's own pileup and VCF
modules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..pileup.engine import SiteCodes

_BASE_CODE = {"A": 0, "G": 1, "T": 2, "C": 3}


@dataclass
class PhaseResult:
    # per input het site (parallel arrays)
    site_pos: np.ndarray  # int64, 0-based
    hap_allele: np.ndarray  # int8: allele (0=ref,1=alt) on haplotype 1
    block_ps: np.ndarray  # int64: 1-based PS id; -1 if unphased
    # per read
    read_hp: np.ndarray  # int8: 0 untagged, 1, 2
    read_ps: np.ndarray  # int64: -1 or PS
    n_blocks: int = 0
    mec_cost: int = 0


def build_allele_matrix(rw, sites_pos0, ref_codes, alt_codes):
    """Sparse read-allele observations at het sites.

    Returns (rids int32[K], site_idx int32[K], allele int8[K]) keeping
    only observations matching ref (0) or alt (1)."""
    sc = SiteCodes(rw, sites_pos0)
    rid_l, sidx_l, al_l = [], [], []
    for j in range(len(sites_pos0)):
        rids, codes = sc.at(j)
        is_ref = codes == ref_codes[j]
        is_alt = codes == alt_codes[j]
        keep = is_ref | is_alt
        rid_l.append(rids[keep])
        sidx_l.append(np.full(int(keep.sum()), j, np.int32))
        al_l.append(is_alt[keep].astype(np.int8))
    if not rid_l:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int8))
    return (np.concatenate(rid_l), np.concatenate(sidx_l), np.concatenate(al_l))


def phase_sites(rw, sites_pos0, ref_codes, alt_codes, n_iter=8, exact=True,
                cell_budget=None, n_threads=None):
    """Core MEC phasing. Returns PhaseResult."""
    rids, sidx, alleles = build_allele_matrix(rw, sites_pos0, ref_codes, alt_codes)
    return phase_obs(rids, sidx, alleles, rw.n_reads, sites_pos0,
                     n_iter=n_iter, exact=exact, cell_budget=cell_budget,
                     n_threads=n_threads)


def phase_obs(rids, sidx, alleles, n_reads, sites_pos0, n_iter=8, exact=True,
              cell_budget=None, n_threads=None):
    """phase_sites on pre-built sparse observations (also the entry the
    wMEC differential harness drives on synthetic instances).

    exact=True (production default) refines each block's haplotype with
    the exact wMEC DP over coverage-selected reads (phase/wmec.py,
    whatshap's algorithm); the descent+switch-repair heuristic remains
    both the seed and the guaranteed-never-worse fallback."""
    S = len(sites_pos0)

    # per-read site lists (CSR by read)
    order = np.lexsort((sidx, rids))
    rids, sidx, alleles = rids[order], sidx[order], alleles[order]
    r_ptr = np.searchsorted(rids, np.arange(n_reads + 1, dtype=rids.dtype))
    obs_per_read = np.diff(r_ptr)

    # adjacent observation pairs within each read (vectorized)
    same_read = np.zeros(max(0, len(rids) - 1), dtype=bool)
    if len(rids) > 1:
        same_read = rids[1:] == rids[:-1]
    pa = sidx[:-1][same_read].astype(np.int64)
    pb = sidx[1:][same_read].astype(np.int64)
    trans = (alleles[:-1][same_read] != alleles[1:][same_read]).astype(np.int64)
    keep = pa != pb
    pa, pb, trans = pa[keep], pb[keep], trans[keep]

    # connected components over sites linked by adjacent pairs
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    if len(pa):
        g = sp.coo_matrix((np.ones(len(pa)), (pa, pb)), shape=(S, S))
        _, comp = csgraph.connected_components(g, directed=False)
    else:
        comp = np.arange(S)
    comp = comp.astype(np.int64)

    # adjacent-pair cis/trans votes to seed haplotype orientation.
    # Consecutive-site pairs (pb == pa+1) dominate overwhelmingly and
    # get dense bincount arrays; the rare skipping pairs go through the
    # np.unique dict (sorting all ~3M pair encodings costs seconds on a
    # whole-contig window).
    h = np.zeros(S, dtype=np.int8)
    pair_votes = {}
    cis1 = trs1 = None
    if len(pa):
        d1 = (pb - pa) == 1
        cis1 = np.bincount(pa[d1], weights=1 - trans[d1], minlength=S)
        trs1 = np.bincount(pa[d1], weights=trans[d1], minlength=S)
        rest = ~d1
        if rest.any():
            enc = pa[rest] * S + pb[rest]
            uniq, inv = np.unique(enc, return_inverse=True)
            cis = np.bincount(inv, weights=1 - trans[rest],
                              minlength=len(uniq))
            trs = np.bincount(inv, weights=trans[rest], minlength=len(uniq))
            pair_votes = {int(e): (c, t) for e, c, t in zip(uniq, cis, trs)}
    # propagate along position order within component
    by_comp = {}
    for j in range(S):
        by_comp.setdefault(int(comp[j]), []).append(j)
    for members in by_comp.values():
        members.sort()
        for a, b in zip(members[:-1], members[1:]):
            if b == a + 1 and cis1 is not None:
                votes = (cis1[a], trs1[a])
            else:
                votes = pair_votes.get(a * S + b)
            o = 1 if votes is not None and votes[1] > votes[0] else 0
            h[b] = h[a] ^ o

    # refinement: alternate read assignment and site flips (vectorized)
    read_hp = np.zeros(n_reads, dtype=np.int8)
    for _ in range(n_iter):
        mism = (alleles != h[sidx]).astype(np.int64)
        mis1 = np.bincount(rids, weights=mism, minlength=n_reads)
        mis2 = obs_per_read - mis1
        new_hp = np.where(mis1 < mis2, 1,
                          np.where(mis2 < mis1, 2, 0)).astype(np.int8)
        new_hp[obs_per_read == 0] = 0
        changed = not np.array_equal(new_hp, read_hp)
        read_hp = new_hp
        # site flips: majority vote of assigned reads
        # evidence for h[j]=1: hap-1 reads showing alt, hap-2 reads showing ref
        v0 = np.zeros(S, np.int32)
        v1 = np.zeros(S, np.int32)
        m = read_hp[rids] == 1
        np.add.at(v1, sidx[m & (alleles == 1)], 1)
        np.add.at(v0, sidx[m & (alleles == 0)], 1)
        m2 = read_hp[rids] == 2
        np.add.at(v1, sidx[m2 & (alleles == 0)], 1)
        np.add.at(v0, sidx[m2 & (alleles == 1)], 1)
        new_h = np.where(v1 > v0, 1, np.where(v0 > v1, 0, h)).astype(np.int8)
        if not changed and np.array_equal(new_h, h):
            break
        h = new_h

    # switch repair: greedy suffix flips close most of the remaining gap
    # to the exact wMEC optimum (the descent's residual errors are
    # switch errors)
    h = _switch_repair(rids, sidx, alleles, h, r_ptr)
    if exact:
        # per-block exact wMEC over coverage-selected reads; adopted only
        # when strictly better on the all-reads objective
        from .wmec import exact_refine

        kw = {} if cell_budget is None else {"cell_budget": cell_budget}
        h = exact_refine(rids, sidx, alleles, S, comp, h,
                         n_threads=n_threads, **kw)
    # re-derive the read assignment for the repaired haplotype
    mism = (alleles != h[sidx]).astype(np.int64)
    mis1 = np.bincount(rids, weights=mism, minlength=n_reads)
    mis2 = obs_per_read - mis1
    read_hp = np.where(mis1 < mis2, 1,
                       np.where(mis2 < mis1, 2, 0)).astype(np.int8)
    read_hp[obs_per_read == 0] = 0

    # blocks: only components with ≥2 sites are phased
    block_ps = np.full(S, -1, dtype=np.int64)
    sizes = {}
    for j in range(S):
        sizes[int(comp[j])] = sizes.get(int(comp[j]), 0) + 1
    ps_of_comp = {}
    for c, members in by_comp.items():
        if sizes[c] >= 2:
            ps_of_comp[c] = int(sites_pos0[min(members)]) + 1
    for j in range(S):
        c = int(comp[j])
        if c in ps_of_comp:
            block_ps[j] = ps_of_comp[c]

    # per-read PS: block of its first phased site (vectorized first-
    # valid-observation lookup via minimum.reduceat over the read CSR)
    read_ps = np.full(n_reads, -1, dtype=np.int64)
    if len(sidx):
        obs_ps = block_ps[sidx]
        k_idx = np.where(obs_ps >= 0, np.arange(len(sidx)), len(sidx))
        nonempty = r_ptr[:-1] < r_ptr[1:]
        first = np.full(n_reads, len(sidx), dtype=np.int64)
        first[nonempty] = np.minimum.reduceat(
            k_idx, r_ptr[:-1][nonempty])
        tagged = (read_hp != 0) & nonempty
        found = tagged & (first < len(sidx))
        read_ps[found] = obs_ps[first[found]]
        read_hp[tagged & ~found] = 0

    mism = alleles != h[sidx]
    hp_of_obs = read_hp[rids]
    mec = int(((hp_of_obs == 1) & mism).sum() + ((hp_of_obs == 2) & ~mism).sum())
    return PhaseResult(site_pos=np.asarray(sites_pos0), hap_allele=h,
                       block_ps=block_ps, read_hp=read_hp, read_ps=read_ps,
                       n_blocks=len(ps_of_comp), mec_cost=mec)


def _switch_repair(rids, sidx, alleles, h, r_ptr, max_flips=50):
    """Greedy suffix-flip repair of the MEC haplotype.

    The alternating descent's residual errors are almost entirely switch
    errors (a suffix of the block on the wrong orientation). For every
    boundary b, the cost delta of flipping h[b:] under per-read optimal
    reassignment is computable in O(K) for all b at once: only reads
    spanning b change cost, and a read's new mismatch count is
    2·pre(b) + T_post(b) − M_r (pre = mismatches before b). Deltas are
    accumulated as a difference array over boundaries; each scan applies
    every negative-delta flip whose boundary is farther than the longest
    read span from the previously applied one (such flips cannot
    interact), so whole-contig repair converges in a handful of O(K)
    scans. Every applied flip strictly lowers the wMEC objective, so
    this terminates."""
    K = len(rids)
    if K == 0:
        return h
    S = len(h)
    h = h.copy()
    obs_per_read = np.diff(r_ptr)
    read_start_of_obs = np.repeat(r_ptr[:-1], obs_per_read)
    local_i = np.arange(K) - read_start_of_obs  # obs index within read
    not_last = np.ones(K, dtype=bool)
    not_last[r_ptr[1:] - 1] = False  # last obs of each read
    nxt_site = np.empty(K, np.int64)
    nxt_site[:-1] = sidx[1:]
    nxt_site[-1] = 0
    # longest read span in site-index space bounds flip interaction
    # (observations are (rid, sidx)-sorted here, so per-read span is an
    # O(1) slice through r_ptr — no scatter-reduce)
    span = 0
    if K:
        nz = obs_per_read > 0
        if nz.any():
            f = sidx[r_ptr[:-1][nz]]
            l = sidx[r_ptr[1:][nz] - 1]
            span = int((l - f).max()) + 1

    for _ in range(max_flips):
        mism = (alleles != h[sidx]).astype(np.int64)
        cm = np.cumsum(mism)
        seg_cum = cm - np.concatenate([[0], cm])[read_start_of_obs]
        M_r = np.bincount(rids, weights=mism, minlength=len(r_ptr) - 1)
        T_r = obs_per_read
        cur_min = np.minimum(M_r, T_r - M_r)
        # per non-last obs i: boundary range (sidx[i], nxt_site[i]]
        i = np.flatnonzero(not_last)
        r = rids[i]
        pre = seg_cum[i]
        T_post = T_r[r] - (local_i[i] + 1)
        new_mis = 2 * pre + T_post - M_r[r]
        # all terms are exact small-integer counts (bincount returns
        # float64); cast back so the int64 difference array is explicit
        contrib = (np.minimum(new_mis, T_r[r] - new_mis)
                   - cur_min[r]).astype(np.int64)
        # difference array via two bincounts (np.add.at is ~10x slower
        # on millions of scattered indices). bincount accumulates the
        # float64 weights exactly while every partial sum stays under
        # 2^53; sum(|contrib|) bounds all of them, so guard it and fall
        # back to the exact int64 scatter-add on pathological instances
        # (integer tie rules are pinned by the brute-force differential)
        if np.abs(contrib).sum() < (1 << 52):
            D = np.bincount(sidx[i] + 1, weights=contrib, minlength=S + 2)
            D -= np.bincount(nxt_site[i] + 1, weights=contrib,
                             minlength=S + 2)
            delta = np.cumsum(D[: S + 1]).astype(np.int64)
        else:
            D = np.zeros(S + 2, np.int64)
            np.add.at(D, sidx[i] + 1, contrib)
            np.subtract.at(D, nxt_site[i] + 1, contrib)
            delta = np.cumsum(D[: S + 1])
        neg = np.flatnonzero(delta < 0)
        if not len(neg):
            break
        # one candidate per contiguous negative run (its argmin), then
        # apply non-interacting flips, most negative first
        runs = np.split(neg, np.flatnonzero(np.diff(neg) > 1) + 1)
        cands = np.array([r[np.argmin(delta[r])] for r in runs])
        order = cands[np.argsort(delta[cands], kind="stable")]
        picked = []
        for b in order:
            if all(abs(b - p) > span for p in picked):
                picked.append(int(b))
        flip_par = np.zeros(S + 1, np.int8)
        flip_par[picked] = 1
        parity = np.cumsum(flip_par)[:S] & 1
        h ^= parity.astype(h.dtype)
    return h


_REGENOTYPE_EPS = 0.1  # per-base error rate for observation weights
# (ONT-scale; one matching observation is worth w = 10*log10((1-eps)/eps)
# ≈ 9.5 phred of evidence — whatshap's wMEC read weight with flat quals)
_DEFAULT_GQ = 30.0  # whatshap --default-gq: genotype-change cost when the
# VCF has no GL/PL (NanoCaller's never does, snpCaller.py:135-197)


def _obs_weight(eps):
    return 10.0 * np.log10((1.0 - eps) / eps)


def _hap_support(rw, result: PhaseResult, pos, refc, altc):
    """Per-site ref/alt observation counts split by read haplotype.

    Returns (c1r, c1a, c2r, c2a, cur, cua) int32 arrays over the given
    sites: counts from reads the phaser assigned to haplotype 1 or 2,
    plus the untagged (ambiguous-assignment) reads' ref/alt counts."""
    S = len(pos)
    rids, sidx, alleles = build_allele_matrix(rw, pos, refc, altc)
    hp = result.read_hp[rids]
    out = []
    for hsel in (1, 2, 0):
        for asel in (0, 1):
            c = np.zeros(S, np.int32)
            np.add.at(c, sidx[(hp == hsel) & (alleles == asel)], 1)
            out.append(c)
    return tuple(out)  # c1r, c1a, c2r, c2a, cur, cua


def regenotype(rw, result: PhaseResult, het_pos, het_ref, het_alt,
               hom_pos, hom_ref, hom_alt, eps=_REGENOTYPE_EPS,
               default_gq=_DEFAULT_GQ):
    """Distrust-genotypes pass: re-score genotypes under the fixed read
    partition (whatshap --distrust-genotypes --include-homozygous
    equivalent, indelCaller.py:228).

    Decision rule (whatshap's wMEC genotype-change cost): a genotype
    flips only when the read-evidence advantage of the new genotype,
    (mismatch_old - mismatch_new) * w with w = 10*log10((1-eps)/eps)
    phred per observation, exceeds the cost of changing the genotype.
    The reference feeds whatshap a VCF with no GL/PL fields
    (snpCaller.py:135-197), so whatshap prices every change at its
    constant --default-gq (30 phred) — matched here by `default_gq`.
    Untagged reads count toward hom mismatches (every observation is
    evidence) but are free under het genotypes (an ambiguous read can
    always sit on the haplotype matching its allele).

    Returns {pos1: new_entry} only for CHANGED sites, where new_entry is
    "0/0" / "1/1" (het collapsed to hom, unphased) or ("0|1"/"1|0", ps)
    (hom-alt opened to a phased het)."""
    w = _obs_weight(eps)
    changes = {}
    if len(het_pos):
        c1r, c1a, c2r, c2a, cur, cua = _hap_support(
            rw, result, het_pos, het_ref, het_alt)
        cost_het = np.minimum(c1r + c2a, c1a + c2r)
        cost_hr = c1a + c2a + cua
        cost_ha = c1r + c2r + cur
        for j in range(len(het_pos)):
            best_hom = min(cost_hr[j], cost_ha[j])
            if (cost_het[j] - best_hom) * w > default_gq:
                changes[int(het_pos[j]) + 1] = (
                    "0/0" if cost_hr[j] <= cost_ha[j] else "1/1")
    if len(hom_pos):
        c1r, c1a, c2r, c2a, cur, cua = _hap_support(
            rw, result, hom_pos, hom_ref, hom_alt)
        # orientation 1 = hap1 carries alt
        cost_o1 = c1r + c2a
        cost_o0 = c1a + c2r
        cost_het = np.minimum(cost_o1, cost_o0)
        cost_hom = c1r + c2r + cur  # current genotype 1/1
        for j in range(len(hom_pos)):
            if (cost_hom[j] - cost_het[j]) * w <= default_gq:
                continue
            # PS of the supporting reads' block
            ps = _majority_ps(rw, result, int(hom_pos[j]))
            if ps < 0:
                continue
            gt = "1|0" if cost_o1[j] <= cost_o0[j] else "0|1"
            changes[int(hom_pos[j]) + 1] = (gt, ps)
    return changes


def _majority_ps(rw, result: PhaseResult, pos0):
    """Most common phase set among haplotagged reads covering pos0."""
    cover = (rw.read_start <= pos0) & (rw.read_end > pos0) & \
            (result.read_hp != 0)
    ps_vals = result.read_ps[cover]
    ps_vals = ps_vals[ps_vals >= 0]
    if len(ps_vals) == 0:
        return -1
    vals, counts = np.unique(ps_vals, return_counts=True)
    return int(vals[np.argmax(counts)])


def _collect_biallelic(records, want_gts):
    """(pos0, ref_code, alt_code) of the biallelic SNP records whose GT
    is in want_gts, position-sorted. (QUAL is deliberately not
    collected: the phasing cost model prices genotype changes at the
    constant --default-gq.)"""
    pos, refc, altc = [], [], []
    for rec in records:
        gt = rec.sample_field("GT")
        if gt not in want_gts:
            continue
        if len(rec.ref) != 1 or "," in rec.alt or len(rec.alt) != 1:
            continue
        if rec.ref not in _BASE_CODE or rec.alt not in _BASE_CODE:
            continue
        pos.append(rec.pos - 1)
        refc.append(_BASE_CODE[rec.ref])
        altc.append(_BASE_CODE[rec.alt])
    if not pos:
        return (np.zeros(0, np.int64), np.zeros(0, np.int8),
                np.zeros(0, np.int8))
    order = np.argsort(pos)
    return (np.asarray(pos, np.int64)[order],
            np.asarray(refc, np.int8)[order],
            np.asarray(altc, np.int8)[order])


def phase_contig(records, rw, distrust=False, default_gq=_DEFAULT_GQ,
                 cell_budget=None, n_threads=None):
    """Phase the biallelic het SNPs of one contig.

    records: list of VcfRecord (the high-QUAL SNP calls). Returns
    (PhaseResult, phase_map {pos1: entry}) where entry is (gt, ps) for
    phased sites — '0|1' (hap1 carries ref) or '1|0' — or, when
    distrust=True changed a genotype, the bare string "0/0"/"1/1".

    distrust=True (whatshap --distrust-genotypes --include-homozygous,
    indelCaller.py:228) re-types genotypes JOINTLY inside the per-block
    exact wMEC DP (phase/wmec.phase_distrust) — whatshap's actual
    formulation; the post-hoc `regenotype` pass below remains as its
    differential twin for tests."""
    pos, refc, altc = _collect_biallelic(
        records, ("0/1", "0|1", "1/0", "1|0"))
    if not len(pos):
        empty = PhaseResult(
            site_pos=np.zeros(0, np.int64), hap_allele=np.zeros(0, np.int8),
            block_ps=np.zeros(0, np.int64),
            read_hp=np.zeros(rw.n_reads, np.int8),
            read_ps=np.full(rw.n_reads, -1, np.int64))
        return empty, {}
    if distrust:
        from .wmec import phase_distrust

        hpos, href, halt = _collect_biallelic(records, ("1/1", "1|1"))
        kw = {} if cell_budget is None else {"cell_budget": cell_budget}
        return phase_distrust(rw, pos, refc, altc, hpos, href, halt,
                              default_gq=default_gq, **kw)
    result = phase_sites(rw, pos, refc, altc, cell_budget=cell_budget,
                         n_threads=n_threads)
    phase_map = {}
    for j in range(len(pos)):
        if result.block_ps[j] >= 0:
            gt = "1|0" if result.hap_allele[j] == 1 else "0|1"
            phase_map[int(pos[j]) + 1] = (gt, int(result.block_ps[j]))
    return result, phase_map


def haplotag_reads(rw, result: PhaseResult):
    """{qname: (hp, ps)} for tagged reads (whatshap haplotag equivalent)."""
    out = {}
    for r in range(rw.n_reads):
        if result.read_hp[r]:
            out[rw.qnames[r]] = (int(result.read_hp[r]), int(result.read_ps[r]))
    return out


def write_phased_vcf(src_reader, dst_path, phase_map):
    """Copy a SNP VCF, rewriting phased het GTs and adding PS
    (whatshap phase output contract). Entries that are bare GT strings
    come from the distrust-genotypes pass: the GT is replaced without a
    PS, and genotypes collapsed to 0/0 are dropped entirely (matching
    the reference's bcftools view -e 'GT="0\\0"', indelCaller.py:241)."""
    from ..io.vcf import VcfWriter

    headers = list(src_reader.header_lines)
    fmt_line = '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set identifier">'
    if fmt_line not in headers:
        headers.insert(len(headers) - 1, fmt_line)
    with VcfWriter(dst_path, headers) as w:
        for rec in src_reader:
            entry = phase_map.get(rec.pos)
            if entry is not None:
                if isinstance(entry, str):
                    gt, ps = entry, None
                else:
                    gt, ps = entry
                if gt == "0/0":
                    continue
                keys = rec.format.split(":")
                vals = rec.samples[0].split(":")
                vals[keys.index("GT")] = gt
                if ps is not None:
                    keys.append("PS")
                    vals.append(str(ps))
                rec.format = ":".join(keys)
                rec.samples = [":".join(vals)]
            w.write(rec)
    return dst_path
