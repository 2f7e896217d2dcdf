"""Exact weighted-MEC phasing oracle (whatshap's core DP).

`whatshap phase` (used by NanoCaller at indelCaller.py:228,238) solves weighted
Minimum Error Correction exactly with the fixed-parameter DP of
Patterson et al. 2015 (J Comp Biol 22(6), the WhatsHap algorithm):
process het sites in position order; the DP state at site j is the
bipartition (bitmask) of the reads *active* at j (first-obs ≤ j ≤
last-obs); the column cost of a bipartition is, for each side, the
cheaper of flipping all its REF or all its ALT observations; transitions
require agreement on reads shared by consecutive columns. Exponential
only in the coverage of multi-site reads, which whatshap bounds by read
selection (default 15).

This module is the slow, exact test oracle used to measure how far the
production heuristic (phase/mec.py: seeded alternating MEC descent)
lands from the true wMEC optimum. It is pure numpy + dict DP,
deliberately simple; production never calls it (a copy of
nanocaller_tpu/phase/wmec_oracle.py; phase/wmec.py uses its `cost_of_h`
and `_active_sweep`).
"""

from __future__ import annotations

import numpy as np

from .mec import PhaseResult, build_allele_matrix


def wmec_exact(rids, sidx, alleles, n_sites, weights=None, max_active=18):
    """Exact weighted-MEC over sparse observations.

    rids/sidx/alleles: parallel arrays of read id, site index (0..S-1,
    sites in position order), allele (0/1). weights: per-observation
    float (default 1.0). Reads with <2 observations are ignored (they
    never change the optimal bipartition; whatshap likewise phases on
    multi-site reads only).

    Returns (cost, h, part) where h is int8[S] (allele on haplotype 1 at
    each site; 0 where no evidence), part maps read id -> 0/1 for every
    multi-site read (labels arbitrary up to global flip per connected
    block).
    """
    rids = np.asarray(rids)
    sidx = np.asarray(sidx)
    alleles = np.asarray(alleles)
    if weights is None:
        weights = np.ones(len(rids), np.float64)
    weights = np.asarray(weights, np.float64)

    # keep multi-site reads only, renumber 0..R-1
    uniq, inv, cnt = np.unique(rids, return_inverse=True, return_counts=True)
    keep = (cnt >= 2)[inv]
    rids_k = inv[keep]
    multi = np.flatnonzero(cnt >= 2)
    remap = -np.ones(len(uniq), np.int64)
    remap[multi] = np.arange(len(multi))
    rr = remap[rids_k]
    ss = sidx[keep].astype(np.int64)
    aa = alleles[keep].astype(np.int64)
    ww = weights[keep]
    R = len(multi)
    if R == 0:
        return 0.0, np.zeros(n_sites, np.int8), {}

    first = np.full(R, n_sites, np.int64)
    last = np.full(R, -1, np.int64)
    np.minimum.at(first, rr, ss)
    np.maximum.at(last, rr, ss)

    # per-site observation lists
    obs_at = [[] for _ in range(n_sites)]  # (read, allele, weight)
    for r, s, a, w in zip(rr, ss, aa, ww):
        obs_at[int(s)].append((int(r), int(a), float(w)))

    active_lists = _active_sweep(first, last, n_sites)
    prev_active: list[int] = []
    prev_dp = np.zeros(1, np.float64)  # dp over all masks of prev column
    # trellis[j] = (active list, parent int64[2^A] into prev column masks)
    trellis = []
    dp = prev_dp
    for j in range(n_sites):
        active = active_lists[j]
        A = len(active)
        if A > max_active:
            raise ValueError(
                f"active coverage {A} at site {j} exceeds "
                f"max_active={max_active}; downsample reads first")
        masks = np.arange(1 << A, dtype=np.int64)
        # indices of shared reads in prev/cur active lists
        pos_prev = {r: i for i, r in enumerate(prev_active)}
        shared = [(pos_prev[r], i) for i, r in enumerate(active)
                  if r in pos_prev]
        # best previous cost per projection key over shared reads
        nkeys = 1 << len(shared)
        pkeys = np.zeros(len(prev_dp), np.int64)
        for k, (pi, _ci) in enumerate(shared):
            pkeys |= (((np.arange(len(prev_dp), dtype=np.int64) >> pi) & 1)
                      << k)
        best_cost = np.full(nkeys, np.inf)
        np.minimum.at(best_cost, pkeys, prev_dp)
        # argmin previous mask per key (first mask achieving best_cost)
        hit = prev_dp == best_cost[pkeys]
        best_mask = np.full(nkeys, -1, np.int64)
        idx = np.flatnonzero(hit)
        np.maximum.at(best_mask, pkeys[idx[::-1]], idx[::-1])
        # column cost per mask
        col = obs_at[j]
        ai = {r: i for i, r in enumerate(active)}
        w_s1 = [np.zeros(len(masks)), np.zeros(len(masks))]  # side1, by allele
        tot = [0.0, 0.0]
        for r, a, w in col:
            bit = ((masks >> ai[r]) & 1).astype(np.float64)
            w_s1[a] = w_s1[a] + w * bit
            tot[a] += w
        w_s0 = [tot[0] - w_s1[0], tot[1] - w_s1[1]]
        # genotypes are fixed het (the reference phases called het SNPs),
        # so the two haplotypes are complementary at every site: cost is
        # the cheaper of the two orientations
        ccost = np.minimum(w_s0[1] + w_s1[0], w_s0[0] + w_s1[1])
        # current-mask projection keys
        ckeys = np.zeros(len(masks), np.int64)
        for k, (_pi, ci) in enumerate(shared):
            ckeys |= ((masks >> ci) & 1) << k
        dp = best_cost[ckeys] + ccost
        trellis.append((active, best_mask[ckeys]))
        prev_active = active
        prev_dp = dp

    # backtrack
    part: dict[int, int] = {}
    j = n_sites - 1
    mask = int(np.argmin(dp))
    total = float(dp[mask])
    while j >= 0:
        active, parent = trellis[j]
        for i, r in enumerate(active):
            part[int(multi[r])] = (mask >> i) & 1
        mask = int(parent[mask])
        j -= 1

    # haplotype alleles from the partition: per site, the cheaper of the
    # two complementary orientations (side0=REF/side1=ALT or the flip)
    h = np.zeros(n_sites, np.int8)
    for j in range(n_sites):
        w = np.zeros((2, 2))  # [side][allele]
        for r, a, ww_ in obs_at[j]:
            w[part.get(int(multi[r]), 0), a] += ww_
        # orientation side0=0: errors are side0 alt obs + side1 ref obs
        if w[0, 1] + w[1, 0] > w[0, 0] + w[1, 1]:
            h[j] = 1
    return float(total), h, part


def cost_of_h(rids, sidx, alleles, h, weights=None):
    """Weighted MEC cost of a haplotype vector h under the read-optimal
    assignment: Σ_r min(d(r, h), d(r, ~h)). Given h, each read
    independently picks its better side, so this is THE objective both
    the heuristic and the exact DP minimize over h — the fair yardstick
    for comparing the two (single-observation reads contribute 0)."""
    if weights is None:
        weights = np.ones(len(rids), np.float64)
    weights = np.asarray(weights, np.float64)
    rids = np.asarray(rids)
    h = np.asarray(h)
    if len(rids) == 0:
        return 0.0
    n = int(rids.max()) + 1
    mism = (np.asarray(alleles) != h[np.asarray(sidx)]).astype(np.float64)
    d1 = np.bincount(rids, weights * mism, minlength=n)
    d2 = np.bincount(rids, weights * (1.0 - mism), minlength=n)
    return float(np.minimum(d1, d2).sum())


def phase_sites_exact(rw, sites_pos0, ref_codes, alt_codes, max_active=18):
    """PhaseResult-compatible exact phasing (oracle twin of
    mec.phase_sites) so downstream consumers (haplotagging, regenotype)
    can run against the exact partition in differential tests."""
    S = len(sites_pos0)
    rids, sidx, alleles = build_allele_matrix(
        rw, sites_pos0, ref_codes, alt_codes)
    cost, h, part = wmec_exact(rids, sidx, alleles, S,
                               max_active=max_active)

    # blocks: connected components via multi-site reads (same convention
    # as the heuristic: ≥2 sites)
    comp = np.arange(S, dtype=np.int64)

    def find(x):
        while comp[x] != x:
            comp[x] = comp[comp[x]]
            x = comp[x]
        return x

    order = np.lexsort((sidx, rids))
    for k in range(1, len(order)):
        if rids[order[k]] == rids[order[k - 1]]:
            a, b = find(int(sidx[order[k - 1]])), find(int(sidx[order[k]]))
            if a != b:
                comp[max(a, b)] = min(a, b)
    roots = np.array([find(j) for j in range(S)], np.int64)
    block_ps = np.full(S, -1, np.int64)
    sizes = np.bincount(roots, minlength=S)
    for j in range(S):
        r = roots[j]
        if sizes[r] >= 2:
            block_ps[j] = int(sites_pos0[r]) + 1

    # read assignment: multi-site reads from the DP partition; single-
    # site reads by their observation vs h (whatshap haplotag behavior)
    read_hp = np.zeros(rw.n_reads, np.int8)
    read_ps = np.full(rw.n_reads, -1, np.int64)
    for r, side in part.items():
        read_hp[r] = 1 if side == 0 else 2
    for k in range(len(rids)):
        r = int(rids[k])
        if read_hp[r] == 0:
            read_hp[r] = 1 if alleles[k] == h[sidx[k]] else 2
        if read_ps[r] < 0 and block_ps[sidx[k]] >= 0:
            read_ps[r] = block_ps[sidx[k]]
    read_hp[read_ps < 0] = 0

    n_blocks = len({int(b) for b in block_ps if b >= 0})
    mec = cost_of_h(rids, sidx, alleles, h)
    return PhaseResult(site_pos=np.asarray(sites_pos0), hap_allele=h,
                       block_ps=block_ps, read_hp=read_hp, read_ps=read_ps,
                       n_blocks=n_blocks, mec_cost=int(mec)), cost


def _active_sweep(first, last, n_sites):
    """Per-column active read lists via an incremental sweep.

    Equivalent to `[r for r in range(R) if first[r] <= j <= last[r]]`
    per column but O(sites + reads·span) instead of O(sites × reads) —
    the naive rebuild dominated whole-contig phasing wall time.
    Preserves the ascending-read-id order of the naive scan (the DP's
    state-bit layout depends on it)."""
    import collections

    R = len(first)
    starts = [[] for _ in range(n_sites)]
    for r in range(R):
        if 0 <= first[r] < n_sites:
            starts[int(first[r])].append(r)
    active = collections.OrderedDict()
    out = []
    for j in range(n_sites):
        for r in starts[j]:
            active[r] = None
        dead = [r for r in active if last[r] < j]
        for r in dead:
            del active[r]
        out.append(sorted(active.keys()))
    return out
