"""Production exact wMEC: read selection + fixed-parameter DP + joint
genotype re-typing.

whatshap — what NanoCaller runs at indelCaller.py:228,238 — phases with
an EXACT weighted-MEC DP after selecting reads down to ~15× per column
(--max-coverage), and `--distrust-genotypes` re-types genotypes JOINTLY
inside that DP (the PedMEC-G formulation), not as a post-hoc pass. This
module productionizes both:

- `select_reads`: whatshap-style coverage reduction — greedy selection
  of multi-site reads (most observations first, then longest span)
  capping the number of ACTIVE reads at every column.
- `exact_refine`: per phase block, solve exact wMEC (phase/wmec_oracle
  DP) over the selected reads and adopt the exact haplotype whenever it
  beats the heuristic's on the ALL-reads MEC objective — production
  phasing is exact on every block the DP can afford, and never worse
  than the heuristic elsewhere.
- `wmec_exact_gt`: the joint DP with per-column genotype states
  {0/0, 0/1, 1/1}; deviating from the input genotype costs `gq`
  (whatshap --default-gq, since NanoCaller's VCF has no GL/PL).
- `phase_distrust`: drives the joint DP over het + hom-alt sites per
  connected block (whatshap --distrust-genotypes --include-homozygous).

The post-hoc `mec.regenotype` pass remains as the differential twin for
tests; production `phase_contig(distrust=True)` routes here.

A copy of nanocaller_tpu/phase/wmec.py on the port's native library
(io/native): the selection loops and the trellis run in C++, and
`_block_cap` admits the checkpointed trellis's 16× cell budget, as the
JAX package does with its library loaded. The numpy/Python loops stay as
their bit-identical oracles, taken with use_native=False / native=False.
"""

from __future__ import annotations

import numpy as np

# NOTE: imports from .mec are deferred inside functions — mec imports
# this module lazily from phase_obs/phase_contig.


def _read_spans(rids, sidx, n_reads):
    """(first, last, cnt) per read. Fast path: observations sorted by
    (rid, sidx) — the layout phase_obs/exact_refine produce — reduce to
    three O(K) passes; otherwise fall back to scatter-reduce."""
    cnt = np.bincount(rids, minlength=n_reads)
    d = np.diff(rids)
    sorted_by_read = bool((d >= 0).all()) and bool(
        ((d > 0) | (np.diff(sidx) >= 0)).all()) if len(rids) > 1 else True
    first = np.full(n_reads, np.iinfo(np.int64).max, np.int64)
    last = np.full(n_reads, -1, np.int64)
    if sorted_by_read:
        r_ptr = np.searchsorted(rids, np.arange(n_reads + 1,
                                                dtype=np.int64))
        nz = r_ptr[:-1] < r_ptr[1:]
        first[nz] = sidx[r_ptr[:-1][nz]]
        last[nz] = sidx[r_ptr[1:][nz] - 1]
    else:
        np.minimum.at(first, rids, sidx)
        np.maximum.at(last, rids, sidx)
    return first, last, cnt


def select_reads(rids, sidx, n_reads, max_cov=15, use_native=True):
    """Greedy whatshap-style read selection (coverage reduction).

    Caps the number of ACTIVE multi-site reads (span covering the
    column, in site-index space — the DP's state width) at every column
    to `max_cov`. Priority: more observations first (connectivity),
    then longer span, then read id (deterministic). Single-observation
    reads are ignored (they never constrain the bipartition; whatshap
    likewise phases on multi-site reads only).

    Returns a bool mask over the observations (True = read selected).
    The greedy loop runs in C++ (io/native ncio_select_greedy); the
    Python loop below, taken with use_native=False, is its oracle.
    """
    K = len(rids)
    if K == 0:
        return np.zeros(0, bool)
    rids = np.asarray(rids)
    sidx = np.asarray(sidx)
    first, last, cnt = _read_spans(rids, sidx, n_reads)
    multi = np.flatnonzero(cnt >= 2)
    if not len(multi):
        return np.zeros(K, bool)
    span = last[multi] - first[multi]
    order = multi[np.lexsort((multi, -span, -cnt[multi]))]
    S = int(sidx.max()) + 1
    if use_native:
        from ..io.native import select_greedy_native

        return select_greedy_native(order, first, last, S, max_cov,
                                    n_reads)[rids]
    active = np.zeros(S, np.int32)
    taken = np.zeros(n_reads, bool)
    for r in order:
        f, l = int(first[r]), int(last[r]) + 1
        if active[f:l].max() < max_cov:
            active[f:l] += 1
            taken[r] = True
    return taken[rids]


def select_reads_production(rids, sidx, n_reads, max_cov=15):
    """PRODUCTION read selection = connectivity-first.

    Connectivity-first is never worse than the default greedy order and
    strictly less fragmenting on long spans (identical in the common
    regime), so production phasing selects by connectivity.
    `select_reads` (greedy) remains the differential baseline."""
    return select_reads_connectivity(rids, sidx, n_reads, max_cov=max_cov)


def select_reads_connectivity(rids, sidx, n_reads, max_cov=15,
                              use_native=True):
    """whatshap-style CONNECTIVITY-FIRST read selection.

    whatshap's read selection (readselection.py; run by NanoCaller at
    indelCaller.py:238 via `whatshap phase`) prioritizes reads that connect not-yet-linked
    variant pairs — coverage reduction must preserve the block
    structure, not just depth. This selector reproduces that criterion
    with the evidence available here (NanoCaller's pipeline hands
    whatshap a BAM whose base/mapping qualities break ties; this repo's
    allele matrix deliberately carries no per-observation qualities, so
    ties fall back to observation count → span → read id, the same
    order as the default greedy selector):

      repeat until no read fits under the cap:
        score(read) = number of ADJACENT site pairs in its span whose
        link count (selected reads covering both) is still 0, then
        (#obs, span, -rid); pick the best-scoring read that keeps every
        column of its span under max_cov (lazy rescoring heap).

    Returns a bool mask over the observations, like select_reads. The
    loop runs in C++ (io/native ncio_select_connectivity, strict total
    key order); the heap below, taken with use_native=False, is its
    bit-identical oracle.
    """
    import heapq

    K = len(rids)
    if K == 0:
        return np.zeros(0, bool)
    rids = np.asarray(rids)
    sidx = np.asarray(sidx)
    first, last, cnt = _read_spans(rids, sidx, n_reads)
    multi = np.flatnonzero(cnt >= 2)
    if not len(multi):
        return np.zeros(K, bool)
    S = int(sidx.max()) + 1
    if use_native:
        from ..io.native import select_connectivity_native

        return select_connectivity_native(first, last, cnt, multi, S,
                                          max_cov, n_reads)[rids]
    active = np.zeros(S, np.int32)
    # link[j] = selected reads spanning the (j, j+1) adjacency
    link = np.zeros(max(S - 1, 1), np.int32)
    taken = np.zeros(n_reads, bool)

    def score(r):
        f, l = int(first[r]), int(last[r])
        if l <= f:
            return 0
        return int((link[f:l] == 0).sum())

    span = last - first
    heap = [(-score(r), -int(cnt[r]), -int(span[r]), int(r))
            for r in multi]
    heapq.heapify(heap)
    while heap:
        neg_sc, neg_cnt, neg_span, r = heapq.heappop(heap)
        cur = score(r)
        if -neg_sc != cur:
            heapq.heappush(heap, (-cur, neg_cnt, neg_span, r))
            continue
        f, l = int(first[r]), int(last[r]) + 1
        if active[f:l].max() < max_cov:
            active[f:l] += 1
            if l - 1 > f:
                link[f:l - 1] += 1
            taken[r] = True
    return taken[rids]


def components(rids, sidx, n_sites):
    """Connected components of sites linked by multi-observation reads
    (same convention as mec.phase_obs: adjacent observation pairs within
    each read, which is reachability-equivalent to all pairs)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    order = np.lexsort((sidx, rids))
    r_s, s_s = np.asarray(rids)[order], np.asarray(sidx)[order]
    if len(r_s) > 1:
        same = r_s[1:] == r_s[:-1]
        pa = s_s[:-1][same].astype(np.int64)
        pb = s_s[1:][same].astype(np.int64)
        keep = pa != pb
        pa, pb = pa[keep], pb[keep]
    else:
        pa = pb = np.zeros(0, np.int64)
    if len(pa):
        g = sp.coo_matrix((np.ones(len(pa)), (pa, pb)),
                          shape=(n_sites, n_sites))
        _, comp = csgraph.connected_components(g, directed=False)
    else:
        comp = np.arange(n_sites)
    return comp.astype(np.int64)


def _block_cap(n_block_sites, max_cov, cell_budget):
    """Largest active-read cap whose trellis fits the cell budget.

    The native trellis (io/native ncio_wmec) runs blocks up to 16× the
    cell budget in CHECKPOINT mode — frontier snapshots plus per-block
    recompute bound the parent/gt store at the budget while the compute
    cost doubles — so cap 15 survives whole-contig block sizes (~290k
    sites at the default budget). This is the JAX package's bound with
    its library loaded."""
    scale = 16
    cap = max_cov
    while cap > 4 and n_block_sites * (1 << cap) > scale * cell_budget:
        cap -= 1
    return cap


def exact_refine(rids, sidx, alleles, n_sites, comp, h,
                 max_cov=15, cell_budget=600_000_000, n_threads=None):
    """Per-block exact wMEC on coverage-selected reads.

    For every phase block, runs the exact DP (het-pinned wmec_exact_gt,
    the native trellis) over the selected observations
    and adopts the exact haplotype iff it
    strictly lowers the block's MEC cost over ALL observations — the
    production result is exact wherever the DP wins and never worse than
    the heuristic h elsewhere. Returns the (possibly updated) h."""
    from .wmec_oracle import cost_of_h

    if len(rids) == 0:
        return h
    h = np.asarray(h).copy()
    rids = np.asarray(rids)
    sidx = np.asarray(sidx)
    alleles = np.asarray(alleles)
    n_reads = int(rids.max()) + 1
    keep = select_reads_production(rids, sidx, n_reads, max_cov=max_cov)
    sizes = np.bincount(comp, minlength=n_sites)
    comp_of_obs = comp[sidx]

    jobs = []
    for c in np.flatnonzero(sizes >= 2):
        mem = np.flatnonzero(comp == c)
        nb = len(mem)
        in_c = comp_of_obs == c
        cap = _block_cap(nb, max_cov, cell_budget)
        sel = keep & in_c
        if cap < max_cov:
            # re-select THIS block's observations only at the lower cap
            # (selecting over a masked copy of the full arrays would
            # merge every out-of-block observation into read 0 and
            # corrupt its count/span)
            idx_c = np.flatnonzero(in_c)
            sub = select_reads_production(rids[idx_c], sidx[idx_c], n_reads,
                                          max_cov=cap)
            sel = np.zeros_like(in_c)
            sel[idx_c[sub]] = True
        if not sel.any():
            continue
        local = np.full(n_sites, -1, np.int64)
        local[mem] = np.arange(nb)
        jobs.append((mem, nb, in_c, cap, sel, local))

    def solve(job):
        mem, nb, in_c, cap, sel, local = job
        try:
            # het-pinned joint DP (huge gq) = plain exact wMEC on the
            # native trellis, whose budget must admit what _block_cap
            # admitted (sites × 2^cap cells)
            _c_sel, h_ex, _a2, _part = wmec_exact_gt(
                rids[sel], local[sidx[sel]], alleles[sel], nb,
                np.ones(nb, np.int8), 1e30, max_active=cap,
                cell_budget=max(cell_budget, 64_000_000))
        except ValueError:
            return None  # selection failed to bound the active width
        return h_ex

    # blocks are independent; the native trellis releases the GIL, so
    # thread-parallel block solves use spare cores
    if len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        import os

        # default to the machine when unconstrained; a caller running
        # beside other workers passes a budget
        budget = n_threads if n_threads else (os.cpu_count() or 2)
        with ThreadPoolExecutor(min(len(jobs), max(2, budget))) as ex:
            solved = list(ex.map(solve, jobs))
    else:
        solved = [solve(j) for j in jobs]

    for job, h_ex in zip(jobs, solved):
        if h_ex is None:
            continue
        mem, nb, in_c, cap, sel, local = job
        rr_all = rids[in_c]
        ss_all = local[sidx[in_c]]
        aa_all = alleles[in_c]
        c_old = cost_of_h(rr_all, ss_all, aa_all, h[mem])
        c_new = cost_of_h(rr_all, ss_all, aa_all, h_ex)
        if c_new < c_old:
            h[mem] = h_ex
    return h


def wmec_exact_gt(rids, sidx, alleles, n_sites, g_in, gq, max_active=18,
                  native=True, cell_budget=64_000_000):
    """Exact joint wMEC + genotype re-typing DP (PedMEC-G analog of
    whatshap --distrust-genotypes --include-homozygous).

    Each column (site) may take genotype state g ∈ {0, 1, 2} (alt-allele
    count); deviating from the input genotype g_in[j] costs `gq` (in
    units of one observation — callers convert phred default-gq by the
    per-observation weight). The column cost of (mask, g) is the
    cheapest consistent allele assignment: g=0 pays all alt
    observations, g=2 all ref observations, g=1 the cheaper of the two
    het orientations. Ties keep the input genotype.

    Returns (cost, a1, a2, part): a1/a2 int8[n_sites] alleles on
    haplotype 1/2 (a1+a2 = chosen genotype), part mapping multi-site
    read id → side 0/1.
    """
    rids = np.asarray(rids)
    sidx = np.asarray(sidx)
    alleles = np.asarray(alleles)
    g_in = np.asarray(g_in)
    a1_default = (g_in == 2).astype(np.int8)
    a2_default = (g_in >= 1).astype(np.int8)

    uniq, inv, cnt = np.unique(rids, return_inverse=True, return_counts=True)
    keep = (cnt >= 2)[inv]
    multi = np.flatnonzero(cnt >= 2)
    R = len(multi)
    if R == 0:
        return 0.0, a1_default, a2_default, {}
    remap = -np.ones(len(uniq), np.int64)
    remap[multi] = np.arange(R)
    rr = remap[inv[keep]]
    ss = sidx[keep].astype(np.int64)
    aa = alleles[keep].astype(np.int64)

    first = np.full(R, n_sites, np.int64)
    last = np.full(R, -1, np.int64)
    np.minimum.at(first, rr, ss)
    np.maximum.at(last, rr, ss)

    if native:
        # C++ trellis (io/native ncio_wmec): identical state-bit layout,
        # tie rules and double arithmetic — bit-for-bit the Python DP
        # below (native=False), which stores every column
        from ..io.native import wmec_native

        order_o = np.argsort(ss, kind="stable")
        ss_s = ss[order_o]
        col_start = np.searchsorted(ss_s, np.arange(n_sites + 1))
        res = wmec_native(
            first.astype(np.int32), last.astype(np.int32),
            col_start.astype(np.int64), rr[order_o].astype(np.int32),
            aa[order_o].astype(np.int8), np.asarray(g_in, np.int8), gq,
            max_active, cell_budget)
        if res is None:
            raise ValueError(
                "wMEC instance infeasible for the native trellis: active "
                "coverage over max_active=%d (at most 24), or more than "
                "16 x %d trellis cells; select reads first"
                % (max_active, cell_budget))
        cost, a1n, a2n, partn = res
        part = {int(multi[r]): int(partn[r]) for r in range(R)}
        return cost, a1n, a2n, part

    obs_at = [[] for _ in range(n_sites)]
    for r, s, a in zip(rr, ss, aa):
        obs_at[int(s)].append((int(r), int(a)))

    from .wmec_oracle import _active_sweep

    active_lists = _active_sweep(first, last, n_sites)
    prev_active: list = []
    prev_dp = np.zeros(1, np.float64)
    trellis = []
    dp = prev_dp
    for j in range(n_sites):
        active = active_lists[j]
        A = len(active)
        if A > max_active:
            raise ValueError(
                f"active coverage {A} at site {j} exceeds "
                f"max_active={max_active}; select reads first")
        masks = np.arange(1 << A, dtype=np.int64)
        pos_prev = {r: i for i, r in enumerate(prev_active)}
        shared = [(pos_prev[r], i) for i, r in enumerate(active)
                  if r in pos_prev]
        nkeys = 1 << len(shared)
        pkeys = np.zeros(len(prev_dp), np.int64)
        for k, (pi, _ci) in enumerate(shared):
            pkeys |= (((np.arange(len(prev_dp), dtype=np.int64) >> pi) & 1)
                      << k)
        best_cost = np.full(nkeys, np.inf)
        np.minimum.at(best_cost, pkeys, prev_dp)
        hit = prev_dp == best_cost[pkeys]
        best_mask = np.full(nkeys, -1, np.int64)
        idx = np.flatnonzero(hit)
        np.maximum.at(best_mask, pkeys[idx[::-1]], idx[::-1])

        # per-mask column cost for each genotype state
        col = obs_at[j]
        ai = {r: i for i, r in enumerate(active)}
        w_s1 = [np.zeros(len(masks)), np.zeros(len(masks))]
        tot = [0.0, 0.0]
        for r, a in col:
            bit = ((masks >> ai[r]) & 1).astype(np.float64)
            w_s1[a] = w_s1[a] + bit
            tot[a] += 1.0
        w_s0 = [tot[0] - w_s1[0], tot[1] - w_s1[1]]
        o0 = w_s0[1] + w_s1[0]  # hap1(side0)=ref, hap2(side1)=alt
        o1 = w_s0[0] + w_s1[1]
        ori = (o1 < o0).astype(np.int8)
        cost_g = {
            0: np.full(len(masks), tot[1]),
            1: np.minimum(o0, o1),
            2: np.full(len(masks), tot[0]),
        }
        gj = int(g_in[j])
        col_cost = cost_g[gj].copy()  # input genotype first: wins ties
        gt_choice = np.full(len(masks), gj, np.int8)
        for g in (0, 1, 2):
            if g == gj:
                continue
            c = cost_g[g] + gq
            better = c < col_cost
            col_cost = np.where(better, c, col_cost)
            gt_choice = np.where(better, g, gt_choice).astype(np.int8)

        ckeys = np.zeros(len(masks), np.int64)
        for k, (_pi, ci) in enumerate(shared):
            ckeys |= ((masks >> ci) & 1) << k
        dp = best_cost[ckeys] + col_cost
        trellis.append((active, best_mask[ckeys], gt_choice, ori))
        prev_active = active
        prev_dp = dp

    # backtrack
    part: dict = {}
    a1 = a1_default.copy()
    a2 = a2_default.copy()
    j = n_sites - 1
    mask = int(np.argmin(dp))
    total = float(dp[mask])
    while j >= 0:
        active, parent, gt_choice, ori = trellis[j]
        for i, r in enumerate(active):
            part[int(multi[r])] = (mask >> i) & 1
        g = int(gt_choice[mask])
        if g == 1:
            o = int(ori[mask])
            a1[j], a2[j] = (1, 0) if o == 1 else (0, 1)
        else:
            a1[j] = a2[j] = 1 if g == 2 else 0
        mask = int(parent[mask])
        j -= 1
    return total, a1, a2, part


def phase_distrust(rw, het_pos, het_ref, het_alt, hom_pos, hom_ref, hom_alt,
                   default_gq=30.0, eps=0.1, max_cov=15,
                   cell_budget=600_000_000):
    """whatshap `--distrust-genotypes --include-homozygous` equivalent
    with genotype re-typing JOINTLY inside the per-block exact wMEC DP
    (indelCaller.py:228). Sites = called het SNPs ∪ hom-alt SNPs; each
    connected block is solved by `wmec_exact_gt` over coverage-selected
    reads; the genotype-change penalty is whatshap's constant
    --default-gq (NanoCaller's VCF carries no GL/PL, snpCaller.py:135-197)
    converted to observation units by the flat read weight
    10·log10((1−eps)/eps).

    Returns (PhaseResult over the HET input sites, phase_map):
    phase_map maps pos1 → ("0|1"/"1|0", ps) for phased hets (input het
    kept-het, or hom opened to het), or the bare strings "0/0"/"1/1"
    for re-typed unphased genotypes (0/0 entries are dropped from the
    phased VCF downstream, matching bcftools view -e 'GT="0\\0"',
    indelCaller.py:241).
    """
    from .mec import PhaseResult, _obs_weight, build_allele_matrix

    het_pos = np.asarray(het_pos, np.int64)
    hom_pos = np.asarray(hom_pos, np.int64)
    pos = np.concatenate([het_pos, hom_pos])
    refc = np.concatenate([np.asarray(het_ref, np.int8),
                           np.asarray(hom_ref, np.int8)])
    altc = np.concatenate([np.asarray(het_alt, np.int8),
                           np.asarray(hom_alt, np.int8)])
    g_in = np.concatenate([np.ones(len(het_pos), np.int8),
                           np.full(len(hom_pos), 2, np.int8)])
    order = np.argsort(pos, kind="stable")
    pos, refc, altc, g_in = pos[order], refc[order], altc[order], g_in[order]
    S = len(pos)
    is_het_in = g_in == 1

    rids, sidx, alleles = build_allele_matrix(rw, pos, refc, altc)
    comp = components(rids, sidx, S) if len(rids) else np.arange(S)
    sizes = np.bincount(comp, minlength=S) if S else np.zeros(0, np.int64)
    keep = select_reads_production(rids, sidx, rw.n_reads,
                                   max_cov=max_cov) \
        if len(rids) else np.zeros(0, bool)
    gq_units = default_gq / _obs_weight(eps)

    a1 = (g_in == 2).astype(np.int8)
    a2 = (g_in >= 1).astype(np.int8)
    comp_of_obs = comp[sidx] if len(rids) else np.zeros(0, np.int64)
    for c in np.flatnonzero(sizes >= 2):
        mem = np.flatnonzero(comp == c)
        nb = len(mem)
        in_c = comp_of_obs == c
        cap = _block_cap(nb, max_cov, cell_budget)
        sel = keep & in_c
        if cap < max_cov:
            idx_c = np.flatnonzero(in_c)
            sub = select_reads_production(rids[idx_c], sidx[idx_c],
                                          rw.n_reads, max_cov=cap)
            sel = np.zeros_like(in_c)
            sel[idx_c[sub]] = True
        if not sel.any():
            continue
        local = np.full(S, -1, np.int64)
        local[mem] = np.arange(nb)
        _cost, b1, b2, _part = wmec_exact_gt(
            rids[sel], local[sidx[sel]], alleles[sel], nb, g_in[mem],
            gq_units, max_active=cap,
            cell_budget=max(cell_budget, 64_000_000))
        a1[mem], a2[mem] = b1, b2

    # block PS ids (position of the block's first variant, whatshap
    # convention — blocks here include the hom-alt sites)
    block_ps = np.full(S, -1, np.int64)
    for c in np.flatnonzero(sizes >= 2):
        mem = np.flatnonzero(comp == c)
        block_ps[mem] = int(pos[mem[0]]) + 1

    # final read assignment from (a1, a2) over ALL observations
    read_hp = np.zeros(rw.n_reads, np.int8)
    read_ps = np.full(rw.n_reads, -1, np.int64)
    if len(rids):
        mis1 = np.bincount(rids, weights=(alleles != a1[sidx]).astype(float),
                           minlength=rw.n_reads)
        mis2 = np.bincount(rids, weights=(alleles != a2[sidx]).astype(float),
                           minlength=rw.n_reads)
        read_hp = np.where(mis1 < mis2, 1,
                           np.where(mis2 < mis1, 2, 0)).astype(np.int8)
        order_o = np.lexsort((sidx, rids))
        r_s, s_s = rids[order_o], sidx[order_o]
        r_ptr = np.searchsorted(r_s, np.arange(rw.n_reads + 1,
                                               dtype=r_s.dtype))
        obs_ps = block_ps[s_s]
        k_idx = np.where(obs_ps >= 0, np.arange(len(s_s)), len(s_s))
        nonempty = r_ptr[:-1] < r_ptr[1:]
        firsts = np.full(rw.n_reads, len(s_s), np.int64)
        if nonempty.any():
            firsts[nonempty] = np.minimum.reduceat(k_idx,
                                                   r_ptr[:-1][nonempty])
        tagged = (read_hp != 0) & nonempty
        found = tagged & (firsts < len(s_s))
        read_ps[found] = obs_ps[firsts[found]]
        read_hp[tagged & ~found] = 0

    # phase_map (see docstring)
    g_out = (a1 + a2).astype(np.int8)
    phase_map = {}
    for j in range(S):
        p1 = int(pos[j]) + 1
        if is_het_in[j]:
            if g_out[j] == 1:
                if block_ps[j] >= 0:
                    gt = "1|0" if a1[j] == 1 else "0|1"
                    phase_map[p1] = (gt, int(block_ps[j]))
            else:
                phase_map[p1] = "0/0" if g_out[j] == 0 else "1/1"
        else:  # input 1/1
            if g_out[j] == 1 and block_ps[j] >= 0:
                gt = "1|0" if a1[j] == 1 else "0|1"
                phase_map[p1] = (gt, int(block_ps[j]))
            elif g_out[j] == 0:
                phase_map[p1] = "0/0"

    # PhaseResult over the het input sites (downstream haplotagging uses
    # read_hp/read_ps; hap_allele is hap1's allele where still het)
    het_mask = is_het_in
    het_idx = np.flatnonzero(het_mask)
    mec = 0
    if len(rids):
        het_obs = het_mask[sidx]
        hp_of_obs = read_hp[rids[het_obs]]
        mism = alleles[het_obs] != a1[sidx[het_obs]]
        mec = int(((hp_of_obs == 1) & mism).sum()
                  + ((hp_of_obs == 2) & ~mism
                     & (a1[sidx[het_obs]] != a2[sidx[het_obs]])).sum())
    n_blocks = len({int(b) for b in block_ps[het_idx] if b >= 0})
    result = PhaseResult(
        site_pos=pos[het_idx], hap_allele=a1[het_idx],
        block_ps=block_ps[het_idx], read_hp=read_hp, read_ps=read_ps,
        n_blocks=n_blocks, mec_cost=mec)
    return result, phase_map

