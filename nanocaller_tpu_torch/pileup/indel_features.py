"""Indel candidate scan + phased MSA feature generation.

Re-expresses the reference's two-pass indel pipeline
(generate_indel_pileups.py:129-371, *_haploid.py:129-278) without
per-column Python set algebra:

- pass 1: sliding-window *distinct-read* indel frequencies per haplotype
  become interval-union counts over event arrays (the subtlest
  vectorization, SURVEY.md §7.4.6): an event at column c makes its read
  count toward windows ending at columns [c, c+win-1]; per-read merged
  intervals feed a diff-array/prefix-sum;
- pass 2: candidate read windows are cut from the already-decoded query
  sequences and realigned via the in-repo star MSA (align/msa.py)
  instead of MUSCLE subprocesses; allele sequences come from the NW
  cigar walk ported bug-for-bug from allele_prediction (:77-127).

Semantics notes (cites into /root/reference/nanocaller_src/):
- event length filters: big window counts indels with 2 < len ≤ 50,
  small window counts len ≤ 10 (generate_indel_pileups.py:225-235)
- candidate placement: big → v−win_size (type 0), small → v−10 (type 1),
  with sequential `prev` suppression (:249,266-275)
- haplotype sets from HP tags; phase-set output = PS of the first hap-1
  read at the candidate column (:178-188,355)
- --impute_indel_phase allele-clustering pseudo-phasing (:278-304)
- ref base validity: uppercase AGTC else 'N'; windows containing N are
  skipped (:174,327-328)

Pass 2 is split at the alignments: collect_msa_jobs runs on the host
without torch (what the `--cpu N` feature workers run, per chunk or per
shared-decode group) and returns picklable job records; finish_indel_jobs
runs in the process that owns the device and aligns the pairs of any
number of records in one K1 + K2 round per alignment kind.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.nw import nw_align
from .engine import ReadWindow, decode_reads, indel_deferred_decode

REF_N_LUT = np.full(256, 0, dtype=np.int8)  # 1 = valid AGTC uppercase
for _b in "AGTC":
    REF_N_LUT[ord(_b)] = 1


def sliding_distinct_counts(event_rids, event_cols, n_cols, win,
                            presorted=False):
    """#distinct reads with ≥1 event in the win-column window ending at c.

    event_cols are 0-based ranks in the scan-column space. Returns
    int32[n_cols]. presorted=True asserts the events are already
    (rid, col)-lexsorted — true for decode-order event arrays filtered
    by a boolean mask (reads emit in id order, anchors ascending within
    a read), skipping the per-call lexsort.
    """
    if len(event_rids) == 0:
        return np.zeros(n_cols, dtype=np.int32)
    if presorted:
        rid = np.asarray(event_rids)
        col = np.asarray(event_cols)
    else:
        order = np.lexsort((event_cols, event_rids))
        rid = np.asarray(event_rids)[order]
        col = np.asarray(event_cols)[order]
    new_iv = np.ones(len(rid), dtype=bool)
    new_iv[1:] = (rid[1:] != rid[:-1]) | (col[1:] > col[:-1] + win)
    starts_idx = np.flatnonzero(new_iv)
    ends_idx = np.append(starts_idx[1:], len(rid)) - 1
    iv_start = col[starts_idx]
    iv_end = np.minimum(col[ends_idx] + win - 1, n_cols - 1)
    out = np.bincount(iv_start, minlength=n_cols + 1).astype(np.int64)
    out -= np.bincount(iv_end + 1, minlength=n_cols + 1)
    return np.cumsum(out)[:-1].astype(np.int32)


def _rank_in_scan(scan_cols, needles):
    """searchsorted(scan_cols, needles, 'left'), with the dominant case
    (scan_cols a contiguous range — no BED exclusions) computed by
    arithmetic instead of a binary search per needle."""
    n = len(scan_cols)
    if n == 0:
        return np.zeros(len(needles), np.int64)
    if int(scan_cols[-1]) - int(scan_cols[0]) + 1 == n:
        return np.clip(needles.astype(np.int64) - int(scan_cols[0]), 0, n)
    return np.searchsorted(scan_cols, needles)


def coverage_per_column(rw: ReadWindow, cols, rid_subset=None):
    """#reads covering each scan column (deletion spans included)."""
    starts = rw.read_start
    ends = rw.read_end
    if rid_subset is not None:
        starts = starts[rid_subset]
        ends = ends[rid_subset]
    lo = _rank_in_scan(cols, starts)
    hi = _rank_in_scan(cols, ends)
    n = len(cols)
    out = np.bincount(lo, minlength=n + 1).astype(np.int64)
    out -= np.bincount(hi, minlength=n + 1)
    return np.cumsum(out)[:-1].astype(np.int32)


def _anchor_events(rw: ReadWindow, kind):
    """(rid, anchor_col0, length) for ins/del events. Deletions anchor at
    the column before the deleted run; insertions at the preceding
    aligned base (pysam pileup-string convention)."""
    if kind == "ins":
        return rw.ins_rid, rw.ins_pos, rw.ins_len
    return rw.del_rid, rw.del_start - 1, rw.del_len


def _compute_triggers(rw, scan_cols, *, win_size, small_win_size, mincov,
                      ins_t, del_t, impute_indel_phase=False, haploid=False):
    """Vectorized trigger computation of pass 1: per-column boolean
    arrays (big_trig, small_trig, impute_trig). Reads only read
    intervals, HP tags and ins/del events — never aligned-base events,
    so it can run on a phase-1 deferred window
    (engine.IndelDeferredWindow)."""
    n = len(scan_cols)
    if haploid:
        hap1 = np.ones(rw.n_reads, dtype=bool)
        hap2 = hap1
    else:
        hap1 = rw.hp == 1
        hap2 = rw.hp == 2
    cov = {
        0: coverage_per_column(rw, scan_cols, np.flatnonzero(hap1)),
        1: coverage_per_column(rw, scan_cols, np.flatnonzero(hap2)),
        "tot": coverage_per_column(rw, scan_cols),
    }

    freqs = {}
    for kind in ("ins", "del"):
        rids, anchors, lens = _anchor_events(rw, kind)
        rank = _rank_in_scan(scan_cols, anchors)
        on_scan = (rank < n)
        on_scan[on_scan] = scan_cols[rank[on_scan]] == anchors[on_scan]
        for hap_i, hap_mask in ((0, hap1), (1, hap2)):
            base = on_scan & hap_mask[rids]
            big = base & (lens > 2) & (lens <= 50)
            small = base & (lens <= 10)
            # decode-order ins/del events are (rid, anchor)-sorted and
            # boolean masks preserve that — skip the per-call lexsort
            cnt_big = sliding_distinct_counts(rids[big], rank[big], n,
                                              win_size, presorted=True)
            cnt_small = sliding_distinct_counts(rids[small], rank[small], n,
                                                small_win_size,
                                                presorted=True)
            denom = np.maximum(cov[hap_i], 1)
            freqs[(kind, hap_i, "big")] = np.where(cov[hap_i] > 0, cnt_big / denom, 0.0)
            freqs[(kind, hap_i, "small")] = np.where(cov[hap_i] > 0, cnt_small / denom, 0.0)

    hap_ok = (cov[0] >= mincov) & (cov[1] >= mincov)
    big_trig = hap_ok & (
        (np.maximum(freqs[("del", 0, "big")], freqs[("del", 1, "big")]) >= del_t)
        | (np.maximum(freqs[("ins", 0, "big")], freqs[("ins", 1, "big")]) >= ins_t)
    )
    small_trig = hap_ok & (
        (np.maximum(freqs[("del", 0, "small")], freqs[("del", 1, "small")]) >= del_t)
        | (np.maximum(freqs[("ins", 0, "small")], freqs[("ins", 1, "small")]) >= ins_t)
        | ((freqs[("del", 0, "small")] + freqs[("ins", 0, "small")]) >= 0.9)
        | ((freqs[("del", 1, "small")] + freqs[("ins", 1, "small")]) >= 0.9)
    )

    impute_trig = np.zeros(n, dtype=bool)
    if impute_indel_phase:
        # any-length anchor counts + deletion spans, over ALL reads
        ins_rids, ins_anchor, _ = _anchor_events(rw, "ins")
        del_rids, del_anchor, del_lens = _anchor_events(rw, "del")
        ins_cnt = _count_at(scan_cols, ins_anchor)
        del_cnt = _count_at(scan_cols, del_anchor)
        span_cnt = _span_counts(scan_cols, rw.del_start, rw.del_start + rw.del_len)
        denom = np.maximum(cov["tot"], 1)
        del_freq_tot = np.where(cov["tot"] > 0, (del_cnt + span_cnt) / denom, 0.0)
        ins_freq_tot = np.where(cov["tot"] > 0, ins_cnt / denom, 0.0)
        impute_trig = (~hap_ok) & (cov["tot"] >= 2 * mincov) & (
            (del_freq_tot >= del_t) | (ins_freq_tot >= ins_t))
    return big_trig, small_trig, impute_trig


def _select_candidates(rw, scan_cols, triggers, win_size, mincov,
                       sig_provider=None):
    """Sequential prev-suppression selection of pass 1 (the loop order
    and `prev` chain mirror generate_indel_pileups.py:249,266-304)."""
    big_trig, small_trig, impute_trig = triggers
    variants, extra = {}, {}
    prev = -1  # 0-based position threshold
    trig_idx = np.flatnonzero(big_trig | small_trig | impute_trig)
    for i in trig_idx:
        v0 = int(scan_cols[i])
        if v0 <= prev:
            continue
        if big_trig[i]:
            variants[max(0, v0 - win_size)] = 0
            prev = v0 + win_size
        elif small_trig[i]:
            variants[max(0, v0 - 10)] = 1
            prev = v0 + 10
        elif impute_trig[i] and sig_provider is not None:
            split = _impute_split(sig_provider(v0), rw, mincov)
            if split is not None:
                variants[max(0, v0 - 10)] = 1
                extra[max(0, v0 - 10)] = split
                prev = v0 + 10
    return variants, extra


def _event_columns_needed(scan_cols, triggers, win_size):
    """Superset of the columns whose aligned-base events pass 2 may ever
    query: the candidate window anchor per trigger (big → v0−win_size,
    small/impute → v0−10) plus the trigger column itself for impute
    signature grouping. The selection loop only suppresses candidates
    (prev chain), never adds columns, so this is exact as a superset and
    computable before any aligned events exist."""
    big_trig, small_trig, impute_trig = triggers
    cols = set()
    for i in np.flatnonzero(big_trig | small_trig | impute_trig):
        v0 = int(scan_cols[i])
        if big_trig[i]:
            cols.add(max(0, v0 - win_size))
        elif small_trig[i]:
            cols.add(max(0, v0 - 10))
        else:
            cols.add(v0)
            cols.add(max(0, v0 - 10))
    return cols


def _count_at(scan_cols, anchors):
    rank = _rank_in_scan(scan_cols, anchors)
    ok = rank < len(scan_cols)
    ok[ok] = scan_cols[rank[ok]] == anchors[ok]
    return np.bincount(rank[ok],
                       minlength=len(scan_cols)).astype(np.int32)


def _span_counts(scan_cols, starts, ends):
    lo = _rank_in_scan(scan_cols, starts)
    hi = _rank_in_scan(scan_cols, ends)
    n = len(scan_cols)
    out = np.bincount(lo, minlength=n + 1).astype(np.int64)
    out -= np.bincount(hi, minlength=n + 1)
    return np.cumsum(out)[:-1].astype(np.int32)


def _impute_split(groups, rw, mincov):
    """Allele-clustering pseudo-phasing (generate_indel_pileups.py:286-304).

    groups: {signature: [rid,...]} at the column, insertion order
    mirroring pileup read order. Returns (set_rid0, set_rid1) or None.
    """
    total = sum(len(v) for v in groups.values())
    counts = sorted(((k, len(v)) for k, v in groups.items()),
                    key=lambda kv: kv[1], reverse=True)
    if not counts:
        return None
    if counts[0][1] <= 0.8 * total:
        rids0 = set(groups[counts[0][0]])
        if len(counts) > 1 and counts[1][1] >= mincov:
            rids1 = set(groups[counts[1][0]])
        else:
            all_rids = set()
            for v in groups.values():
                all_rids.update(v)
            rids1 = all_rids - rids0
    else:
        g = groups[counts[0][0]]
        rids0 = set(g[: counts[0][1] // 2])
        rids1 = set(g[counts[0][1] // 2:])
    if len(rids0) >= mincov and len(rids1) >= mincov:
        return rids0, rids1
    return None


def allele_prediction(alt, ref_seq, max_range, cigar=None):
    """NW cigar walk → (REF, ALT) allele strings; bug-for-bug port of
    generate_indel_pileups.py:77-127 (incl. the trailing-op trim and
    the +1 when no match precedes the indel)."""
    if not alt or not ref_seq:
        return (None, None)
    if cigar is None:
        cigar = nw_align(alt, ref_seq)[1]
    indel = False
    ref_cnt = [0] * 10
    alt_cnt = [0] * 10
    mm_before = False
    mm_after = (0, 0)
    op, cnt = 7, 0
    for op, cnt in cigar:
        if op == 8 or op == 7:
            ref_cnt[op] += cnt
            alt_cnt[op] += cnt
            if indel:
                mm_after[op - 7] += cnt
            else:
                mm_before = True
        if op == 1:
            alt_cnt[op] += cnt
            mm_after = [0, 0]
            indel = True
        if op == 2:
            ref_cnt[op] += cnt
            mm_after = [0, 0]
            indel = True
        if indel is False and sum(ref_cnt) >= max_range + 10:
            if ref_cnt[8]:
                out_len = sum(ref_cnt) if op == 8 else sum(ref_cnt) - cnt
                return ref_seq[:out_len], alt[:out_len]
            return (None, None)
        if indel is True:
            if sum(mm_after) > 20:
                break
    ref_out = sum(ref_cnt) if op == 8 else sum(ref_cnt) - cnt
    alt_out = sum(alt_cnt) if op == 8 else sum(alt_cnt) - cnt
    if not mm_before:
        ref_out += 1
        alt_out += 1
    return ref_seq[:ref_out], alt[:alt_out]


@dataclass
class IndelBatch:
    contig: str
    pos: list  # 1-based candidate positions
    x0: np.ndarray  # (B,5,128,2) hap0 tensor
    x1: np.ndarray
    x2: np.ndarray  # all-reads tensor
    alleles: list  # [( (ref,alt)_hap0, (ref,alt)_hap1, (ref,alt)_total )]
    phase: list  # PS id or None per candidate

    def __len__(self):
        return len(self.pos)


@dataclass
class HaploidIndelBatch:
    contig: str
    pos: list
    x: np.ndarray  # (B,5,128,2)
    alleles: list  # [(ref, alt)]

    def __len__(self):
        return len(self.pos)


class _ColumnView:
    """Per-read lookup at one column: reads covering it, their next query
    positions (pysam query_position_or_next), and indel signatures."""

    def __init__(self, rw: ReadWindow):
        self.rw = rw
        # when the window came from a deferred emit_qpos decode, only the
        # emitted columns carry events — any other column would resolve to
        # a wrong qpos silently, so guard every lookup
        self._emitted = getattr(rw, "emitted_cols", None)
        # events are emitted read-by-read in CIGAR order → ev_rid is
        # non-decreasing and ev_pos ascending within a read
        # dtype must match ev_rid's: a mixed-dtype searchsorted silently
        # promotes (copies) the multi-million-entry event array per call
        self.indptr = np.searchsorted(
            rw.ev_rid, np.arange(rw.n_reads + 1, dtype=rw.ev_rid.dtype))
        # packed (rid<<32|pos) keys: globally sorted (events emit in rid
        # order, positions ascending within a read), so ONE searchsorted
        # answers the per-read "first event at column >= c" query for
        # every covering read at once (the scalar per-read loop was ~8%
        # of the indel feature path)
        self._key = ((rw.ev_rid.astype(np.uint64) << np.uint64(32))
                     | rw.ev_pos.astype(np.uint64))

    def _check_emitted(self, col):
        if self._emitted is not None and int(col) not in self._emitted:
            raise AssertionError(
                "deferred indel decode: column %d queried but not emitted "
                "(gap in _event_columns_needed)" % int(col))

    def _lookup(self, col):
        """(rids, qpos, k, seg_hi) for reads covering col; k is the
        global index of the read's first event at column >= col (== the
        scalar lo + searchsorted(ev_pos[lo:hi], col) by key order)."""
        self._check_emitted(col)
        rw = self.rw
        covering = np.flatnonzero((rw.read_start <= col) & (col < rw.read_end))
        if len(covering) == 0:
            z = np.zeros(0, np.int64)
            return z, z, z, z
        needles = ((covering.astype(np.uint64) << np.uint64(32))
                   | np.uint64(int(col)))
        k = np.searchsorted(self._key, needles, side="left")
        lo = self.indptr[covering].astype(np.int64)
        hi = self.indptr[covering + 1].astype(np.int64)
        in_seg = k < hi
        has_ev = in_seg | (hi > lo)
        qpos = np.empty(len(covering), np.int64)
        qpos[in_seg] = rw.ev_qpos[k[in_seg]]
        tail = ~in_seg & (hi > lo)
        qpos[tail] = rw.ev_qpos[hi[tail] - 1] + 1
        return (covering[has_ev], qpos[has_ev], k[has_ev], hi[has_ev])

    def reads_at(self, col):
        rids, qpos, _, _ = self._lookup(col)
        return [(int(r), int(q)) for r, q in zip(rids, qpos)]

    def signature_groups(self, col):
        """{(code, ins_len, ins_anchor?, del_len): [rid...]} at column —
        groups reads by their local allele signature (mirrors grouping
        by pileup string at generate_indel_pileups.py:286-290)."""
        rw = self.rw
        ins_at = {}
        for rid, pos, ln in zip(rw.ins_rid, rw.ins_pos, rw.ins_len):
            if pos == col:
                ins_at[int(rid)] = int(ln)
        del_at = {}
        span = set()
        for rid, pos, ln in zip(rw.del_rid, rw.del_start, rw.del_len):
            if pos - 1 == col:
                del_at[int(rid)] = int(ln)
            if pos <= col < pos + ln:
                span.add(int(rid))
        groups = {}
        rids, _, ks, his = self._lookup(col)
        for rid, k, hi in zip(rids.tolist(), ks.tolist(), his.tolist()):
            if rid in span:
                sig = ("*", 0, 0)
            else:
                code = (int(rw.ev_code[k])
                        if (k < hi and rw.ev_pos[k] == col) else -1)
                sig = (code, ins_at.get(rid, 0), del_at.get(rid, 0))
            groups.setdefault(sig, []).append(rid)
        return groups


def extract_candidate_windows(rw, cview, v0, window_after, names0, names1):
    """Read windows at candidate column v0, split by haplotype set.

    Mirrors generate_indel_pileups.py:330-338: each covering read
    contributes query_sequence[qpos_or_next : qpos_or_next+window_after].
    Returns ({'h0': {}, 'h1': {}, 'tot': {}}, first_hap0_rid).
    """
    d = {"h0": {}, "h1": {}, "tot": {}}
    first_h0_rid = None
    rids, qposs, _, _ = cview._lookup(v0)
    if rw.seq_provider is not None:
        wins = rw.seq_provider(rids, qposs, window_after)
    else:
        wins = [rw.seqs[rid][max(0, q): q + window_after]
                for rid, q in zip(rids.tolist(), qposs.tolist())]
    for rid, qpos, dt in zip(rids.tolist(), qposs.tolist(), wins):
        name = rw.qnames[rid]
        d["tot"][name] = dt
        if rid in names0:
            d["h0"][name] = dt
            if first_h0_rid is None:
                first_h0_rid = rid
        elif rid in names1:
            d["h1"][name] = dt
    return d, first_h0_rid


def get_indel_candidates(bam, fasta, chunk, *, seq_type="ont", mincov=4,
                         maxcov=160, ins_t=0.4, del_t=0.6, win_size=40,
                         small_win_size=4, impute_indel_phase=False,
                         exclude=None, ploidy="diploid", rw=None, tags=None,
                         device="cuda"):
    """Full indel feature generation for one chunk (1-based chunk coords):
    collect_chunk_jobs on the host, then finish_indel_jobs on `device`.

    Diploid returns IndelBatch; haploid returns HaploidIndelBatch.
    All read-vs-ref MSA alignments and consensus-vs-ref allele
    alignments of the chunk go through the port's BatchAligner on
    `device` (kernels K1 + K2 on "cuda", their plain twins on "cpu");
    cigars are identical to nw.nw_align's.
    """
    rec = collect_chunk_jobs(
        bam, fasta, chunk, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
        ins_t=ins_t, del_t=del_t, win_size=win_size,
        small_win_size=small_win_size,
        impute_indel_phase=impute_indel_phase, exclude=exclude,
        ploidy=ploidy, rw=rw, tags=tags)
    return finish_indel_jobs([rec], device=device)[0]


def _inject_tags(rw, tags):
    """Set the reads' HP/PS from {qname: (hp, ps)}; a read absent from
    it keeps the input's own tags."""
    if tags:
        for rid_, qname in enumerate(rw.qnames):
            t = tags.get(qname)
            if t is not None:
                rw.hp[rid_] = t[0]
                rw.ps[rid_] = t[1]


def collect_chunk_jobs(bam, fasta, chunk, *, seq_type="ont", mincov=4,
                       maxcov=160, ins_t=0.4, del_t=0.6, win_size=40,
                       small_win_size=4, impute_indel_phase=False,
                       exclude=None, ploidy="diploid", rw=None, tags=None):
    """The host half of get_indel_candidates for one chunk: decode, scan
    and collect_msa_jobs. Returns its picklable job record.

    When rw is None and the input is a BAM, the decode runs in two native
    phases (engine.indel_deferred_decode): the scan needs no aligned-base
    events, so they are emitted only at the candidate anchor columns
    afterwards, and the reads' sequence windows are cut from the C++
    record store on demand. A CRAM is decoded in one native pass
    (engine.decode_reads).
    tags: optional {qname: (hp, ps)} haplotags injected right after the
    decode (the phase→indel handoff, in place of a phased-BAM round
    trip); a read absent from it keeps the BAM's own HP/PS.
    """
    contig = chunk["chrom"]
    start0 = chunk["start"] - 1
    end0 = chunk["end"]
    window_after = 260 if seq_type == "pacbio" else 160
    scan_lo = max(0, start0 - 10 - win_size)
    deferred = None
    if rw is None:
        deferred = indel_deferred_decode(bam, contig, scan_lo, end0)
        if deferred is not None:
            rw = deferred.window
        else:
            rw = decode_reads(bam, contig, scan_lo, end0, keep_seq=True)
    _inject_tags(rw, tags)
    chrom_len = fasta.get_reference_length(contig)

    scan_cols = np.arange(start0, end0, dtype=np.int64)
    if exclude is not None:
        scan_cols = scan_cols[~exclude.mask(contig, scan_cols)]

    haploid = ploidy == "haploid"
    triggers = _compute_triggers(
        rw, scan_cols, win_size=win_size, small_win_size=small_win_size,
        mincov=mincov, ins_t=ins_t, del_t=del_t,
        impute_indel_phase=impute_indel_phase and not haploid,
        haploid=haploid) if len(scan_cols) else (
            np.zeros(0, bool), np.zeros(0, bool), np.zeros(0, bool))
    if deferred is not None:
        deferred.finish_events(
            _event_columns_needed(scan_cols, triggers, win_size))
    cview = _ColumnView(rw)
    variants, extra = _select_candidates(
        rw, scan_cols, triggers, win_size, mincov,
        sig_provider=None if haploid else cview.signature_groups)

    try:
        return collect_msa_jobs(
            rw, cview, variants, extra, fasta, contig, chrom_len, scan_lo,
            window_after=window_after, win_size=win_size, mincov=mincov,
            maxcov=maxcov, haploid=haploid)
    finally:
        # frees the C++ record store backing rw.seq_provider
        if deferred is not None:
            deferred.close()


def _member_indel_window(rw_g: ReadWindow, contig, m_lo, m_hi):
    """Restrict a group-decoded phase-1 indel window (metadata + seqs +
    ins/del events, no aligned events yet) to the reads overlapping
    [m_lo, m_hi), remapping ids to the member-local position-ordered
    space — the exact read set and order a standalone decode of that
    window accepts. Returns (rw_member, mask)."""
    mask = (rw_g.read_start < m_hi) & (rw_g.read_end > m_lo)
    sel = np.flatnonzero(mask)
    g2l = np.cumsum(mask) - 1
    dm = mask[rw_g.del_rid] if len(rw_g.del_rid) else np.zeros(0, bool)
    im = mask[rw_g.ins_rid] if len(rw_g.ins_rid) else np.zeros(0, bool)
    z32 = np.zeros(0, np.int32)
    return ReadWindow(
        contig=contig, start=m_lo, end=m_hi,
        qnames=[rw_g.qnames[i] for i in sel],
        flags=rw_g.flags[sel], strand=rw_g.strand[sel],
        read_start=rw_g.read_start[sel], read_end=rw_g.read_end[sel],
        hp=rw_g.hp[sel].copy(), ps=rw_g.ps[sel].copy(),
        ev_rid=z32, ev_pos=z32.copy(), ev_code=np.zeros(0, np.int8),
        ev_qpos=z32.copy(),
        del_rid=g2l[rw_g.del_rid[dm]].astype(np.int32),
        del_start=rw_g.del_start[dm], del_len=rw_g.del_len[dm],
        ins_rid=g2l[rw_g.ins_rid[im]].astype(np.int32),
        ins_pos=rw_g.ins_pos[im], ins_len=rw_g.ins_len[im],
        seqs=[rw_g.seqs[i] for i in sel] if rw_g.seqs else [],
        seq_provider=(
            (lambda rids, qs, win, _p=rw_g.seq_provider, _sel=sel:
             _p(_sel[np.asarray(rids, np.int64)], qs, win))
            if rw_g.seq_provider is not None else None)), mask


def _fill_member_events(rw_g: ReadWindow, rw_m: ReadWindow, mask, cols):
    """Slice the group's emitted pseudo-events down to one member's
    columns + reads (ids remapped). A read covering a member column
    necessarily overlaps the member window, so this reproduces exactly
    what a standalone member emit would produce, in the same
    (rid, col) order."""
    g2l = np.cumsum(mask) - 1
    if cols and len(rw_g.ev_pos):
        cols_arr = np.asarray(sorted(cols), np.int64)
        idx = np.searchsorted(cols_arr, rw_g.ev_pos)
        hit = idx < len(cols_arr)
        hit[hit] = cols_arr[idx[hit]] == rw_g.ev_pos[hit]
        hit &= mask[rw_g.ev_rid]
        rw_m.ev_rid = g2l[rw_g.ev_rid[hit]].astype(np.int32)
        rw_m.ev_pos = rw_g.ev_pos[hit]
        rw_m.ev_code = rw_g.ev_code[hit]
        rw_m.ev_qpos = rw_g.ev_qpos[hit]
    rw_m.emitted_cols = frozenset(int(c) for c in cols)


def get_indel_group_candidates(bam, fasta, members, *, seq_type="ont",
                               mincov=4, maxcov=160, ins_t=0.4, del_t=0.6,
                               win_size=40, small_win_size=4,
                               impute_indel_phase=False, exclude=None,
                               tags=None):
    """Shared-decode indel job collection for coordinate-adjacent chunks
    (same contig), on the host only: one deferred decode + ONE
    pseudo-event emit serve the whole group; each member is then scanned
    over exactly its own window with a member-local read-id space, so
    finish_indel_jobs makes every member's batch element-identical to
    get_indel_candidates run chunk by chunk. A CRAM input (no two-phase
    indel decode) goes member by member (collect_chunk_jobs).

    Returns the members' job records (collect_msa_jobs), aligned with
    members (per-member 'ploidy' respected); nothing is aligned here."""
    contig = members[0]["chrom"]
    spans = [(max(0, m["start"] - 1 - 10 - win_size), m["end"])
             for m in members]
    g_lo = min(s for s, _ in spans)
    g_end = max(e for _, e in spans)
    dd = indel_deferred_decode(bam, contig, g_lo, g_end)
    if dd is None:
        return [collect_chunk_jobs(
            bam, fasta, m, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
            ins_t=ins_t, del_t=del_t, win_size=win_size,
            small_win_size=small_win_size,
            impute_indel_phase=impute_indel_phase, exclude=exclude,
            ploidy=m.get("ploidy", "diploid"), tags=tags)
            for m in members]
    rw_g = dd.window
    _inject_tags(rw_g, tags)
    chrom_len = fasta.get_reference_length(contig)
    window_after = 260 if seq_type == "pacbio" else 160

    prepped = []
    all_cols = set()
    for m, (m_lo, m_end) in zip(members, spans):
        start0 = m["start"] - 1
        haploid = m.get("ploidy", "diploid") == "haploid"
        rw_m, mask = _member_indel_window(rw_g, contig, m_lo, m_end)
        scan_cols = np.arange(start0, m_end, dtype=np.int64)
        if exclude is not None:
            scan_cols = scan_cols[~exclude.mask(contig, scan_cols)]
        if len(scan_cols):
            triggers = _compute_triggers(
                rw_m, scan_cols, win_size=win_size,
                small_win_size=small_win_size, mincov=mincov, ins_t=ins_t,
                del_t=del_t,
                impute_indel_phase=impute_indel_phase and not haploid,
                haploid=haploid)
        else:
            triggers = (np.zeros(0, bool), np.zeros(0, bool),
                        np.zeros(0, bool))
        cols = _event_columns_needed(scan_cols, triggers, win_size)
        all_cols.update(cols)
        prepped.append((m_lo, haploid, rw_m, mask, scan_cols, triggers,
                        cols))

    dd.finish_events(all_cols)  # ONE emit for the whole group

    try:
        out = []
        for m_lo, haploid, rw_m, mask, scan_cols, triggers, cols in prepped:
            _fill_member_events(rw_g, rw_m, mask, cols)
            cview = _ColumnView(rw_m)
            variants, extra = _select_candidates(
                rw_m, scan_cols, triggers, win_size, mincov,
                sig_provider=None if haploid else cview.signature_groups)
            out.append(collect_msa_jobs(
                rw_m, cview, variants, extra, fasta, contig, chrom_len, m_lo,
                window_after=window_after, win_size=win_size, mincov=mincov,
                maxcov=maxcov, haploid=haploid))
        return out
    finally:
        dd.close()  # frees the C++ record store backing seq_provider


def collect_msa_jobs(rw, cview, variants, extra, fasta, contig, chrom_len,
                     scan_lo, *, window_after, win_size, mincov, maxcov,
                     haploid):
    """Pass 2, phase A, on the host (no torch): per selected candidate,
    the reads' windows cut at the candidate, sampled by msa_sample per
    haplotype group, and the reference window.

    Returns the picklable job record finish_indel_jobs takes: {"contig",
    "haploid", "mincov", "jobs": [{"v1", "mr", "ref", "seqs", "ps"}]}."""
    max_range = {0: max(10, win_size), 1: 10}
    hap1_set = set(np.flatnonzero(rw.hp == 1).tolist())
    hap2_set = set(np.flatnonzero(rw.hp == 2).tolist())

    from ..align.msa import msa_sample

    group_keys = ("tot",) if haploid else ("h0", "h1", "tot")
    jobs = []
    for v0 in sorted(variants):
        if v0 < scan_lo:
            continue
        ref_end = min(chrom_len, v0 + window_after + 1)
        ref_win = fasta.fetch(contig, v0, ref_end)
        if not ref_win:
            continue
        codes_ok = REF_N_LUT[np.frombuffer(ref_win.encode(), dtype=np.uint8)]
        if not codes_ok.all():
            continue
        if v0 in extra:
            names0, names1 = extra[v0]
        else:
            names0, names1 = hap1_set, hap2_set
        d, first_h0_rid = extract_candidate_windows(
            rw, cview, v0, window_after, names0, names1)
        if not d["tot"]:
            continue
        v1 = v0 + 1
        seqs_by_group = {}
        for key in group_keys:
            names = msa_sample(d[key], v1, maxcov)
            seqs_by_group[key] = [d[key][n] for n in names]
        ps = int(rw.ps[first_h0_rid]) if (
            first_h0_rid is not None and rw.ps[first_h0_rid] >= 0) else None
        jobs.append({"v1": v1, "mr": max_range[variants[v0]],
                     "ref": ref_win, "seqs": seqs_by_group, "ps": ps})
    return {"contig": contig, "haploid": haploid, "mincov": mincov,
            "jobs": jobs}


def n_jobs(records):
    """Candidates (MSA jobs) in a list of job records."""
    return sum(len(r["jobs"]) for r in records)


def finish_indel_jobs(records, device="cuda"):
    """Pass 2 after phase A, in the process that owns the device, for
    the job records of any number of chunks (collect_msa_jobs).

    Round 1 aligns the read-vs-ref pairs of every record in one
    BatchAligner.align_many call (K1 + K2 on "cuda", their plain twins on
    "cpu"); then the MSA projection and consensus of each job; round 2
    aligns every record's consensus-vs-ref allele pairs in one call; then
    the allele prediction and the tensors. A pair's cigar does not depend
    on the pairs it shares a launch with, so each record's batch equals
    the one it would get alone. Returns one IndelBatch (HaploidIndelBatch
    for a haploid record) per record."""
    from ..align.batch_nw import BatchAligner
    from ..align.msa import (MSA_GAP_EXTEND, MSA_GAP_OPEN, MSA_MATCH,
                             MSA_MISMATCH, star_msa_from_cigars)

    keys_of = lambda rec: ("tot",) if rec["haploid"] else ("h0", "h1", "tot")

    # round 1: every record's read-vs-ref alignments in one device sweep
    pairs = [(s, job["ref"]) for rec in records for job in rec["jobs"]
             for key in keys_of(rec) for s in job["seqs"][key]]
    flat = iter(BatchAligner(match=MSA_MATCH, mismatch=MSA_MISMATCH,
                             gap_open=MSA_GAP_OPEN, gap_extend=MSA_GAP_EXTEND,
                             device=device).align_many(pairs))

    # column projection + consensus per job, then round 2: allele NW
    per_rec = []
    allele_pairs = []
    for rec in records:
        keys = keys_of(rec)
        group_mincov = {"h0": 2, "h1": 2, "tot": rec["mincov"]}
        per_job = []
        for job in rec["jobs"]:
            res = {}
            for key in keys:
                cig = [next(flat) for _ in job["seqs"][key]]
                res[key] = star_msa_from_cigars(
                    job["seqs"][key], cig, job["ref"], group_mincov[key])
            ok = all(res[key][0] for key in keys)
            per_job.append((job, res, ok))
            if ok:
                for key in keys:
                    _, _, _, cns, ref_d = res[key]
                    allele_pairs.append((cns, ref_d))
        per_rec.append(per_job)
    allele_cigars = iter(BatchAligner(device=device).align_many(
        [(a or "", b or "") for a, b in allele_pairs]))
    return [_assemble_batch(rec, per_job, keys_of(rec), allele_cigars)
            for rec, per_job in zip(records, per_rec)]


def _assemble_batch(rec, per_job, group_keys, allele_cigars):
    """Allele prediction and tensor assembly of one record's jobs; takes
    its allele cigars from the shared iterator, in job order."""
    haploid = rec["haploid"]
    out_pos, out_x0, out_x1, out_x2, out_alleles, out_phase = [], [], [], [], [], []
    hap_out_x, hap_out_alleles = [], []
    for job, res, ok in per_job:
        if not ok:
            continue
        preds = {}
        for key in group_keys:
            _, _, x, cns, ref_d = res[key]
            cig = next(allele_cigars)
            if cig is not None and (not cns or not ref_d):
                cig = None
            preds[key] = allele_prediction(cns, ref_d, job["mr"], cigar=cig)
        out_pos.append(job["v1"])
        if haploid:
            hap_out_x.append(res["tot"][2])
            hap_out_alleles.append(preds["tot"])
        else:
            out_x0.append(res["h0"][2])
            out_x1.append(res["h1"][2])
            out_x2.append(res["tot"][2])
            out_phase.append(job["ps"])
            out_alleles.append((preds["h0"], preds["h1"], preds["tot"]))

    contig = rec["contig"]
    if haploid:
        x = np.stack(hap_out_x) if hap_out_x else np.zeros((0, 5, 128, 2), np.float32)
        return HaploidIndelBatch(contig=contig, pos=out_pos, x=x,
                                 alleles=hap_out_alleles)
    stack = lambda xs: (np.stack(xs).astype(np.float32)
                        if xs else np.zeros((0, 5, 128, 2), np.float32))
    return IndelBatch(contig=contig, pos=out_pos, x0=stack(out_x0),
                      x1=stack(out_x1), x2=stack(out_x2),
                      alleles=out_alleles, phase=out_phase)
