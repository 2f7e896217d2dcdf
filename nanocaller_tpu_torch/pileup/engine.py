"""Chunk read decode → packed event arrays.

Each read's CIGAR is expanded exactly once into three event streams:

- aligned-base events (M/=/X): (read_id, ref_pos, base_code, query_pos)
- deletion events (D):        (read_id, ref_start, length)
- insertion events (I):       (read_id, anchor_ref_pos, length)

Base codes follow the reference's map A=0, G=1, T=2, C=3, other=4
(generate_SNP_pileups.py:104). Insertions are anchored at the reference
position of the PRECEDING aligned base, matching pysam's pileup-string
convention ("A+3TTT" appears on the column before the inserted bases).

From these, per-column counts and per-site read codes are pure
vectorized reductions (column_counts, site_read_codes, SiteCodes).

A copy of nanocaller_tpu/pileup/engine.py. The decode runs the port's C++
library (io/native) for BAM and CRAM; the numpy decode below is its
oracle (decode_reads(use_native=False)), and decodes a CRAM window whose
layout the C++ decoder does not implement.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import DEFAULT_FLAG_FILTER, FREVERSE

# base → code LUT over ASCII (upper+lower); everything else → 4
BASE_CODE_LUT = np.full(256, 4, dtype=np.int8)
for _b, _c in (("A", 0), ("G", 1), ("T", 2), ("C", 3)):
    BASE_CODE_LUT[ord(_b)] = _c
    BASE_CODE_LUT[ord(_b.lower())] = _c

OTHER = 4
# column-count channels: A,G,T,C,N(aligned non-AGTC),DEL
CH_DEL = 5
N_COUNT_CH = 6


@dataclass
class ReadWindow:
    """All reads overlapping a window, decoded to packed arrays."""

    contig: str
    start: int  # 0-based inclusive
    end: int  # 0-based exclusive
    qnames: list = field(default_factory=list)
    flags: np.ndarray = None  # int32[N]
    strand: np.ndarray = None  # int8[N], 1 = reverse
    read_start: np.ndarray = None  # int64[N] 0-based ref start
    read_end: np.ndarray = None  # int64[N] ref end (exclusive)
    hp: np.ndarray = None  # int8[N], 0 = untagged, else HP tag (1/2)
    ps: np.ndarray = None  # int64[N], -1 = none
    # aligned-base events
    ev_rid: np.ndarray = None  # int32[E]
    ev_pos: np.ndarray = None  # int32[E] (ref positions fit int32)
    ev_code: np.ndarray = None  # int8[E]
    ev_qpos: np.ndarray = None  # int32[E]
    # deletion events
    del_rid: np.ndarray = None
    del_start: np.ndarray = None
    del_len: np.ndarray = None
    # insertion events
    ins_rid: np.ndarray = None
    ins_pos: np.ndarray = None
    ins_len: np.ndarray = None
    # query sequences kept for realignment window extraction (indel path)
    seqs: list = field(default_factory=list)
    # lazy alternative to seqs (deferred native decode): callable
    # (rids int32[], qstarts int32[], win) -> list[str], each string
    # == seqs[rid][max(0, q):q+win]; consumers prefer it when set
    seq_provider: object = None
    # (start, end, counts int32[W,6]) — precomputed by the C++ decoder
    counts_cache: tuple = None

    @property
    def n_reads(self):
        return len(self.qnames)


def decode_reads(bam, contig, start, end, flag_exclude=None, keep_seq=False,
                 sites=None, use_native=True):
    """Decode reads overlapping [start, end) (0-based) into a ReadWindow.

    flag_exclude defaults to the reference's pileup filter
    0x4|0x100|0x200|0x400|0x800 (generate_SNP_pileups.py:151-154;
    --supplementary is force-disabled at NanoCaller:160 so 0x800 stays).

    sites: optional sorted 0-based positions; the window then keeps only
    the aligned events at those positions and the deletions spanning one
    of them (what phasing reads), as the JAX package's site-filtered
    decode does.

    Runs the C++ decoder of io/native (BAM, or CRAM through the reader's
    decode_window); use_native=False runs the numpy decode below, its
    bit-identical oracle. A CRAM window whose layout the C++ decoder
    does not implement (decode_window gives None) takes the numpy decode
    over the Python CRAM decoder, counted in the reader's
    python_windows.
    """
    if flag_exclude is None:
        flag_exclude = DEFAULT_FLAG_FILTER
    if use_native and bam.format == "CRAM":
        raw = bam.decode_window(contig, start, end, flag_exclude, keep_seq,
                                sites)
        if raw is not None:
            return _window_from_native(raw, contig, start, end)
        bam.note_python_windows(1)
    elif use_native:
        from ..io.native import decode_window_native

        raw = decode_window_native(bam, contig, start, end, flag_exclude,
                                   keep_seq, sites=sites)
        return _window_from_native(raw, contig, start, end)
    if sites is not None:
        sites = np.asarray(sites, dtype=np.int64)
    qnames, flags, strands, rstarts, rends, hps, pss, seqs = [], [], [], [], [], [], [], []
    ev_rid, ev_pos, ev_code, ev_qpos = [], [], [], []
    del_rid, del_start, del_len = [], [], []
    ins_rid, ins_pos, ins_len = [], [], []

    rid = 0
    for read in bam.fetch(contig, start, end):
        if read.flag & flag_exclude:
            continue
        if not read.seq and any(op in (0, 1, 4, 7, 8) for op, _ in read.cigar):
            continue  # SEQ '*': no base data (matches the C++ decoder)
        qnames.append(read.qname)
        flags.append(read.flag)
        strands.append(1 if read.flag & FREVERSE else 0)
        rstarts.append(read.pos)
        hps.append(int(read.tags.get("HP", 0)))
        pss.append(int(read.tags.get("PS", -1)))
        if keep_seq:
            seqs.append(read.seq)
        codes = BASE_CODE_LUT[np.frombuffer(read.seq.encode(), dtype=np.uint8)]
        rpos = read.pos
        qpos = 0
        for op, length in read.cigar:
            if op in (0, 7, 8):  # M/=/X
                ev_rid.append(np.full(length, rid, np.int32))
                ev_pos.append(np.arange(rpos, rpos + length, dtype=np.int32))
                ev_code.append(codes[qpos : qpos + length])
                ev_qpos.append(np.arange(qpos, qpos + length, dtype=np.int32))
                rpos += length
                qpos += length
            elif op == 1:  # I
                ins_rid.append(rid)
                ins_pos.append(rpos - 1)
                ins_len.append(length)
                qpos += length
            elif op == 2:  # D
                del_rid.append(rid)
                del_start.append(rpos)
                del_len.append(length)
                rpos += length
            elif op == 3:  # N
                rpos += length
            elif op == 4:  # S
                qpos += length
            # H/P consume nothing
        rends.append(rpos)
        rid += 1

    def cat(parts, dtype):
        if not parts:
            return np.zeros(0, dtype)
        return np.concatenate(parts).astype(dtype, copy=False)

    rw_out = ReadWindow(
        contig=contig,
        start=start,
        end=end,
        qnames=qnames,
        flags=np.asarray(flags, np.int32),
        strand=np.asarray(strands, np.int8),
        read_start=np.asarray(rstarts, np.int64),
        read_end=np.asarray(rends, np.int64),
        hp=np.asarray(hps, np.int8),
        ps=np.asarray(pss, np.int64),
        ev_rid=cat(ev_rid, np.int32),
        ev_pos=cat(ev_pos, np.int32),
        ev_code=cat(ev_code, np.int8),
        ev_qpos=cat(ev_qpos, np.int32),
        del_rid=np.asarray(del_rid, np.int32),
        del_start=np.asarray(del_start, np.int32),
        del_len=np.asarray(del_len, np.int32),
        ins_rid=np.asarray(ins_rid, np.int32),
        ins_pos=np.asarray(ins_pos, np.int32),
        ins_len=np.asarray(ins_len, np.int32),
        seqs=seqs,
    )
    if sites is not None:
        # oracle path: full decode then filter aligned events to sites
        idx = np.searchsorted(sites, rw_out.ev_pos)
        hit = idx < len(sites)
        hit[hit] = sites[idx[hit]] == rw_out.ev_pos[hit]
        rw_out.ev_rid = rw_out.ev_rid[hit]
        rw_out.ev_pos = rw_out.ev_pos[hit]
        rw_out.ev_code = rw_out.ev_code[hit]
        rw_out.ev_qpos = rw_out.ev_qpos[hit]
        # deletions: keep only site-spanning ones (the rest are invisible
        # downstream)
        dlo = np.searchsorted(sites, rw_out.del_start)
        dk = dlo < len(sites)
        dk[dk] = sites[dlo[dk]] < (rw_out.del_start + rw_out.del_len)[dk]
        rw_out.del_rid = rw_out.del_rid[dk]
        rw_out.del_start = rw_out.del_start[dk]
        rw_out.del_len = rw_out.del_len[dk]
    return rw_out


def decode_reads_parallel(bam, contig, start, end, sites=None, keep_seq=False,
                          flag_exclude=None, min_span=10_000_000, n_parts=2):
    """Window decode split across threads; output identical to
    decode_reads.

    The whole-contig site-filtered decode of the phasing stage is one
    ~O(contig) native call on one core; splitting the window lets the C
    decoder (which releases the GIL) use spare cores. Reads overlapping a
    boundary are decoded by both parts; the right part's duplicates are a
    position-sorted PREFIX of its read list (BAM is coordinate-sorted)
    and are dropped before the merge, so the merged read order and id
    space equal the single-window decode's. Windows shorter than
    min_span and CRAM inputs take one decode."""
    if end - start < min_span or n_parts < 2 or bam.format != "BAM":
        return decode_reads(bam, contig, start, end,
                            flag_exclude=flag_exclude, keep_seq=keep_seq,
                            sites=sites)
    from concurrent.futures import ThreadPoolExecutor

    bounds = [start + (end - start) * i // n_parts for i in range(n_parts + 1)]
    with ThreadPoolExecutor(n_parts) as ex:
        parts = list(ex.map(
            lambda b: decode_reads(bam, contig, b[0], b[1],
                                   flag_exclude=flag_exclude,
                                   keep_seq=keep_seq, sites=sites),
            zip(bounds[:-1], bounds[1:])))

    # drop each non-first part's boundary-duplicate read prefix, remap
    # ids, concatenate
    qnames, seqs = [], []
    flags, strand, rstart, rend, hp, ps = [], [], [], [], [], []
    ev = {k: [] for k in ("ev_rid", "ev_pos", "ev_code", "ev_qpos",
                          "del_rid", "del_start", "del_len",
                          "ins_rid", "ins_pos", "ins_len")}
    offset = 0
    for i, p in enumerate(parts):
        ndrop = int(np.searchsorted(p.read_start, bounds[i])) if i else 0
        shift = offset - ndrop
        qnames.extend(p.qnames[ndrop:])
        if p.seqs:
            seqs.extend(p.seqs[ndrop:])
        flags.append(p.flags[ndrop:])
        strand.append(p.strand[ndrop:])
        rstart.append(p.read_start[ndrop:])
        rend.append(p.read_end[ndrop:])
        hp.append(p.hp[ndrop:])
        ps.append(p.ps[ndrop:])
        for rid_k, val_ks in (("ev_rid", ("ev_pos", "ev_code", "ev_qpos")),
                              ("del_rid", ("del_start", "del_len")),
                              ("ins_rid", ("ins_pos", "ins_len"))):
            rids = getattr(p, rid_k)
            m = rids >= ndrop
            ev[rid_k].append((rids[m] + shift).astype(np.int32))
            for k in val_ks:
                ev[k].append(getattr(p, k)[m])
        offset += p.n_reads - ndrop

    cat = lambda parts_l, dt: (np.concatenate(parts_l).astype(dt, copy=False)
                               if parts_l else np.zeros(0, dt))
    return ReadWindow(
        contig=contig, start=start, end=end, qnames=qnames,
        flags=cat(flags, np.int32), strand=cat(strand, np.int8),
        read_start=cat(rstart, np.int64), read_end=cat(rend, np.int64),
        hp=cat(hp, np.int8), ps=cat(ps, np.int64),
        ev_rid=cat(ev["ev_rid"], np.int32), ev_pos=cat(ev["ev_pos"], np.int32),
        ev_code=cat(ev["ev_code"], np.int8),
        ev_qpos=cat(ev["ev_qpos"], np.int32),
        del_rid=cat(ev["del_rid"], np.int32),
        del_start=cat(ev["del_start"], np.int32),
        del_len=cat(ev["del_len"], np.int32),
        ins_rid=cat(ev["ins_rid"], np.int32),
        ins_pos=cat(ev["ins_pos"], np.int32),
        ins_len=cat(ev["ins_len"], np.int32),
        seqs=seqs)


class DeferredReadWindow:
    """Two-phase decode handle: counts now, site-filtered events later.

    Used by the SNP path (pileup/snp_features.py): the candidate scan only
    needs per-column counts; per-read codes are needed only at the
    (much sparser) candidate ∪ neighbor site set, which isn't known until
    after the scan. Backed by the native decoder's deferred mode.
    """

    def __init__(self, native_dd, contig, start, end):
        self._dd = native_dd
        self.contig, self.start, self.end = contig, start, end

    def counts(self, start, end):
        """Per-column counts over [start, end) — column_counts contract."""
        return self._dd.counts[start - self.start : end - self.start]

    def finish(self, sites) -> "ReadWindow":
        raw = self._dd.finish(sites)
        return _window_from_native(raw, self.contig, self.start, self.end)

    def close(self):
        self._dd.close()


class CramDeferredWindow:
    """CRAM flavor of DeferredReadWindow: phase 1 is a counts-only
    native slice decode (no per-base events); phase 2 re-decodes the
    window with the site filter (the rANS codecs and feature walk run
    twice, but both passes skip the O(bases) event materialization)."""

    def __init__(self, bam, counts_arr, contig, start, end, flag_exclude):
        self._bam = bam
        self._counts = counts_arr
        self._flagx = flag_exclude
        self.contig, self.start, self.end = contig, start, end

    def counts(self, start, end):
        return self._counts[start - self.start : end - self.start]

    def finish(self, sites) -> "ReadWindow":
        return decode_reads(self._bam, self.contig, self.start, self.end,
                            self._flagx, sites=np.asarray(sites, np.int64))

    def close(self):
        pass


def deferred_decode(bam, contig, start, end, flag_exclude=None):
    """Start a deferred (counts-first) native decode of a BAM (record
    bytes stashed in the handle) or a CRAM (a counts-only first pass).
    None for a CRAM window whose layout the C++ decoder does not
    implement: the caller decodes it with decode_reads, as the JAX
    package does."""
    if flag_exclude is None:
        flag_exclude = DEFAULT_FLAG_FILTER
    if bam.format == "CRAM":
        raw = bam.decode_window(contig, start, end, flag_exclude, False,
                                None, counts_only=True)
        if raw is None:
            return None
        counts = raw.get("counts", np.zeros((0, N_COUNT_CH), np.int32))
        _check_counts(counts, start, end)
        return CramDeferredWindow(bam, counts, contig, start, end,
                                  flag_exclude)
    from ..io.native import decode_window_deferred

    dd = decode_window_deferred(bam, contig, start, end, flag_exclude)
    try:
        _check_counts(dd.counts, start, end)
    except ValueError:
        dd.close()
        raise
    return DeferredReadWindow(dd, contig, start, end)


def _check_counts(counts, start, end):
    # the native decoder keeps per-column counts for windows under 2**31
    # columns
    if counts.shape[0] != end - start:
        raise ValueError("native counts cover %d columns of the %d-column "
                         "window" % (counts.shape[0], end - start))


class IndelDeferredWindow:
    """Two-phase decode handle for the indel path.

    Phase 1 (`window`): a ReadWindow with read metadata, sequences and
    ins/del events but NO aligned-base events — everything the candidate
    scan (pileup/indel_features._compute_triggers) reads. Phase 2
    (`finish_events`): fill ev_* with query-position-or-next
    pseudo-events at exactly the queried columns, one per covering read
    per column — the only aligned-event lookups pass 2 performs
    (pysam query_position_or_next semantics,
    generate_indel_pileups.py:331). Skipping the full M-event
    materialization is the indel-path analog of the SNP path's
    counts-first decode."""

    def __init__(self, dd, rw):
        self._dd = dd
        self.window = rw

    def finish_events(self, cols):
        """cols: iterable of 0-based columns; fills window.ev_* in place.

        keep=True retains the record store: sequence windows are
        expanded lazily via window.seq_provider (emit_qwin) instead of
        materializing every read's full sequence in phase 1 — the
        caller must close() when feature extraction is done."""
        cols_arr = np.asarray(sorted(set(int(c) for c in cols)), np.int64)
        ev_rid, ev_pos, ev_code, ev_qpos = self._dd.emit_qpos(cols_arr,
                                                              keep=True)
        w = self.window
        w.ev_rid, w.ev_pos, w.ev_code, w.ev_qpos = (
            ev_rid, ev_pos, ev_code, ev_qpos)
        # record which columns have events: a query at any other column
        # would silently fall through to an unrelated read's qpos; the
        # _ColumnView consumers check membership so a coverage gap in
        # _event_columns_needed fails loudly instead of corrupting
        # features
        w.emitted_cols = frozenset(cols_arr.tolist())
        return w

    def close(self):
        self._dd.close()


def indel_deferred_decode(bam, contig, start, end, flag_exclude=None):
    """Start a two-phase native indel decode of a BAM; None for a CRAM,
    which the caller decodes in one native pass (decode_reads)."""
    if flag_exclude is None:
        flag_exclude = DEFAULT_FLAG_FILTER
    if bam.format != "BAM":
        return None
    from ..io.native import decode_window_deferred

    dd = decode_window_deferred(bam, contig, start, end, flag_exclude,
                                keep_seq=False, want_counts=False)
    try:
        raw = dd.window_raw()
    except ValueError:
        dd.close()
        raise
    w = _window_from_native(raw, contig, start, end)
    # sequences stay packed in the C++ record store; candidate windows
    # are expanded on demand
    w.seq_provider = dd.emit_qwin
    return IndelDeferredWindow(dd, w)


def _window_from_native(raw, contig, start, end):
    """Assemble a ReadWindow from the native decoder's flat arrays."""
    qn = raw["qnames_raw"].tobytes()
    off = raw["qname_off"]
    qnames = [qn[off[i]:off[i + 1]].decode() for i in range(len(off) - 1)]
    seqs = []
    if raw["seq_off"][-1] > 0:
        sq = raw["seqs_raw"].tobytes()
        soff = raw["seq_off"]
        seqs = [sq[soff[i]:soff[i + 1]].decode() for i in range(len(soff) - 1)]
    return ReadWindow(
        contig=contig, start=start, end=end, qnames=qnames,
        flags=raw["flags"], strand=raw["strand"],
        read_start=raw["read_start"], read_end=raw["read_end"],
        hp=raw["hp"], ps=raw["ps"],
        ev_rid=raw["ev_rid"], ev_pos=raw["ev_pos"], ev_code=raw["ev_code"],
        ev_qpos=raw["ev_qpos"],
        del_rid=raw["del_rid"], del_start=raw["del_start"],
        del_len=raw["del_len"],
        ins_rid=raw["ins_rid"], ins_pos=raw["ins_pos"], ins_len=raw["ins_len"],
        seqs=seqs,
        counts_cache=(start, end, raw["counts"]) if "counts" in raw else None)


def column_counts(rw: ReadWindow, start, end):
    """Per-column base counts over [start, end) (0-based).

    Returns counts int32[(end-start), 6] with channels A,G,T,C,N,DEL.
    ``n_aligned`` (pysam get_num_aligned semantics: non-deletion entries)
    is counts[:, :5].sum(-1).
    """
    if rw.counts_cache is not None:
        cs, ce, cached = rw.counts_cache
        if cs <= start and end <= ce:
            return cached[start - cs : end - cs]
    width = end - start
    m = (rw.ev_pos >= start) & (rw.ev_pos < end)
    # bincount over a fused (pos, code) index — far faster than np.add.at
    fused = (rw.ev_pos[m] - start) * N_COUNT_CH + rw.ev_code[m]
    counts = np.bincount(fused, minlength=width * N_COUNT_CH).astype(np.int32)
    counts = counts.reshape(width, N_COUNT_CH)
    # deletion-covered columns via interval diff + prefix sum
    if len(rw.del_rid):
        ds = np.maximum(rw.del_start, start)
        de = np.minimum(rw.del_start + rw.del_len, end)
        keep = de > ds
        if keep.any():
            diff = np.bincount(ds[keep] - start, minlength=width + 1)
            diff -= np.bincount(de[keep] - start, minlength=width + 1)
            counts[:, CH_DEL] += np.cumsum(diff[:-1]).astype(np.int32)
    return counts


def _ragged_arange(lengths):
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lengths.sum())
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    ends = np.cumsum(lengths)[:-1]
    out[ends] = -(lengths[:-1] - 1)
    return np.cumsum(out)


def site_read_codes(rw: ReadWindow, sites):
    """Sparse per-site read membership: which reads show which code at each site.

    sites: sorted int64 array of 0-based positions.
    Returns (site_idx int32[S], rid int32[S], code int8[S]) sorted by
    (site_idx, rid). Deletion-spanning reads get code 4 ('*' in the
    reference's pileup strings, generate_SNP_pileups.py:104).
    """
    sites = np.asarray(sites, dtype=np.int64)
    # bitmap prefilter: one O(E) gather instead of an O(E log S)
    # searchsorted over all events (events vastly outnumber site hits)
    if len(sites):
        lo, hi = int(sites[0]), int(sites[-1]) + 1
        bitmap = np.zeros(hi - lo, dtype=bool)
        bitmap[sites - lo] = True
        in_range = (rw.ev_pos >= lo) & (rw.ev_pos < hi)
        hit = np.zeros(len(rw.ev_pos), dtype=bool)
        hit[in_range] = bitmap[rw.ev_pos[in_range] - lo]
    else:
        hit = np.zeros(len(rw.ev_pos), dtype=bool)
    hit_pos = rw.ev_pos[hit]
    # search against an int32 view of the (small) site list: the needle
    # arrays are int32 and can be tens of millions long — a mixed-dtype
    # searchsorted would promote-copy every needle array
    sites32 = sites.astype(np.int32)
    idx = np.searchsorted(sites32, hit_pos)
    s_idx = [idx.astype(np.int32)]
    s_rid = [rw.ev_rid[hit]]
    s_code = [rw.ev_code[hit]]
    if len(rw.del_rid):
        lo = np.searchsorted(sites32, rw.del_start, side="left")
        hi = np.searchsorted(sites32, rw.del_start + rw.del_len, side="left")
        span = hi - lo
        keep = span > 0
        if keep.any():
            sidx = (np.repeat(lo[keep], span[keep]) + _ragged_arange(span[keep])).astype(np.int32)
            s_idx.append(sidx)
            s_rid.append(np.repeat(rw.del_rid[keep], span[keep]))
            s_code.append(np.full(len(sidx), OTHER, np.int8))
    site_idx = np.concatenate(s_idx)
    rid = np.concatenate(s_rid)
    code = np.concatenate(s_code)
    if len(site_idx) and int(rid.max()) < (1 << 24):
        # pack (site, rid, code) into one uint64 key and sort it
        # directly: one cache-friendly np.sort + vectorized unpack is ~10x
        # faster than a lexsort + three permutation gathers. (site, rid)
        # pairs are unique — a read has one observation per site — so
        # the order matches the lexsort.
        key = ((site_idx.astype(np.uint64) << np.uint64(32))
               | (rid.astype(np.uint64) << np.uint64(8))
               | (code.astype(np.uint8).astype(np.uint64)))
        key.sort()
        site_idx = (key >> np.uint64(32)).astype(np.int32)
        rid = ((key >> np.uint64(8)) & np.uint64(0xFFFFFF)).astype(np.int32)
        code = (key & np.uint64(0xFF)).astype(np.uint8).astype(np.int8)
        return site_idx, rid, code
    order = np.lexsort((rid, site_idx))
    return site_idx[order], rid[order], code[order]


class SiteCodes:
    """CSR-style view over site_read_codes output for fast per-site lookup."""

    def __init__(self, rw: ReadWindow, sites):
        self.sites = np.asarray(sites, dtype=np.int64)
        site_idx, rid, code = site_read_codes(rw, self.sites)
        self.rid = rid
        self.code = code
        self.indptr = np.searchsorted(
            site_idx, np.arange(len(self.sites) + 1, dtype=site_idx.dtype))

    def at(self, site_i):
        """(rids sorted asc, codes) for site index site_i."""
        lo, hi = self.indptr[site_i], self.indptr[site_i + 1]
        return self.rid[lo:hi], self.code[lo:hi]
