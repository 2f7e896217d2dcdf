"""Synthetic diploid genome / long-read simulator.

Generates a reference FASTA plus a coordinate-sorted, indexed BAM with
planted SNPs and indels on two haplotypes, optional HP/PS haplotags, and
configurable substitution + sequencing-indel error rates — entirely with
the port's I/O stack. A copy of the part of nanocaller_tpu/sim.py that
chip_smoke.py needs to write its fixtures (same draws from the same
seed), with the port's own fixture writers.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .io.bam import AlignedRead, BamWriter

BASES = "ACGT"


_BASE_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_seq(rng, n):
    # same rng draw as the original generator-join, so sequences are
    # seed-identical; the byte-LUT path is ~100x faster at chr scale
    return bytes(_BASE_BYTES[rng.integers(0, 4, size=n)]).decode()


def make_diploid_readset(
    rng,
    ref_seq,
    snps=(),
    indels=(),
    depth=30,
    read_len=800,
    error_rate=0.0,
    indel_error_rate=0.0,
    contig_start=0,
):
    """Simulate reads from two haplotypes of one contig.

    snps: list of (pos0, alt_base, genotype) with genotype in {"het1", "het2",
          "hom"} — het1 puts alt on haplotype 1 only, het2 on haplotype 2.
    indels: list of (pos0, kind, seq_or_len, genotype), kind in {"ins","del"}.
    Returns list of (qname, start0, seq, cigar, hap).
    """
    # Build the two haplotype sequences plus a ref-coordinate map for each.
    haps = []
    for h in (1, 2):
        edits = {}
        for pos, alt, gt in snps:
            if gt == "hom" or (gt == "het1" and h == 1) or (gt == "het2" and h == 2):
                edits[pos] = ("X", alt)
        for pos, kind, val, gt in indels:
            if gt == "hom" or (gt == "het1" and h == 1) or (gt == "het2" and h == 2):
                edits[pos] = (kind, val)
        haps.append(edits)

    # Pre-build per-haplotype mutated sequences by ref segment so read
    # construction is slicing + a short edit walk, not per-base Python.
    L = len(ref_seq)
    hap_data = []
    for edits in haps:
        positions = sorted(edits)
        # segments of untouched reference between edit anchors
        mutated = []
        seg_ref_start = []  # ref coordinate where each output segment starts
        cursor = 0
        events = []  # (ref_pos, kind, payload) for cigar construction
        for p in positions:
            kind, val = edits[p]
            if p < cursor:
                continue
            mutated.append(ref_seq[cursor:p])
            if kind == "X":
                mutated.append(val)
                events.append((p, "X", 1))
                cursor = p + 1
            elif kind == "ins":
                mutated.append(ref_seq[p] + val)
                events.append((p, "I", len(val)))
                cursor = p + 1
            else:  # del
                dlen = int(val)
                mutated.append(ref_seq[p])
                events.append((p, "D", dlen))
                cursor = p + 1 + dlen
        mutated.append(ref_seq[cursor:])
        hap_data.append((edits, events))

    reads = []
    n_reads = max(1, depth * L // read_len)
    starts = rng.integers(0, max(1, L - read_len // 2), size=n_reads)
    for i in range(n_reads):
        hap = 1 + (i % 2)
        start = int(starts[i])
        end = min(L, start + read_len)
        edits, events = hap_data[hap - 1]
        seq_parts = []
        cigar = []

        def push(op, n):
            if n <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + n)
            else:
                cigar.append((op, n))

        p = start
        for ep, kind, val in events:
            if ep < p:
                continue
            if ep >= end:
                break
            seq_parts.append(ref_seq[p:ep])
            push("M", ep - p)
            if kind == "X":
                seq_parts.append(edits[ep][1])
                push("M", 1)
                p = ep + 1
            elif kind == "I":
                seq_parts.append(ref_seq[ep] + edits[ep][1])
                push("M", 1)
                push("I", val)
                p = ep + 1
            else:  # D
                seq_parts.append(ref_seq[ep])
                push("M", 1)
                push("D", min(val, end - ep - 1))
                p = ep + 1 + val
        if p < end:
            seq_parts.append(ref_seq[p:end])
            push("M", end - p)
        seq = "".join(seq_parts)
        if error_rate > 0:
            arr = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
            mask = rng.random(len(arr)) < error_rate
            subs = rng.integers(0, 4, size=int(mask.sum()))
            arr[mask] = np.frombuffer(b"ACGT", dtype=np.uint8)[subs]
            seq = arr.tobytes().decode()
        if indel_error_rate > 0:
            # sprinkle 1-2bp sequencing indels (ONT's dominant error mode):
            # split M runs at random points into M-I-M / M-D-M
            seq, cigar = _inject_indel_errors(rng, seq, cigar,
                                              indel_error_rate)
        reads.append(("read_%04d" % i, contig_start + start, seq, cigar, hap))
    return reads


def _inject_indel_errors(rng, seq, cigar, rate):
    out_cigar = []
    out_seq = []
    qi = 0
    for op, l in cigar:
        if op != "M" or l < 8:
            out_cigar.append((op, l))
            if op in ("M", "I"):
                out_seq.append(seq[qi : qi + l])
                qi += l
            continue
        n_err = rng.binomial(l, rate)
        if n_err == 0:
            out_cigar.append((op, l))
            out_seq.append(seq[qi : qi + l])
            qi += l
            continue
        cuts = np.sort(rng.integers(2, l - 2, size=n_err))
        prev = 0
        for c in cuts:
            c = int(c)
            if c - prev < 2:
                continue
            out_cigar.append(("M", c - prev))
            out_seq.append(seq[qi + prev : qi + c])
            ln = int(rng.integers(1, 3))
            if rng.integers(2):  # insertion error
                out_cigar.append(("I", ln))
                out_seq.append(random_seq(rng, ln))
                prev = c
            else:  # deletion error: skip ln matched bases
                ln = min(ln, l - c - 2)
                if ln <= 0:
                    out_cigar.append(("M", 0))
                    prev = c
                    continue
                out_cigar.append(("D", ln))
                prev = c + ln
        if l - prev > 0:
            out_cigar.append(("M", l - prev))
            out_seq.append(seq[qi + prev : qi + l])
        qi += l
    # merge zero/adjacent runs
    merged = []
    for op, l in out_cigar:
        if l <= 0:
            continue
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + l)
        else:
            merged.append((op, l))
    return "".join(out_seq), merged


_CIGAR_OP_NUM = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}


def write_bam(path, contig, contig_len, reads, tags_by_name=None, mapq=60,
              tag_haplotypes=False, phase_set=1):
    """reads: list of (qname, pos0, seq, cigar_list_of_(opchar,len), hap).

    tag_haplotypes=True writes HP/PS tags from each read's hap (simulating
    a whatshap-haplotagged BAM, the indel path's input)."""
    recs = []
    for qname, pos, seq, cigar, hap in reads:
        cig = [(_CIGAR_OP_NUM[op], l) for op, l in cigar]
        flag = 0
        tags = dict(tags_by_name.get(qname, {})) if tags_by_name else {}
        if tag_haplotypes:
            tags.setdefault("HP", hap)
            tags.setdefault("PS", phase_set)
        recs.append(
            AlignedRead(qname, flag, 0, pos, mapq, cig, seq,
                        np.full(len(seq), 30, np.uint8), tags)
        )
    recs.sort(key=lambda r: r.pos)
    with BamWriter(path, [contig], [contig_len]) as w:
        for r in recs:
            w.write(r)
    return path


def write_bam_multi(path, contig_reads, contig_lens, tag_haplotypes=False,
                    mapq=60):
    """contig_reads: {contig: reads list}; contig_lens: {contig: len}."""
    names = list(contig_lens)
    recs = []
    for ci, contig in enumerate(names):
        for qname, pos, seq, cigar, hap in contig_reads.get(contig, []):
            cig = [(_CIGAR_OP_NUM[op], l) for op, l in cigar]
            tags = {"HP": hap, "PS": 1} if tag_haplotypes else {}
            recs.append(AlignedRead("%s_%s" % (contig, qname), 0, ci, pos,
                                    mapq, cig, seq,
                                    np.full(len(seq), 30, np.uint8), tags))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    with BamWriter(path, names, [contig_lens[n] for n in names]) as w:
        for r in recs:
            w.write(r)
    return path


def write_truth_vcf(path, contig, ref_seq, snps=(), indels=(), sample="TRUTH"):
    """Emit the planted variants as a truth VCF (the training inputs)."""
    return write_truth_vcf_multi(path, {contig: (ref_seq, snps, indels)},
                                 sample=sample)


def write_truth_vcf_multi(path, per_contig, sample="TRUTH"):
    """Multi-contig truth VCF. per_contig: {name: (ref_seq, snps, indels)}
    in the desired header/record contig order."""
    from .io.vcf import VcfRecord, VcfWriter

    hdr = ["##fileformat=VCFv4.2"]
    hdr += ["##contig=<ID=%s>" % c for c in per_contig]
    hdr += ['##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s"
            % sample]
    with VcfWriter(path, hdr) as w:
        for contig, (ref_seq, snps, indels) in per_contig.items():
            recs = []
            for pos, alt, gt in snps:
                gt_str = "1/1" if gt == "hom" else "0/1"
                recs.append(VcfRecord(contig, pos + 1, ref_seq[pos], alt,
                                      "50", "PASS", format_="GT",
                                      samples=[gt_str]))
            for pos, kind, val, gt in indels:
                gt_str = "1/1" if gt == "hom" else "0/1"
                if kind == "ins":
                    ref, alt = ref_seq[pos], ref_seq[pos] + val
                else:
                    ref, alt = ref_seq[pos : pos + 1 + int(val)], ref_seq[pos]
                recs.append(VcfRecord(contig, pos + 1, ref, alt, "50",
                                      "PASS", format_="GT",
                                      samples=[gt_str]))
            recs.sort(key=lambda r: r.pos)
            for r in recs:
                w.write(r)
    return path


def _plant(ref, snp_every, indel_every, hom_only=False):
    """A SNP every `snp_every` bp (het1, het2, hom in turn, or all hom;
    the alt never the ref base) and, unless hom_only, a 1-6 bp insertion
    or deletion every `indel_every` bp, away from the SNPs."""
    length = len(ref)
    gts = ("hom",) * 3 if hom_only else ("het1", "het2", "hom")
    snps = []
    for k, p in enumerate(range(snp_every // 2, length - snp_every // 2,
                                snp_every)):
        alt = BASES[(BASES.index(ref[p]) + 1 + k % 3) % 4]
        snps.append((p, alt, gts[k % 3]))
    indels = []
    if not hom_only:
        for k, p in enumerate(range(indel_every // 2 + snp_every // 4,
                                    length - indel_every // 2, indel_every)):
            if k % 2:
                indels.append((p, "del", 1 + k % 6, gts[k % 3]))
            else:
                indels.append((p, "ins", "ACGTTG"[: 1 + k % 6], gts[k % 3]))
    return snps, indels


def write_all_fixture(out_dir, length, seed, snp_every=1000,
                      indel_every=5000, depth=30, read_len=8000,
                      error_rate=0.03, indel_error_rate=0.01,
                      contig="chr_t"):
    """The `--mode all` fixture: one contig of `length` bp with a planted
    SNP every `snp_every` bp (het1, het2, hom in turn; the alt never the
    ref base) and a planted 1-6 bp insertion or deletion every
    `indel_every` bp (het1, het2, hom in turn), away from the SNPs; reads
    from both haplotypes with substitution and 1-2 bp indel errors,
    written to an UNTAGGED BAM (no HP/PS: the run's phasing tags them).
    Returns (fasta path, bam path, snps, indels, number of reads)."""
    import os

    from .io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    ref = random_seq(rng, length)
    snps, indels = _plant(ref, snp_every, indel_every)
    reads = make_diploid_readset(rng, ref, snps=snps, indels=indels,
                                 depth=depth, read_len=read_len,
                                 error_rate=error_rate,
                                 indel_error_rate=indel_error_rate)
    fasta_p = os.path.join(out_dir, "all_ref.fa")
    bam_p = os.path.join(out_dir, "all_reads.bam")
    write_fasta(fasta_p, {contig: ref})
    write_bam(bam_p, contig, length, reads)
    return fasta_p, bam_p, snps, indels, len(reads)


def write_train_fixture(out_dir, length, seed, snp_every=1000,
                        indel_every=5000, depth=30, read_len=8000,
                        error_rate=0.03, indel_error_rate=0.01,
                        contig="chr_t"):
    """The training fixture: write_all_fixture's contig (the same draws
    from the same seed) as an untagged BAM (the SNP examples' input), a
    haplotagged copy (the indel examples' input: HP from each read's
    haplotype, PS 1) and a truth VCF of the planted variants. Returns
    (fasta path, bam path, tagged bam path, truth VCF path, snps,
    indels)."""
    import os

    from .io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    ref = random_seq(rng, length)
    snps, indels = _plant(ref, snp_every, indel_every)
    reads = make_diploid_readset(rng, ref, snps=snps, indels=indels,
                                 depth=depth, read_len=read_len,
                                 error_rate=error_rate,
                                 indel_error_rate=indel_error_rate)
    paths = [os.path.join(out_dir, "train_" + name) for name in
             ("ref.fa", "reads.bam", "tagged.bam", "truth.vcf.gz")]
    write_fasta(paths[0], {contig: ref})
    write_bam(paths[1], contig, length, reads)
    write_bam(paths[2], contig, length, reads, tag_haplotypes=True)
    write_truth_vcf(paths[3], contig, ref, snps, indels)
    return (*paths, snps, indels)


def write_contigs_fixture(out_dir, contigs, depth=30, read_len=8000,
                          error_rate=0.03, indel_error_rate=0.01):
    """write_all_fixture over several contigs in one FASTA and one
    UNTAGGED BAM. contigs: [(name, length, seed, snp_every, indel_every,
    hom_only)], in header order; each contig is planted as
    write_all_fixture plants one (hom_only: hom SNPs and no indel, as a
    haploid chrX gets), from its own seed. Returns (fasta path, bam path,
    {name: (snps, indels)}, number of reads)."""
    import os

    from .io.fasta import write_fasta

    seqs, planted, recs = {}, {}, []
    for ci, (name, length, seed, snp_every, indel_every, hom_only) in \
            enumerate(contigs):
        rng = np.random.default_rng(seed)
        seqs[name] = random_seq(rng, length)
        snps, indels = _plant(seqs[name], snp_every, indel_every, hom_only)
        planted[name] = (snps, indels)
        for qname, pos, seq, cigar, _hap in make_diploid_readset(
                rng, seqs[name], snps=snps, indels=indels, depth=depth,
                read_len=read_len, error_rate=error_rate,
                indel_error_rate=indel_error_rate):
            recs.append(AlignedRead(
                "%s_%s" % (name, qname), 0, ci, pos, 60,
                [(_CIGAR_OP_NUM[op], n) for op, n in cigar], seq,
                np.full(len(seq), 30, np.uint8), {}))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    fasta_p = os.path.join(out_dir, "contigs_ref.fa")
    bam_p = os.path.join(out_dir, "contigs_reads.bam")
    write_fasta(fasta_p, seqs)
    with BamWriter(bam_p, list(seqs), [len(x) for x in seqs.values()]) as w:
        for r in recs:
            w.write(r)
    return fasta_p, bam_p, planted, len(recs)


TIE_KINDS = ("homopolymer", "str", "identical")


def tie_heavy_pairs(rng, n, Q, R, kind):
    """n (query, ref) string pairs whose NW traceback is decided by ties,
    with len(query) <= Q and len(ref) <= R: "homopolymer" (a run of one
    base between short random flanks, against the same with the run 1-3
    bases shorter or longer), "str" (a short tandem repeat, ACAC... or
    AAG..., against the same with one unit inserted or deleted) or
    "identical" (equal random sequences)."""
    if kind not in TIE_KINDS:
        raise ValueError("kind must be one of %s" % (TIE_KINDS,))
    cap = min(Q, R)
    pairs = []
    for _ in range(n):
        if kind == "identical":
            s = random_seq(rng, int(rng.integers(1, cap + 1)))
            pairs.append((s, s))
            continue
        fl = int(rng.integers(0, min(8, cap // 4) + 1))
        left, right = random_seq(rng, fl), random_seq(rng, fl)
        if kind == "homopolymer":
            unit = BASES[int(rng.integers(4))]
            d = int(rng.integers(1, 4))
        else:
            unit = random_seq(rng, int(rng.integers(2, 5)))
            d = 1
        u = len(unit)
        room = (cap - 2 * fl) // u  # units that fit the shorter bound
        runs = max(d + 1, int(rng.integers(max(d + 1, room // 2),
                                           max(d + 2, room + 1))))
        a, b = runs, runs - d if rng.random() < 0.5 else runs + d
        q = left + unit * a + right
        r = left + unit * b + right
        pairs.append((q[:Q], r[:R]))
    return pairs



def random_group_wire(rng, S, N, B, max_span=None, bitmask=True,
                      exc_share=0.5, hole_share=1 / 6, seq_type="ont",
                      nbr_share=0.8, span_all=False):
    """A random SNP group payload with B candidate rows, for holding the
    SNP group kernel K3 against its twin: S union sites; N reads in random
    order (not sorted by start), a tenth of them with no observation
    (lo = 1 > hi = 0), the others covering spans of at most max_span sites
    (default S), and with span_all one more read, at a random place,
    covering every site; random site codes 0-4; a random minor-bit mask
    over all spans (none without `bitmask`); among the covered cells up to
    exc_share of them as exceptions with random codes and up to
    hole_share as holes (disjoint, each sorted by (site, rid)).
    Neighbours: the sites lie 200, 2,000 or 20,000 bp apart on average
    (chosen at random, so that bands are dense or sparse), and
    about nbr_share of them are neighbour sites (nbr_pos sorted, nbr_union
    their site indices; nbr_share 0 gives none). Rows: random centre
    sites at their positions, random coverage scales, and member windows
    [lo_c, hi_c) of the neighbour arrays: a third the whole list, a third
    random, a third cut at random distances around the candidate (these
    empty some bands).

    Returns (wire, cand_site, cand_pos, lo_c, hi_c, norm): wire holds
    host arrays under SnpGroupFeatures' field names, with seq_type
    (pileup.snp_pileup.group_wire takes it)."""
    max_span = max_span or S
    lo = rng.integers(0, S, N)
    hi = np.minimum(lo + rng.integers(0, max_span, N), S - 1)
    empty = rng.random(N) < 0.1
    lo = np.where(empty, 1, lo).astype(np.int32)
    hi = np.where(empty, 0, hi).astype(np.int32)
    if span_all:
        at = int(rng.integers(0, N + 1))
        lo = np.insert(lo, at, 0).astype(np.int32)
        hi = np.insert(hi, at, S - 1).astype(np.int32)
        N += 1
    spans = np.maximum(hi.astype(np.int64) - lo + 1, 0)
    total = int(spans.sum())
    minor_bits = (rng.integers(0, 256, (total + 7) // 8).astype(np.uint8)
                  if bitmask else np.zeros(0, np.uint8))
    # every covered cell as a (site, rid) key, in key order
    rid = np.repeat(np.arange(N, dtype=np.int64), spans)
    site = (np.repeat(lo.astype(np.int64), spans) + np.arange(total)
            - np.repeat(np.cumsum(spans) - spans, spans))
    keys = np.sort(site * N + rid)
    perm = rng.permutation(total)
    n_exc = int(rng.integers(0, int(total * exc_share) + 1))
    n_hole = int(rng.integers(0, int(total * hole_share) + 1))
    exc = np.sort(keys[perm[:n_exc]])
    hole = np.sort(keys[perm[n_exc:n_exc + n_hole]])
    i32 = lambda a: np.asarray(a).astype(np.int32)
    gap = int(rng.choice((200, 2000, 20000)))
    site_pos = np.cumsum(rng.integers(1, 2 * gap, S))
    nbr_union = np.flatnonzero(rng.random(S) < nbr_share)
    nbr_pos = site_pos[nbr_union]
    wire = SimpleNamespace(
        read_lo=lo, read_hi=hi,
        site_ref=rng.integers(0, 5, S).astype(np.int8),
        site_major=rng.integers(0, 5, S).astype(np.int8),
        site_minor=rng.integers(0, 5, S).astype(np.int8),
        minor_bits=minor_bits, exc_site=i32(exc // N), exc_rid=i32(exc % N),
        exc_code=rng.integers(0, 5, n_exc).astype(np.int8),
        hole_site=i32(hole // N), hole_rid=i32(hole % N),
        nbr_pos=i32(nbr_pos), nbr_union=i32(nbr_union), seq_type=seq_type)
    cand_site = rng.integers(0, S, B).astype(np.int32)
    cand_pos = i32(site_pos[cand_site])
    M = len(nbr_pos)
    kind = rng.integers(0, 3, B)
    lo_r = rng.integers(0, M + 1, B)
    hi_r = lo_r + (rng.random(B) * (M + 1 - lo_r)).astype(np.int64)
    reach = 40 * gap
    lo_n = np.searchsorted(nbr_pos, cand_pos - rng.integers(0, reach, B))
    hi_n = np.searchsorted(nbr_pos, cand_pos + rng.integers(0, reach, B))
    lo_c = i32(np.select([kind == 0, kind == 1], [0, lo_r], lo_n))
    hi_c = i32(np.select([kind == 0, kind == 1], [M, hi_r], hi_n))
    norm = rng.uniform(0.3, 3.0, B).astype(np.float32)
    return wire, cand_site, cand_pos, lo_c, hi_c, norm


def random_dense_batch(rng, B, R, deep_share=0.25):
    """Random inputs of the dense SNP pileup (kernel K5) at B rows and R
    reads, in the manner of a dense SnpBatch: per row the first `depth`
    reads masked in (deep_share of the rows with every read, as a deep
    row's sample fills the read axis), the reads past it masked out but
    carrying random codes (which must count nothing); codes 0-4 with one
    in five 4 (no base); 1-20 valid columns a side around the centre,
    col_ref 4 at the others; a random centre ref (4, N, in one row of
    fifty) and coverage scale.

    Returns (codes int8 (B, R, 41), read_mask bool (B, R), col_ref int8
    (B, 41), col_valid bool (B, 41), center_ref int8 (B,), norm float32
    (B,))."""
    codes = rng.integers(0, 5, (B, R, 41)).astype(np.int8)
    depth = np.where(rng.random(B) < deep_share, R,
                     rng.integers(0, R + 1, B))
    read_mask = np.arange(R)[None, :] < depth[:, None]
    cols = np.arange(41)[None, :]
    n_left = rng.integers(1, 21, B)[:, None]
    n_right = rng.integers(1, 21, B)[:, None]
    col_valid = (cols >= 20 - n_left) & (cols <= 20 + n_right)
    col_ref = np.where(col_valid, rng.integers(0, 4, (B, 41)), 4)
    center_ref = np.where(rng.random(B) < 0.02, 4, col_ref[:, 20])
    col_ref[:, 20] = center_ref
    norm = rng.uniform(0.3, 3.0, B).astype(np.float32)
    return (codes, read_mask, col_ref.astype(np.int8), col_valid,
            center_ref.astype(np.int8), norm)


# K4 nw_cigar's hand-built edge inputs (cigar_edge_case): the bucket pairs
# the main path ((Q, 192)), --preset ccs ((Q, 320)) and the training
# features ((128, 128)) launch, and the batch sizes one over where
# csrc/nw_cigar.cu on a 132-SM card goes from 4 warps a pair to 2 (132
# pairs), from 2 to 1 (264) and past one wave of 32 CTAs an SM (4,224)
CIGAR_EDGE_BUCKETS = ((64, 192), (128, 192), (192, 192), (64, 320),
                      (128, 320), (192, 320), (256, 320), (320, 320),
                      (128, 128))
CIGAR_EDGE_LABELS = (("boundaries", "bad", "bad_small", "one_pair",
                      "pairs_133", "pairs_265", "pairs_4225")
                     + tuple("bucket_%dx%d" % qr for qr in CIGAR_EDGE_BUCKETS))
# K5 snp_dense_pileup's edge inputs (dense_edge_case): read axes around a
# 16-byte load, csrc/snp_dense_pileup.cu's tile of 224 reads and a byte
# counter's range, one row, and B = 133 (four rows a CTA leave one in the
# last)
DENSE_EDGE_LABELS = tuple("R%d" % R for R in (0, 1, 15, 17, 224, 225, 255,
                                              256, 300)) \
    + ("one_row_R45", "one_row_R300", "full_column")
# the raw bytes of K4's edge pairs: mostly ACGT, some N and soft-masked
_EDGE_LETTERS = np.frombuffer(b"ACGTNacgtn", np.uint8)
_EDGE_P = np.array([0.2] * 4 + [0.05] + [0.025] * 4 + [0.05])


def _edge_walk(rng, n, Q, R):
    """n ops (1 diag, 2 ins, 3 del) in forward order consuming at most Q
    query and R reference bytes (n <= Q + R), in runs of 1-40 of one op
    where the bytes left allow it."""
    walk, qi, ri = [], 0, 0
    while len(walk) < n:
        op, run = int(rng.choice((1, 1, 2, 3))), int(rng.integers(1, 41))
        for _ in range(min(run, n - len(walk))):
            left = n - len(walk)
            cap = (Q - qi) + (R - ri)
            o = op
            if o == 1 and (qi >= Q or ri >= R or cap - 2 < left - 1):
                o = 2 if qi < Q else 3
            if o == 2 and qi >= Q:
                o = 3
            if o == 3 and ri >= R:
                o = 2
            walk.append(o)
            qi += o in (1, 2)
            ri += o in (1, 3)
    return walk


def cigar_edge_rows(rng, Q, R, rows):
    """Inputs of K4 nw_cigar built row by row: `rows` holds one (h, n,
    fault[, pos]) a pair, h the last non-zero step (-1 for an all-zero
    row) and n <= h + 1 the non-zero steps at and below it: h the top one,
    the others at random places under it (or at the row positions `pos`,
    in walk order from h down), zero steps between. The walk is valid (at
    most Q query and R reference bytes) unless `fault` says: ("code", k,
    v) puts code v at walk step k, ("ins",) and ("del",) make every step
    an insertion or a deletion (bad once n > Q, or n > R). The raw bytes
    are "ACGTNacgtn" at random, the reference byte equal to the query
    byte at nine in ten diagonal steps (long '=' runs).

    Returns ops (B, T) int8 with T = 2(Q + R) + 2, qraw (B, Q) and rraw
    (B, R) uint8."""
    T = 2 * (Q + R) + 2
    B = len(rows)
    ops = np.zeros((B, T), np.int8)
    qraw = _EDGE_LETTERS[rng.choice(10, (B, Q), p=_EDGE_P)]
    rraw = _EDGE_LETTERS[rng.choice(10, (B, R), p=_EDGE_P)]
    for b, (h, n, fault, *pos) in enumerate(rows):
        if h < 0:
            continue
        kind = fault[0] if fault else None
        if kind in ("ins", "del"):
            walk = [2 if kind == "ins" else 3] * n
        else:
            walk = _edge_walk(rng, n, Q, R)
        if kind == "code":
            walk[fault[1]] = fault[2]
        qi = ri = 0
        for o in walk:
            if o == 1 and qi < Q and ri < R and rng.random() < 0.9:
                rraw[b, ri] = qraw[b, qi]
            qi += o in (1, 2)
            ri += o in (1, 3)
        if pos:
            at = np.asarray(pos[0], np.int64)
        else:
            under = np.sort(rng.choice(h, n - 1, replace=False))[::-1] \
                if n > 1 else np.zeros(0, np.int64)
            at = np.concatenate([[h], under]).astype(np.int64)
        ops[b, at] = walk
    return ops, qraw, rraw


def _random_rows(rng, B, Q, R):
    """B valid rows at random: h anywhere in the row (one in eight all
    zero), as many non-zero steps as the bytes allow."""
    T = 2 * (Q + R) + 2
    rows = []
    for _ in range(B):
        if rng.random() < 0.125:
            rows.append((-1, 0, None))
            continue
        h = int(rng.integers(0, T))
        rows.append((h, int(rng.integers(1, min(h + 1, Q + R) + 1)), None))
    return rows


def cigar_edge_case(label):
    """One of K4's edge inputs by label (CIGAR_EDGE_LABELS), each from its
    own seed: (ops, qraw, rraw) as cigar_edge_rows returns them.

    - boundaries: (192, 192), T = 770, the last non-zero step of each pair
      at the first or last byte of a 16-, 32- or 128-byte block of the op
      array, at a walk of 1, 32, 33, 64 or 65 steps, at the row's last
      byte, or no step at all (count 0);
    - bad: (64, 192), T = 514: codes 5, -3 and 4 at a stream's first,
      middle and last step, and insertions (deletions) past Q (R) in a
      middle or the last chunk of 32 steps, between valid rows;
    - bad_small: (8, 8), T = 34: the same faults in the first chunk and
      in the second, which is the last;
    - one_pair: B = 1 at (192, 192);
    - pairs_133, pairs_265, pairs_4225: B one over the kernel's changes
      of warps a pair and one over a wave, at (192, 192);
    - bucket_QxR: B = 64 random rows at each CIGAR_EDGE_BUCKETS pair."""
    rng = np.random.default_rng(4000 + CIGAR_EDGE_LABELS.index(label))
    if label == "boundaries":
        Q = R = 192
        T = 2 * (Q + R) + 2
        rows = []
        for b in range(120):
            kind = b % 12
            base = b * T  # the row's first byte in the op array
            if kind < 6:  # first / last byte of a 16, 32, 128-byte block
                block = (16, 32, 128)[kind // 2]
                cands = [h for h in range(T)
                         if (base + h) % block == (0, block - 1)[kind % 2]]
                h = int(rng.choice(cands))
            elif kind < 10:
                h = (0, 31, 32, 64)[kind - 6] + int(rng.integers(0, 2))
            elif kind == 10:
                h = T - 1
            else:
                rows.append((-1, 0, None))
                continue
            rows.append((h, int(rng.integers(1, min(h + 1, Q + R) + 1)),
                         None))
        return cigar_edge_rows(rng, Q, R, rows)
    if label in ("bad", "bad_small"):
        Q, R = (64, 192) if label == "bad" else (8, 8)
        T = 2 * (Q + R) + 2
        n = min(Q + R, 150)
        h = T - 1 - int(rng.integers(0, 3))
        rows = []
        for v in (5, -3, 4):
            for k in (0, n // 2, n - 1):
                rows.append((h, n, ("code", k, v)))
                rows.append((h, int(rng.integers(1, n + 1)), None))
        if label == "bad":
            # the (Q+1)-th insertion at step 64 of 65 (in the last chunk of
            # 32 row positions) or of 200 (a middle one); the (R+1)-th
            # deletion at the last of 193 or a middle step of 300
            for kind, m in (("ins", Q + 1), ("ins", 200), ("del", R + 1),
                            ("del", 300)):
                rows.append((m - 1 + int(rng.integers(0, 3)), m, (kind,)))
        else:
            # the 9th insertion or deletion in the first chunk (row
            # positions 20 down to 12), or at row position 0, the second
            # and last chunk of a walk from 33
            for kind in ("ins", "del"):
                rows.append((20, 9, (kind,), range(20, 11, -1)))
                rows.append((33, 9, (kind,), [*range(33, 25, -1), 0]))
        rows.append((-1, 0, None))
        return cigar_edge_rows(rng, Q, R, rows)
    if label == "one_pair":
        return cigar_edge_rows(rng, 192, 192, [(300, 250, None)])
    if label.startswith("pairs_"):
        return cigar_edge_rows(rng, 192, 192,
                               _random_rows(rng, int(label[6:]), 192, 192))
    Q, R = map(int, label[len("bucket_"):].split("x"))
    return cigar_edge_rows(rng, Q, R, _random_rows(rng, 64, Q, R))


def dense_edge_case(label):
    """One of K5's edge inputs by label (DENSE_EDGE_LABELS), each from its
    own seed, as random_dense_batch returns them: R0 ... R300, B = 133
    rows at that read axis (R0 without a read; a third of the rows with
    a read mask at random rather than a prefix); one_row_R45 and
    one_row_R300, B = 1; full_column, B = 133 at R = 256, every read of
    a row masked in with one centre base and, at one column, one base,
    so that one count equals R."""
    rng = np.random.default_rng(5000 + DENSE_EDGE_LABELS.index(label))
    if label.startswith("one_row_R"):
        return random_dense_batch(rng, 1, int(label[len("one_row_R"):]),
                                  deep_share=1.0)
    R = 256 if label == "full_column" else int(label[1:])
    codes, mask, col_ref, col_valid, center_ref, norm = \
        random_dense_batch(rng, 133, R)
    scatter = rng.random(133) < 1 / 3
    mask[scatter] = rng.random((int(scatter.sum()), R)) < 0.6
    if label == "full_column":
        for b in range(133):
            mask[b] = True
            codes[b, :, 20] = rng.integers(0, 4)
            w = int(rng.integers(0, 41))
            codes[b, :, w] = codes[b, 0, 20] if w == 20 else \
                rng.integers(0, 4)
    return codes, mask, col_ref, col_valid, center_ref, norm
