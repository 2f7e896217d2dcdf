"""VCF evaluation harness: precision/recall/F1 vs a truth set.

Fills the role rtg vcfeval plays in the reference's quality workflow
(docs/ONT_Case_Study.md:61-68): genotype-aware matching of calls against
a truth VCF (optionally restricted to a BED), swept over QUAL thresholds
with the best-F1 row reported — the layout of the case-study tables.

    python -m nanocaller_tpu_torch.tools.vcf_compare --calls out.vcf.gz \
        --truth truth.vcf.gz [--bed conf.bed] [--type snp|indel|all] \
        [--ref ref.fa]

With --ref, records that fail exact normalized-key matching get a
second, haplotype-aware pass (vcfeval's core idea): nearby variants are
clustered, every phasing consistent with the genotypes is enumerated,
and a cluster matches when some phasing of the calls reconstructs the
same unordered haplotype-sequence pair as the truth — so MNP-vs-SNPs,
split/joined indels, anchor shifts, and 1|2 representations all compare
equal. Differences from rtg vcfeval: no maximal-subset search inside a
failed cluster (all-or-nothing per cluster) and matching is decided once
using all calls rather than re-solved per QUAL threshold.

The JAX package's tools/vcf_compare.py on the port's VCF, FASTA and BED
readers: the same flags and the same metrics.
"""

import argparse
import itertools
import json

from ..io.bed import BedIntervals
from ..io.fasta import FastaFile
from ..io.vcf import VcfReader


def norm_gt(gt):
    if gt is None:
        return None
    parts = gt.replace("|", "/").split("/")
    try:
        return tuple(sorted(int(p) for p in parts))
    except ValueError:
        return None


def normalize_allele(pos, ref, alt):
    """Trim shared suffix then prefix (keeping ≥1 base) and shift pos —
    so equivalent indel representations (different anchors) compare
    equal. Not full vcfeval haplotype-equivalence, but removes the
    common anchor-choice mismatches."""
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt = ref[1:], alt[1:]
        pos += 1
    return pos, ref, alt


def rec_key(rec):
    """Genotype-aware variant key with normalized alleles."""
    alleles = [rec.ref] + rec.alt.split(",")
    gt = norm_gt(rec.sample_field("GT")) or (1, 1)
    try:
        called = [alleles[i] for i in gt]
    except IndexError:
        called = [alleles[-1], alleles[-1]]
    normed = []
    base = None
    for a in called:
        p, r, x = normalize_allele(rec.pos, rec.ref, a)
        normed.append((p, r, x))
    normed.sort()
    return (rec.chrom, tuple(normed))


def is_snp_rec(rec):
    return len(rec.ref) == 1 and all(len(a) == 1 for a in rec.alt.split(","))


class Variant:
    """One VCF record reduced to what matching needs."""

    __slots__ = ("chrom", "pos0", "ref", "hap_alleles", "phased", "qual",
                 "key", "matched", "support")

    def __init__(self, rec):
        self.chrom = rec.chrom
        self.pos0 = rec.pos - 1
        self.ref = rec.ref
        alleles = [rec.ref] + rec.alt.split(",")
        gt = rec.sample_field("GT") or "1/1"
        self.phased = "|" in gt and "/" not in gt
        idx = []
        for p in gt.replace("|", "/").split("/"):
            try:
                idx.append(int(p))
            except ValueError:
                idx.append(0)
        if len(idx) == 1:  # haploid call → same allele on both haplotypes
            idx = [idx[0], idx[0]]
        idx = idx[:2]
        try:
            self.hap_alleles = tuple(alleles[i] for i in idx)
        except IndexError:
            self.hap_alleles = (alleles[-1], alleles[-1])
        self.qual = rec.qual_value
        self.key = rec_key(rec)
        self.matched = False
        self.support = None  # truth side: min qual of supporting calls

    @property
    def end0(self):
        return self.pos0 + len(self.ref)

    @property
    def is_het(self):
        return self.hap_alleles[0] != self.hap_alleles[1]


def load(path, bed=None, vtype="all"):
    """Legacy key→qual view (kept for scripts that used the flat API)."""
    return {v.key: v.qual for v in load_variants(path, bed, vtype)}


def load_variants(path, bed=None, vtype="all"):
    out = []
    for rec in VcfReader(path):
        if rec.alt in (".", ""):
            continue
        if bed is not None and not bed.overlaps(rec.chrom, rec.pos - 1):
            continue
        if vtype == "snp" and not is_snp_rec(rec):
            continue
        if vtype == "indel" and is_snp_rec(rec):
            continue
        out.append(Variant(rec))
    return out


def _apply(ref_seq, span_start, edits):
    """Apply (pos0, ref, alt) edits to ref_seq (which starts at
    span_start); edits must be position-sorted and non-overlapping.
    Returns None on overlap (inconsistent haplotype)."""
    parts = []
    cur = 0
    for pos0, ref, alt in edits:
        off = pos0 - span_start
        if off < cur:
            return None
        parts.append(ref_seq[cur:off])
        parts.append(alt)
        cur = off + len(ref)
    parts.append(ref_seq[cur:])
    return "".join(parts)


def _hap_pair(ref_seq, span_start, variants, orient):
    """Build the unordered haplotype-sequence pair for a phasing choice.

    orient: per-variant 0/1 — whether to swap that variant's two
    genotype alleles between haplotype A and B.
    """
    haps = ([], [])
    for v, o in zip(variants, orient):
        a, b = v.hap_alleles if not o else v.hap_alleles[::-1]
        if a != v.ref:
            haps[0].append((v.pos0, v.ref, a))
        if b != v.ref:
            haps[1].append((v.pos0, v.ref, b))
    pair = []
    for edits in haps:
        edits.sort()
        s = _apply(ref_seq, span_start, edits)
        if s is None:
            return None
        pair.append(s)
    return tuple(sorted(pair))


def _phasings(variants, max_free=12):
    """Yield orientation vectors consistent with the genotypes: phased
    records keep their given orientation (one global flip covers the
    arbitrary choice of which haplotype is 'first'), unphased hets are
    free bits."""
    free = [i for i, v in enumerate(variants) if v.is_het and not v.phased]
    if len(free) > max_free:
        return
    for flip in (0, 1):
        for bits in itertools.product((0, 1), repeat=len(free)):
            orient = [flip if v.is_het else 0 for v in variants]
            for i, b in zip(free, bits):
                orient[i] = b
            yield orient


def haplotype_cluster_match(fasta, chrom, truth_vars, call_vars, pad=1):
    """True iff some genotype-consistent phasing of calls reconstructs
    the truth haplotype pair over the cluster span."""
    if not truth_vars or not call_vars:
        return False
    span_start = min(v.pos0 for v in truth_vars + call_vars) - pad
    span_start = max(0, span_start)
    span_end = max(v.end0 for v in truth_vars + call_vars) + pad
    ref_seq = fasta.fetch(chrom, span_start, span_end)
    if len(ref_seq) < span_end - span_start:
        span_end = span_start + len(ref_seq)
    truth_pairs = set()
    for orient in _phasings(truth_vars):
        p = _hap_pair(ref_seq, span_start, truth_vars, orient)
        if p is not None:
            truth_pairs.add(p)
    if not truth_pairs:
        return False
    for orient in _phasings(call_vars):
        p = _hap_pair(ref_seq, span_start, call_vars, orient)
        if p is not None and p in truth_pairs:
            return True
    return False


def _clusters(variants, gap=30):
    """Group position-sorted variants whose ref spans sit within `gap`."""
    out = []
    cur = []
    cur_end = None
    for v in sorted(variants, key=lambda v: (v.chrom, v.pos0)):
        if cur and (v.chrom != cur[0].chrom or v.pos0 > cur_end + gap):
            out.append(cur)
            cur = []
            cur_end = None
        cur.append(v)
        cur_end = v.end0 if cur_end is None else max(cur_end, v.end0)
    if cur:
        out.append(cur)
    return out


def match_variants(calls, truth, fasta=None):
    """Stage 1: exact normalized-key matching. Stage 2 (with fasta):
    haplotype-aware cluster matching of the leftovers (nearby matched
    records are included in the cluster haplotypes so split/joined
    representations still line up)."""
    by_key = {}
    for t in truth:
        by_key.setdefault(t.key, []).append(t)
    for c in sorted(calls, key=lambda c: -c.qual):
        for t in by_key.get(c.key, []):
            if t.support is None:
                t.support = c.qual
                t.matched = True
                c.matched = True
                break
    if fasta is None:
        return
    if all(v.matched for v in calls) and all(v.matched for v in truth):
        return
    call_ids = {id(v) for v in calls}
    for cluster in _clusters(calls + truth):
        c_vars = [v for v in cluster if id(v) in call_ids]
        t_vars = [v for v in cluster if id(v) not in call_ids]
        un_c = [v for v in c_vars if not v.matched]
        un_t = [v for v in t_vars if not v.matched]
        if not un_t or not un_c:
            continue
        if haplotype_cluster_match(fasta, cluster[0].chrom, t_vars, c_vars):
            support = min(v.qual for v in un_c)
            for v in un_c:
                v.matched = True
            for v in un_t:
                v.matched = True
                v.support = support


def evaluate(calls, truth, thresholds=None):
    """Sweep QUAL thresholds. TP/FP are call-side counts; FN is
    truth-side (a truth record is found at threshold t when its
    supporting call(s) have qual ≥ t)."""
    if thresholds is None:
        quals = sorted({c.qual for c in calls})
        thresholds = quals[:: max(1, len(quals) // 50)] or [0.0]
    rows = []
    n_truth = len(truth)
    for t in thresholds:
        tp = sum(1 for c in calls if c.matched and c.qual >= t)
        fp = sum(1 for c in calls if not c.matched and c.qual >= t)
        found = sum(1 for v in truth if v.support is not None
                    and v.support >= t)
        fn = n_truth - found
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = found / n_truth if n_truth else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        rows.append({"threshold": round(t, 3), "tp": tp, "fp": fp, "fn": fn,
                     "precision": round(prec, 4), "recall": round(rec, 4),
                     "f1": round(f1, 4)})
    best = max(rows, key=lambda r: r["f1"]) if rows else None
    return rows, best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", required=True)
    ap.add_argument("--truth", required=True)
    ap.add_argument("--bed")
    ap.add_argument("--ref", help="reference FASTA; enables haplotype-"
                    "aware matching of representation differences")
    ap.add_argument("--type", default="all", choices=["snp", "indel", "all"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    bed = BedIntervals(args.bed) if args.bed else None
    calls = load_variants(args.calls, bed, args.type)
    truth = load_variants(args.truth, bed, args.type)
    fasta = FastaFile(args.ref) if args.ref else None
    match_variants(calls, truth, fasta)
    rows, best = evaluate(calls, truth)
    if args.json:
        print(json.dumps({"rows": rows, "best": best}))
    else:
        print("threshold\ttp\tfp\tfn\tprecision\trecall\tf1")
        for r in rows:
            print("%(threshold)s\t%(tp)d\t%(fp)d\t%(fn)d\t%(precision)s\t"
                  "%(recall)s\t%(f1)s" % r)
        if best:
            print("# best F1: %(f1)s at QUAL>=%(threshold)s "
                  "(P=%(precision)s R=%(recall)s)" % best)
    return best


if __name__ == "__main__":
    main()
