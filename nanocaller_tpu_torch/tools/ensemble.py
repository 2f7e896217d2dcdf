"""Cross-caller majority-vote ensemble with QUAL normalization.

Captures the precisionFDA truth-challenge-v2 ensemble pipeline
(misc/precisionFDA_truthchallenge_v2/*: per-caller min-max QUAL
normalizers + genotype majority vote across NanoCaller/Clair/Medaka,
snp_ensemble.py:42-81) as one tool over N input VCFs:

- each caller's QUAL is min-max normalized to [0,1];
- per site, genotypes (as unordered allele pairs) vote; the majority
  genotype wins with votes recorded in INFO and the mean normalized
  QUAL as the score.

    python -m nanocaller_tpu_torch.tools.ensemble --out ens.vcf.gz \
        a.vcf.gz b.vcf.gz c.vcf.gz

The JAX package's tools/ensemble.py on the port's VCF reader and writer.
"""

import argparse

from ..io.vcf import VcfReader, VcfRecord, VcfWriter


def normalized_calls(path):
    recs = list(VcfReader(path))
    quals = [r.qual_value for r in recs if r.qual_value > float("-inf")]
    lo, hi = (min(quals), max(quals)) if quals else (0.0, 1.0)
    span = (hi - lo) or 1.0
    out = {}
    for r in recs:
        gt = (r.sample_field("GT") or "1/1").replace("|", "/")
        try:
            idx = sorted(int(x) for x in gt.split("/"))
        except ValueError:
            continue
        alleles = [r.ref] + r.alt.split(",")
        try:
            pair = tuple(sorted(alleles[i] for i in idx))
        except IndexError:
            continue
        out[(r.chrom, r.pos, r.ref)] = (pair, (r.qual_value - lo) / span)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("vcfs", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sample", default="ENSEMBLE")
    ap.add_argument("--min_votes", type=int, default=None,
                    help="default: strict majority of inputs")
    args = ap.parse_args(argv)
    callers = [normalized_calls(p) for p in args.vcfs]
    need = args.min_votes or (len(callers) // 2 + 1)

    sites = {}
    for calls in callers:
        for key, (pair, q) in calls.items():
            sites.setdefault(key, []).append((pair, q))

    contigs = []
    for key in sites:
        if key[0] not in contigs:
            contigs.append(key[0])
    header = ["##fileformat=VCFv4.2",
              '##FILTER=<ID=PASS,Description="All filters passed">']
    header += ["##contig=<ID=%s>" % c for c in contigs]
    header += ['##INFO=<ID=votes,Number=1,Type=Integer,Description="votes">',
               '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
               '##FORMAT=<ID=GQ,Number=1,Type=Float,Description="Genotype Quality">',
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s"
               % args.sample]

    out_recs = []
    for (chrom, pos, ref), votes in sites.items():
        tally = {}
        for pair, q in votes:
            entry = tally.setdefault(pair, [0, 0.0])
            entry[0] += 1
            entry[1] += q
        pair, (n, qsum) = max(tally.items(), key=lambda kv: (kv[1][0], kv[1][1]))
        if n < need:
            continue
        alts = sorted({a for a in pair if a != ref})
        if not alts:
            continue
        amap = {a: i + 1 for i, a in enumerate(alts)}
        gt = "/".join(str(amap.get(a, 0)) for a in pair)
        q = qsum / n
        out_recs.append(VcfRecord(
            chrom, pos, ref, ",".join(alts), "%.4f" % q, "PASS",
            info="votes=%d" % n, format_="GT:GQ",
            samples=["%s:%.4f" % (gt, q)]))
    rank = {c: i for i, c in enumerate(contigs)}
    out_recs.sort(key=lambda r: (rank[r.chrom], r.pos))
    with VcfWriter(args.out, header) as w:
        for r in out_recs:
            w.write(r)
    print("wrote %s (%d records)" % (args.out, len(out_recs)))


if __name__ == "__main__":
    main()
