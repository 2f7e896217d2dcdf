"""Per-SNP read-name extraction by allele.

In-repo equivalent of misc/get_SNP_readnames.py: for every biallelic SNP
in a VCF, list the read names supporting each allele at that column.
Output: CONTIG<TAB>POS<TAB>REF:names,...<TAB>ALT:names,... per record
(same layout as the reference's allele_str, :38-40).

    python -m nanocaller_tpu_torch.tools.snp_readnames --vcf calls.vcf.gz \
        --bam reads.bam --output names.txt

The JAX package's tools/snp_readnames.py on the port's BamReader,
decode_reads and SiteCodes.
"""

import argparse

import numpy as np

from ..io.bam import BamReader
from ..io.vcf import VcfReader
from ..pileup.engine import SiteCodes, decode_reads

CODE_OF = {"A": 0, "G": 1, "T": 2, "C": 3, "*": 4}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--bam", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    vcf = VcfReader(args.vcf)
    by_contig = {}
    for rec in vcf:
        alleles = [rec.ref] + rec.alt.split(",")
        if max(len(a) for a in alleles) == 1:
            by_contig.setdefault(rec.chrom, []).append((rec.pos, alleles))

    bam = BamReader(args.bam)
    with open(args.output, "w") as out:
        for contig, sites in by_contig.items():
            sites.sort()
            pos0 = np.array([p - 1 for p, _ in sites], dtype=np.int64)
            lo, hi = int(pos0.min()), int(pos0.max()) + 1
            rw = decode_reads(bam, contig, lo, hi)
            sc = SiteCodes(rw, pos0)
            for k, (pos1, alleles) in enumerate(sites):
                rids, codes = sc.at(k)
                names_by_code = {}
                for rid, c in zip(rids, codes):
                    names_by_code.setdefault(int(c), []).append(rw.qnames[rid])
                allele_str = "\t".join(
                    "%s:%s" % (a, ",".join(names_by_code.get(CODE_OF.get(a, 4), [])))
                    for a in alleles)
                out.write("%s\t%d\t%s\n" % (contig, pos1, allele_str))


if __name__ == "__main__":
    main()
