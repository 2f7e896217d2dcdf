"""Generate a synthetic validation dataset: reference FASTA, aligned BAM
with planted SNPs/indels under configurable error rates, and the matching
truth VCF — everything needed to validate an install and exercise the
evaluation harness without real sequencing data. The JAX package's
tools/simulate.py on the port's simulator: the same flags, and the same
files byte for byte from the same seed.

    python -m nanocaller_tpu_torch.tools.simulate --output sim/ \
        --length 2000000 --depth 45 --error_rate 0.04 \
        --indel_error_rate 0.01
    python -m nanocaller_tpu_torch.cli --bam sim/reads.bam \
        --ref sim/ref.fa --mode all --output calls/
    python -m nanocaller_tpu_torch.tools.vcf_compare \
        --calls calls/variant_calls.vcf.gz --truth sim/truth.vcf.gz
"""

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--contig", default="chrSim")
    ap.add_argument("--contigs", type=int, default=1,
                    help="split --length across N contigs (chrSim, "
                         "chrSim2, ...): exercises the per-contig "
                         "phase→indel DAG overlap the way a real "
                         "multi-chromosome genome does")
    ap.add_argument("--length", type=int, default=1_000_000)
    ap.add_argument("--depth", type=int, default=40)
    ap.add_argument("--read_len", type=int, default=12000)
    ap.add_argument("--error_rate", type=float, default=0.04)
    ap.add_argument("--indel_error_rate", type=float, default=0.0)
    ap.add_argument("--snp_spacing", type=int, default=700)
    ap.add_argument("--indel_spacing", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--haplotag", action="store_true",
                    help="write HP/PS tags (skip the phasing stage)")
    ap.add_argument("--hp_profile", action="store_true",
                    help="homopolymer-realistic mode: plant hp runs in "
                    "the reference, put half the truth indels inside "
                    "them (expansions/contractions), add "
                    "length-dependent hp slip errors to the reads, and "
                    "write hp_regions.bed / nonhp_regions.bed for "
                    "stratified evaluation")
    ap.add_argument("--hp_slip_rate", type=float, default=0.03,
                    help="per-run slip coefficient (hp_profile only)")
    ap.add_argument("--hp_spacing", type=int, default=2500,
                    help="reference hp-run spacing (hp_profile only)")
    args = ap.parse_args(argv)

    from ..io.fasta import write_fasta
    from ..sim import (make_diploid_readset, random_seq, write_bam,
                       write_bam_multi, write_truth_vcf_multi)

    os.makedirs(args.output, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    def gen_contig(L):
        """One contig's (ref_seq, snps, indels, reads, hp_runs); draws
        from the shared rng, so --contigs 1 reproduces the historical
        single-contig stream exactly."""
        ref_seq = random_seq(rng, L)
        hp_runs = []  # (start, end) of planted homopolymer runs
        if args.hp_profile:
            # plant homopolymer runs (5-14 bp, the ONT failure regime)
            chars = list(ref_seq)
            for pos in range(1200, L - 1200, args.hp_spacing):
                run = int(rng.integers(5, 15))
                base = "ACGT"[int(rng.integers(0, 4))]
                chars[pos : pos + run] = base * run
                hp_runs.append((pos, pos + run))
            ref_seq = "".join(chars)
        snps, indels = [], []
        indel_pos = set()
        hp_iter = iter(hp_runs[1::2])  # every other run gets an indel
        for i, pos in enumerate(range(5000, L - 5000, args.indel_spacing)):
            gt = ("het1", "het2", "hom")[i % 3]
            run = None
            if args.hp_profile and i % 2 == 0:
                run = next(hp_iter, None)
                if run is not None and any(
                        p in indel_pos
                        for p in range(run[0] - 30, run[1] + 30)):
                    run = None  # avoid stacking edits (uncallable truth)
            if run is None and pos in indel_pos:
                continue
            if run is not None:
                # homopolymer expansion/contraction anchored on the head
                a, b = run
                base = ref_seq[a]
                if i % 4 == 0:
                    indels.append((a, "ins", base * (1 + i % 3), gt))
                else:
                    indels.append((a, "del", min(1 + i % 3, b - a - 2), gt))
                indel_pos.update(range(a - 12, b + 12))
            elif i % 2:
                indels.append((pos, "del", 3 + (i % 6), gt))
                indel_pos.update(range(pos - 12, pos + 12))
            else:
                indels.append((pos, "ins", "ACGTAC"[: 3 + (i % 4)], gt))
                indel_pos.update(range(pos - 12, pos + 12))
        for i, pos in enumerate(range(1500, L - 1500, args.snp_spacing)):
            if pos in indel_pos:
                # don't superimpose a SNP on an indel: the combined edit
                # can erase the SNP allele from the reads, planting an
                # uncallable truth record (every lcm(spacings) position)
                continue
            rb = ref_seq[pos]
            snps.append((pos, "ACGT"[("ACGT".index(rb) + 1) % 4],
                         ("het1", "het2", "hom")[i % 3]))

        reads = make_diploid_readset(
            rng, ref_seq, snps=snps, indels=indels, depth=args.depth,
            read_len=args.read_len, error_rate=args.error_rate,
            indel_error_rate=args.indel_error_rate,
            hp_slip_rate=args.hp_slip_rate if args.hp_profile else 0.0)
        return ref_seq, snps, indels, reads, hp_runs

    n_c = max(1, args.contigs)
    names = [args.contig] + ["%s%d" % (args.contig, i + 2)
                             for i in range(n_c - 1)]
    per = {}
    for name in names:
        per[name] = gen_contig(args.length // n_c)

    fasta_p = os.path.join(args.output, "ref.fa")
    write_fasta(fasta_p, {n: per[n][0] for n in names})
    bam_p = os.path.join(args.output, "reads.bam")
    if n_c == 1:
        ref_seq, snps, indels, reads, _ = per[names[0]]
        write_bam(bam_p, names[0], len(ref_seq), reads,
                  tag_haplotypes=args.haplotag)
    else:
        write_bam_multi(bam_p, {n: per[n][3] for n in names},
                        {n: len(per[n][0]) for n in names},
                        tag_haplotypes=args.haplotag)
    vcf_p = write_truth_vcf_multi(
        os.path.join(args.output, "truth.vcf.gz"),
        {n: (per[n][0], per[n][1], per[n][2]) for n in names})
    if args.hp_profile:
        # stratification BEDs (GIAB-style): hp runs ±5 bp, and the
        # complement, so vcf_compare --bed can split F1 in/out of
        # homopolymers like the reference's published tables
        hp_bed = os.path.join(args.output, "hp_regions.bed")
        non_bed = os.path.join(args.output, "nonhp_regions.bed")
        pad = 5
        n_runs = 0
        with open(hp_bed, "w") as fh, open(non_bed, "w") as fn:
            for name in names:
                L = len(per[name][0])
                cursor = 0
                for a, b in per[name][4]:
                    n_runs += 1
                    lo, hi = max(0, a - pad), min(L, b + pad)
                    fh.write(f"{name}\t{lo}\t{hi}\n")
                    if lo > cursor:
                        fn.write(f"{name}\t{cursor}\t{lo}\n")
                    cursor = hi
                if cursor < L:
                    fn.write(f"{name}\t{cursor}\t{L}\n")
        print("wrote %s (%d runs), %s" % (hp_bed, n_runs, non_bed))
    n_reads = sum(len(per[n][3]) for n in names)
    n_snps = sum(len(per[n][1]) for n in names)
    n_indels = sum(len(per[n][2]) for n in names)
    print("wrote %s (%d reads), %s, %s (%d SNPs, %d indels)"
          % (bam_p, n_reads, fasta_p, vcf_p, n_snps, n_indels))
    return fasta_p, bam_p, vcf_p


if __name__ == "__main__":
    main()
