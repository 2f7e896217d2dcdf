"""Measure the statistics the traffic files hold, by running the port's
own host feature code on the CPU over a simulated read set.

    python benchmark/tools/derive_traffic.py --preset ont --out DIR

One contig of --length bp (a planted SNP every 1,000 bp and a 1-6 bp
indel every 6,000 bp, as HG002 carries about 1.2 SNPs and 0.17 indels a
kb) is read at the preset's depth, read length and error profile
(nanocaller_tpu_torch.sim), written to DIR, cut into the CLI's 500 kb SNP
chunks and fed through get_snp_group_payloads (one decode group of every
chunk). It prints one JSON object of the statistics that
benchmark/traffic/*.json copy where no production figure stands in
(the mix's `measured` and `production` keys say which); the benchmark
itself never runs this script or the port's host feature code, so a
later change to that code does not move its inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# depth, read length and error rates of each preset's simulated reads
# (listed as `assumed` in the configuration files)
PROFILES = {
    "ont": dict(seq_type="ont", depth=48, read_len=20000, error_rate=0.05,
                indel_error_rate=0.03, threshold=(0.4, 0.6)),
}


def _snp_stats(bam, fasta, chunks, prof, length):
    from nanocaller_tpu_torch.pileup.snp_features import (
        SnpGroupFeatures, get_snp_group_payloads)
    from nanocaller_tpu_torch.pileup.snp_pileup import site_depth

    pays = get_snp_group_payloads(
        bam, fasta, chunks, seq_type=prof["seq_type"], mincov=4, maxcov=160,
        min_allele_freq=0.15, min_nbr_sites=1, threshold=prof["threshold"])
    gf = pays[0]
    assert isinstance(gf, SnpGroupFeatures) and len(pays) == 1
    S, N = len(gf.site_ref), len(gf.read_lo)
    lo, hi = gf.read_lo.astype(np.int64), gf.read_hi.astype(np.int64)
    spans = np.maximum(hi - lo + 1, 0)
    cells = int(spans.sum())
    bits = np.unpackbits(gf.minor_bits, bitorder="little")[:cells]
    members = [sec for _oi, sec in gf.members if sec is not None]
    B = sum(len(m) for m in members)
    deep = sum(len(m.deep_idx) for m in members)
    depth = site_depth(gf)
    site_pos = np.zeros(S, np.int64)
    site_pos[gf.nbr_union] = gf.nbr_pos
    gaps = np.diff(np.asarray(gf.nbr_pos, np.int64))
    cand_sites = np.concatenate([m.cand_site for m in members])
    mb = length / 1e6
    return {
        "members": len(gf.members), "union_sites_per_mb": S / mb,
        "cands_per_mb": B / mb, "reads_per_mb": N / mb,
        "nbrs_per_mb": len(gf.nbr_pos) / mb,
        "cand_share_of_sites": B / S,
        "nbr_share_of_sites": len(gf.nbr_pos) / S,
        "read_span_sites_mean": float(spans[spans > 0].mean()),
        "read_span_sites_p10_p90": [float(np.percentile(spans[spans > 0], q))
                                    for q in (10, 90)],
        "empty_read_share": float((spans == 0).mean()),
        "exception_share": len(gf.exc_rid) / cells,
        "hole_share": len(gf.hole_rid) / cells,
        "minor_bit_share": float(bits.mean()) if cells else 0.0,
        "exc_code_hist": np.bincount(gf.exc_code, minlength=5).tolist(),
        "deep_row_share": deep / max(B, 1),
        "site_depth_mean": float(depth.mean()),
        "cand_depth_mean": float(depth[cand_sites].mean()),
        "nbr_gap_bp_mean": float(gaps.mean()) if len(gaps) else 0.0,
        "nbr_gap_bp_median": float(np.median(gaps)) if len(gaps) else 0.0,
        "site_ref_hist": np.bincount(gf.site_ref, minlength=5).tolist(),
        "major_is_ref_share": float((gf.site_major == gf.site_ref).mean()),
        "sampled_depth_mean": float(np.mean(np.concatenate(
            [m.sampled_depth for m in members]))),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PROFILES), required=True)
    ap.add_argument("--out", required=True, help="directory for the BAM")
    ap.add_argument("--length", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=11)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from nanocaller_tpu_torch.io.bam import open_alignment
    from nanocaller_tpu_torch.io.fasta import FastaFile, write_fasta
    from nanocaller_tpu_torch.runtime.chunker import get_chunks
    from nanocaller_tpu_torch.sim import (_plant, make_diploid_readset,
                                          random_seq, write_bam)

    prof = PROFILES[a.preset]
    rng = np.random.default_rng(a.seed)
    ref = random_seq(rng, a.length)
    snps, indels = _plant(ref, 1000, 6000)
    reads = make_diploid_readset(
        rng, ref, snps=snps, indels=indels, depth=prof["depth"],
        read_len=prof["read_len"], error_rate=prof["error_rate"],
        indel_error_rate=prof["indel_error_rate"])
    os.makedirs(a.out, exist_ok=True)
    fa, bp = os.path.join(a.out, "ref.fa"), os.path.join(a.out, "reads.bam")
    write_fasta(fa, {"chr_t": ref})
    write_bam(bp, "chr_t", a.length, reads, tag_haplotypes=True)
    fasta = FastaFile(fa)
    bam = open_alignment(bp, fasta=fasta)
    chunks = get_chunks([("chr_t", 1, a.length, "diploid")], 1)
    out = {"preset": a.preset, "length": a.length, "reads": len(reads),
           **{k: v for k, v in prof.items() if k != "threshold"},
           "snp": _snp_stats(bam, fasta, chunks, prof, a.length)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
