"""SNP model training CLI — the reference model_run.py's role
(misc/training/README.md) over the port's pipeline, with the flags of
the JAX package's tools/train_snp.py:

1. generate labelled pileups from BAM + truth VCF into npz shards, every
   Nth region to the validation split;
2. train with Adam (5-head CE + L2) on `--device` (cuda unless asked for
   cpu), with per-epoch validation and npz checkpoints loadable directly
   by inference (--snp_model PATH) in either package.

    python -m nanocaller_tpu_torch.train.train_snp --bam hg002.bam \\
        --ref ref.fa --truth_vcf truth.vcf.gz --regions chr1 chr2 \\
        --output train_out --epochs 50 \\
        [--retrain_from nanocaller_tpu/models/params/snp_ONT-HG002.npz]
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bam", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--truth_vcf", required=True)
    ap.add_argument("--include_bed",
                    help="accepted as the JAX package's CLI accepts it; "
                         "not used by either")
    ap.add_argument("--regions", nargs="*", help="contig or contig:start-end")
    ap.add_argument("--output", required=True)
    ap.add_argument("--sequencing", default="ont")
    ap.add_argument("--mincov", type=int, default=8)
    ap.add_argument("--maxcov", type=int, default=160)
    ap.add_argument("--neighbor_threshold", default="0.4,0.6")
    ap.add_argument("--chunk_size", type=int, default=1_000_000)
    ap.add_argument("--val_every", type=int, default=40,
                    help="every Nth chunk goes to validation "
                         "(reference: generate_SNP_pileups.py:348)")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--retrain_from", help="npz pack to fine-tune from")
    ap.add_argument("--train_coverage", type=float,
                    help="write a .coverage sidecar with this depth")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (cuda without a GPU "
                         "raises)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..io.bam import BamReader
    from ..io.fasta import FastaFile
    from ..io.vcf import VcfReader
    from ..models.weights import params_from_npz
    from ..runtime.chunker import get_regions_list
    from ..runtime.device import resolve_device
    from .data import (generate_snp_training_examples, load_shards,
                       save_shard, truth_snps)
    from .snp_train import train_snp_model

    resolve_device(args.device)  # before hours of example generation
    os.makedirs(args.output, exist_ok=True)
    bam = BamReader(args.bam)
    fasta = FastaFile(args.ref)
    vcf = VcfReader(args.truth_vcf)
    thr = tuple(float(x) for x in args.neighbor_threshold.split(","))

    cfg = Config(bam=args.bam, ref=args.ref, regions=args.regions)
    regions = get_regions_list(cfg, bam)

    train_files, val_files = [], []
    n_chunk = 0
    for contig, start, end, _ in regions:
        for cs in range(start, end + 1, args.chunk_size):
            ce = min(end, cs + args.chunk_size - 1)
            truth = truth_snps(vcf, contig, max(1, cs - 50000) + 1,
                               ce + 50000)
            ex = generate_snp_training_examples(
                bam, fasta, truth, {"chrom": contig, "start": cs, "end": ce},
                seq_type=args.sequencing, mincov=args.mincov,
                maxcov=args.maxcov, nbr_threshold=thr, seed=n_chunk)
            if not len(ex["gt"]):
                n_chunk += 1
                continue
            path = os.path.join(args.output, "%s_%s_%d.npz" % (
                "val" if n_chunk % args.val_every == args.val_every - 1
                else "train", contig, cs))
            save_shard(path, ex)
            (val_files if path.split(os.sep)[-1].startswith("val")
             else train_files).append(path)
            n_chunk += 1
            print("chunk %s:%d-%d → %d examples" % (contig, cs, ce,
                                                    len(ex["gt"])),
                  flush=True)

    train_ex = load_shards(train_files)
    val_ex = load_shards(val_files) if val_files else None
    print("training on %d examples (%s validation)" % (
        len(train_ex["gt"]),
        len(val_ex["gt"]) if val_ex is not None else "no"), flush=True)

    init = params_from_npz(args.retrain_from) if args.retrain_from else None
    params, history = train_snp_model(
        train_ex, val_ex, args.output, epochs=args.epochs, lr=args.lr,
        batch_size=args.batch_size, init_params=init, device=args.device)
    if args.train_coverage:
        for h in history:
            with open(h["ckpt"].replace(".npz", ".coverage"), "w") as fh:
                fh.write("%s\n" % args.train_coverage)
    best = max(history, key=lambda h: (h["val_acc"] or 0))
    print("best: epoch %(epoch)d val_acc %(val_acc)s ckpt %(ckpt)s" % best)
    return history


if __name__ == "__main__":
    main()
