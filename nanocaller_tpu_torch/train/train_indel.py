"""Indel model training CLI (reference model_run_indels.py's role), with
the flags of the JAX package's tools/train_indel.py.

Feature generation smears truth indel positions into candidate anchors
per sequencing type and tensorizes through the same hap-split MSA
machinery as inference (train/indel_data.py; its alignments on the NW
kernels on `--device cuda`, their plain twins on `--device cpu`);
training uses 4-class CE + L2 with npz checkpoints loadable by inference
(--indel_model PATH) in either package.

    python -m nanocaller_tpu_torch.train.train_indel --bam phased.bam \\
        --ref ref.fa --truth_vcf truth.vcf.gz --regions chr1 \\
        --output itrain --epochs 30
"""

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bam", required=True, help="haplotagged BAM")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--truth_vcf", required=True)
    ap.add_argument("--regions", nargs="*")
    ap.add_argument("--output", required=True)
    ap.add_argument("--sequencing", default="ont")
    ap.add_argument("--mincov", type=int, default=4)
    ap.add_argument("--maxcov", type=int, default=160)
    ap.add_argument("--win_size", type=int, default=40)
    ap.add_argument("--chunk_size", type=int, default=100_000)
    ap.add_argument("--neg_fraction", type=float, default=0.01)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--retrain_from")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the alignments run and the model trains "
                         "(cuda without a GPU raises)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..io.bam import BamReader
    from ..io.fasta import FastaFile
    from ..io.vcf import VcfReader
    from ..models.weights import params_from_npz
    from ..runtime.chunker import get_regions_list
    from ..runtime.device import resolve_device
    from .indel_data import generate_indel_training_examples, truth_indels
    from .indel_train import train_indel_model

    resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    bam = BamReader(args.bam)
    fasta = FastaFile(args.ref)
    vcf = VcfReader(args.truth_vcf)
    cfg = Config(bam=args.bam, ref=args.ref, regions=args.regions)
    regions = get_regions_list(cfg, bam)

    xs, ls = [], []
    for k, (contig, start, end, _) in enumerate(regions):
        for cs in range(start, end + 1, args.chunk_size):
            ce = min(end, cs + args.chunk_size - 1)
            truth = truth_indels(vcf, contig, cs, ce)
            x, labels, pos = generate_indel_training_examples(
                bam, fasta, truth, {"chrom": contig, "start": cs, "end": ce},
                seq_type=args.sequencing, mincov=args.mincov,
                maxcov=args.maxcov, win_size=args.win_size,
                neg_fraction=args.neg_fraction, seed=k, device=args.device)
            if len(x):
                xs.append(x)
                ls.append(labels)
                print("chunk %s:%d-%d → %d examples (%d variant-labelled)"
                      % (contig, cs, ce, len(x), int((labels > 0).sum())),
                      flush=True)
    x = np.concatenate(xs) if xs else np.zeros((0, 15, 128, 2), np.float32)
    labels = np.concatenate(ls) if ls else np.zeros(0, np.int64)
    print("training on %d examples" % len(x), flush=True)

    init = params_from_npz(args.retrain_from) if args.retrain_from else None
    params, history = train_indel_model(
        x, labels, args.output, epochs=args.epochs, lr=args.lr,
        batch_size=args.batch_size, init_params=init, device=args.device)
    print("final loss %.4f, last ckpt %s" % (history[-1]["loss"],
                                             history[-1]["ckpt"]))
    return history


if __name__ == "__main__":
    main()
