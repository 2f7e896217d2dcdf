"""Indel training feature generation from a truth VCF (the port of
nanocaller_tpu/train/indel_data.py).

Semantics follow misc/training/generate_indel_pileups.py /
*_hifi.py: truth indel positions are smeared into candidate anchors at
pos−{40,30,20,10,0} for ONT (only pos−10/pos for HiFi — the two files'
single difference), negatives are sampled from non-truth columns, and
each anchor is tensorized through the SAME hap0/hap1/all MSA machinery
as inference (pileup/indel_features.py with preset_variants): the
read-vs-ref and allele alignments run on `device`, through the NW
kernels K1, K2 and K4 on "cuda" and their plain twins on "cpu". Labels are
the 4 genotype classes {hom-ref, hom-alt, het-ref, het-alt}
(indelCaller.py:14) assigned from the nearest truth indel in range.
"""

from __future__ import annotations

import numpy as np

from ..pileup.indel_features import get_indel_candidates
from ..runtime.device import resolve_device

# truth-position smear offsets per sequencing type (ONT :137-139 keeps
# all five; hifi drops the long ones)
SMEAR = {"ont": (40, 30, 20, 10, 0), "pacbio": (10, 0)}

GT_CLASS = {  # VCF GT tuple → class
    (0, 0): 0,
    (1, 1): 1, (2, 2): 1,
    (0, 1): 2, (1, 0): 2, (0, 2): 2, (2, 0): 2,
    (1, 2): 3, (2, 1): 3,
}


def truth_indels(vcf_reader, contig, start1, end1):
    """{pos0: gt_class} for indel records in the truth set."""
    out = {}
    for rec in vcf_reader.fetch(contig, start1, end1):
        alleles = [rec.ref] + rec.alt.split(",")
        if all(len(a) == len(rec.ref) == 1 for a in alleles):
            continue  # pure SNP
        gt_str = rec.sample_field("GT")
        if gt_str is None:
            continue
        try:
            gt = tuple(int(x) for x in gt_str.replace("|", "/").split("/"))
        except ValueError:
            continue
        cls = GT_CLASS.get(gt)
        if cls:
            out[rec.pos - 1] = cls
    return out


def generate_indel_training_examples(bam, fasta, truth, chunk, *,
                                     seq_type="ont", mincov=4, maxcov=160,
                                     win_size=40, neg_fraction=0.01, seed=0,
                                     device="cuda"):
    """truth: {pos0: gt_class}. Returns (x (N,15,128,2) float32,
    labels (N,) int, pos (N,)). The BAM must be haplotagged (HP tags),
    as in the reference's training setup. The alignments run on `device`
    ("cuda" without a GPU raises); both devices give the same arrays."""
    resolve_device(device)  # before the host work
    rng = np.random.default_rng(seed)
    start0, end0 = chunk["start"] - 1, chunk["end"]
    offsets = SMEAR.get(seq_type, SMEAR["ont"])

    anchors = {}
    for p, cls in truth.items():
        if not (start0 <= p < end0):
            continue
        for off in offsets:
            # anchor type: big-window range for far anchors, small for near
            anchors[max(0, p - off)] = 0 if off > 10 else 1
    # 1% negative columns (:179-183 negative sampling idea)
    n_neg = int((end0 - start0) * neg_fraction)
    tpos = np.array(sorted(truth), dtype=np.int64)
    for p in rng.integers(start0, end0, size=n_neg):
        p = int(p)
        if len(tpos) and np.min(np.abs(tpos - p)) <= win_size:
            continue
        anchors.setdefault(p, 1)

    batch = get_indel_candidates(
        bam, fasta, chunk, seq_type=seq_type, mincov=mincov, maxcov=maxcov,
        win_size=win_size, preset_variants=anchors, device=device)
    if len(batch) == 0:
        return (np.zeros((0, 15, 128, 2), np.float32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))

    x = np.concatenate([batch.x0, batch.x1, batch.x2], axis=1)
    labels = np.zeros(len(batch), np.int64)
    for j, pos1 in enumerate(batch.pos):
        p0 = pos1 - 1
        if len(tpos):
            i = np.searchsorted(tpos, p0)
            for k in (i - 1, i, i + 1):
                if 0 <= k < len(tpos) and 0 <= int(tpos[k]) - p0 <= max(10, win_size):
                    labels[j] = truth[int(tpos[k])]
                    break
    return x.astype(np.float32), labels, np.asarray(batch.pos, np.int64)
