"""Training feature generation + shard I/O (a copy of
nanocaller_tpu/train/data.py on the port's own pileup modules; host
numpy, so its arrays equal the JAX package's for the same seed).

SNP semantics follow misc/training/generate_SNP_pileups.py:160-324:
truth sites become positives labelled (gt∈{0 hom,1 het}, allele1,
allele2); non-truth columns are negatives sampled by alt-freq bin
(coin-flip for <10%, per-bin quotas relative to the positive count);
every kept site is tensorized TWICE — once against frequency-derived
neighbor sites and once against truth-derived ones (:272-281 loop) — and
negatives carry ref-only labels.

Storage is a columnar npz shard (x int8 (N,5,41,5), ref uint8, gt uint8,
allele1/2 uint8, pos int64) instead of the reference's 15-char
fixed-width text records (:375-389) — a deliberate modernization; the
record CONTENT is the same.
"""

from __future__ import annotations

import glob

import numpy as np

from ..pileup.engine import SiteCodes, column_counts, decode_reads
from ..pileup.snp_features import (CENTER, REF_CODE_LUT, WIDTH, SnpBatch,
                                   assemble_matrices_np, select_neighbors)

GT_MAP = {(0, 0): 0, (1, 1): 0, (2, 2): 0, (1, 2): 1, (2, 1): 1,
          (0, 1): 1, (1, 0): 1, (0, 2): 1, (2, 0): 1}
_BASE = {"A": 0, "G": 1, "T": 2, "C": 3}


def truth_snps(vcf_reader, contig, start1, end1):
    """{pos0: (gt01, allele1_code, allele2_code)} from a truth VCF."""
    out = {}
    for rec in vcf_reader.fetch(contig, start1, end1):
        gt_str = rec.sample_field("GT")
        if gt_str is None:
            continue
        sep = "|" if "|" in gt_str else "/"
        try:
            gt = tuple(int(x) for x in gt_str.split(sep))
        except ValueError:
            continue
        if gt not in GT_MAP:
            continue
        alleles = [rec.ref] + rec.alt.split(",")
        try:
            a1, a2 = alleles[gt[0]], alleles[gt[1]]
        except IndexError:
            continue
        if a1 in _BASE and a2 in _BASE and len(rec.ref) == 1:
            out[rec.pos - 1] = (GT_MAP[gt], _BASE[a1], _BASE[a2])
    return out


def generate_snp_training_examples(bam, fasta, truth, chunk, *, seq_type="ont",
                                   mincov=8, maxcov=160,
                                   nbr_threshold=(0.4, 0.6), seed=0):
    """One chunk → training example arrays (both neighbor variants).

    truth: {pos0: (gt, a1, a2)} — must cover the chunk PLUS the ±50 kb
    halo (truth-derived neighbor sites reach that far, like the
    reference's get_nbr fetch at misc/training/generate_SNP_pileups.py:
    102-104); positives are restricted to the chunk internally. Returns
    dict of arrays (possibly empty).
    """
    rng = np.random.default_rng(seed)
    contig = chunk["chrom"]
    start0, end0 = chunk["start"] - 1, chunk["end"]
    halo = 50000
    scan_start = max(0, start0 - halo)
    scan_end = end0 + halo
    rw = decode_reads(bam, contig, scan_start, scan_end)
    ref_str = fasta.fetch(contig, scan_start, scan_end)
    scan_end = min(scan_end, scan_start + len(ref_str))
    ref_codes = REF_CODE_LUT[np.frombuffer(ref_str.encode(), dtype=np.uint8)]

    counts = column_counts(rw, scan_start, scan_end)
    n_aligned = counts[:, :5].sum(axis=1)
    base_counts = counts[:, :4].astype(np.float32)
    ref_valid = ref_codes < 4
    masked = base_counts.copy()
    cols = np.arange(len(ref_codes))
    masked[cols[ref_valid], ref_codes[ref_valid].astype(np.int64)] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        alt_freq = np.where(n_aligned > 0, masked.max(axis=1) / n_aligned, 0.0)
    pos_all = np.arange(scan_start, scan_end, dtype=np.int64)
    ok = ref_valid & (n_aligned >= mincov) & (n_aligned <= maxcov)
    in_window = (pos_all >= start0) & (pos_all < end0)

    truth_pos = np.array(sorted(p for p in truth if start0 <= p < end0),
                         dtype=np.int64)
    truth_set = set(truth_pos.tolist())

    # negative candidates by alt-freq bin (:225-251)
    neg_bins = {0: [], 5: [], 10: [], 15: [], 20: [], 25: []}
    for i in np.flatnonzero(ok & in_window):
        p = int(pos_all[i])
        if p in truth_set:
            continue
        af = alt_freq[i]
        if af >= 0.25:
            neg_bins[25].append(p)
        elif af >= 0.20:
            neg_bins[20].append(p)
        elif af >= 0.15:
            neg_bins[15].append(p)
        elif af >= 0.10:
            neg_bins[10].append(p)
        elif rng.integers(2):
            neg_bins[5 if af >= 0.05 else 0].append(p)

    tr_len = len(truth_pos) if len(truth_pos) else 10 ** 16
    sizes = {0: tr_len, 5: tr_len // 3, 10: tr_len // 3, 15: tr_len // 3,
             20: tr_len, 25: tr_len}
    selected_negs = []
    for b, plist in neg_bins.items():
        if len(plist) > sizes[b]:
            pick = rng.permutation(len(plist))[: sizes[b]]
            plist = [plist[i] for i in pick]
        selected_negs.extend(plist)

    # neighbor maps (misc/training/generate_SNP_pileups.py:100-160):
    # - freq: threshold band + mincov (NO maxcov gate, unlike candidates)
    # - gtruth: HETEROZYGOUS truth sites with coverage >= mincov
    nbr_base = ref_valid & (n_aligned >= mincov)
    nbr_ok = nbr_base & (alt_freq >= nbr_threshold[0]) & (alt_freq < nbr_threshold[1])
    nbr_freq = pos_all[nbr_ok]
    covered = set(pos_all[n_aligned >= mincov].tolist())
    nbr_truth = np.array(sorted(p for p, (g, a1, a2) in truth.items()
                                if g == 1 and scan_start <= p < scan_end
                                and p in covered),
                         dtype=np.int64)

    all_sites = [(p, truth[p]) for p in truth_pos]
    all_sites += [(p, None) for p in selected_negs]
    if not all_sites:
        return _empty_examples()

    xs, refs, gts, a1s, a2s, poss = [], [], [], [], [], []
    for nbr_pos in (nbr_freq, nbr_truth):
        sites = np.array([p for p, _ in all_sites], dtype=np.int64)
        order = np.argsort(sites)
        union = np.union1d(nbr_pos, sites)
        sc = SiteCodes(rw, union)
        nbr_idx, _, _ = select_neighbors(sites, nbr_pos, seq_type)
        site_i = np.searchsorted(union, sites)
        for k, (p, label) in enumerate(all_sites):
            rids, ccodes = sc.at(site_i[k])
            R = len(rids)
            if R == 0:
                continue
            codes = np.full((R, WIDTH), 4, np.int8)
            col_ref = np.full(WIDTH, 4, np.int8)
            col_valid = np.zeros(WIDTH, bool)
            codes[:, CENTER] = ccodes
            rc = ref_codes[p - scan_start]
            col_ref[CENTER] = rc
            col_valid[CENTER] = True
            for w in range(WIDTH):
                j = nbr_idx[k, w]
                if j < 0:
                    continue
                jp = int(nbr_pos[j])
                uj = np.searchsorted(union, jp)
                codes[:, w] = sc.codes_for(uj, rids)
                col_ref[w] = ref_codes[jp - scan_start]
                col_valid[w] = True
            batch = SnpBatch(
                contig=contig, pos=np.array([p]), codes=codes[None],
                read_mask=np.ones((1, R), bool), col_ref=col_ref[None],
                col_valid=col_valid[None], center_ref=np.array([rc], np.int8),
                dp=np.array([R], np.int32), freq=np.zeros(1, np.float32),
                fwd_dp=np.zeros((1, 4), np.int32),
                rev_dp=np.zeros((1, 4), np.int32),
                sampled_depth=np.array([R], np.int32),
                nbr_counts=np.array([1], np.int32))
            x = assemble_matrices_np(batch)[0].astype(np.int8)
            if label is None:
                gt, a1, a2 = 0, rc, rc
            else:
                gt, a1, a2 = label
            xs.append(x)
            refs.append(rc)
            gts.append(gt)
            a1s.append(a1)
            a2s.append(a2)
            poss.append(p)
    return {
        "x": np.array(xs, np.int8),
        "ref": np.array(refs, np.uint8),
        "gt": np.array(gts, np.uint8),
        "allele1": np.array(a1s, np.uint8),
        "allele2": np.array(a2s, np.uint8),
        "pos": np.array(poss, np.int64),
    }


def _empty_examples():
    return {"x": np.zeros((0, 5, WIDTH, 5), np.int8),
            "ref": np.zeros(0, np.uint8), "gt": np.zeros(0, np.uint8),
            "allele1": np.zeros(0, np.uint8), "allele2": np.zeros(0, np.uint8),
            "pos": np.zeros(0, np.int64)}


def save_shard(path, examples):
    np.savez_compressed(path, **examples)
    return path


def load_shards(pattern):
    files = sorted(glob.glob(pattern)) if isinstance(pattern, str) else list(pattern)
    parts = [dict(np.load(f)) for f in files]
    if not parts:
        return _empty_examples()
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def batches_from_examples(ex, batch_size, rng, train_coverage=None):
    """Yield training batch dicts (x, ref, base_labels, gt_label).

    Per-base 2-class labels: [0,1] when the base is one of the truth
    alleles, else [1,0]; GT label [0,1] for het (model_run.py semantics).
    """
    N = len(ex["gt"])
    order = rng.permutation(N)
    for lo in range(0, N - batch_size + 1, batch_size):
        idx = order[lo : lo + batch_size]
        x = ex["x"][idx].astype(np.float32)
        present = np.zeros((len(idx), 4), bool)
        for i, (a1, a2) in enumerate(zip(ex["allele1"][idx], ex["allele2"][idx])):
            present[i, a1] = True
            present[i, a2] = True
        base_labels = np.zeros((len(idx), 4, 2), np.float32)
        base_labels[..., 1] = present
        base_labels[..., 0] = ~present
        gt_label = np.eye(2, dtype=np.float32)[ex["gt"][idx].astype(int)]
        ref = np.eye(4, dtype=np.float32)[ex["ref"][idx].astype(int)]
        yield {"x": x, "ref": ref, "base_labels": base_labels,
               "gt_label": gt_label}
