"""SNP calling: group pileups on the device (kernel K3) + CNN + genotype
decode + VCF output.

The group path of nanocaller_tpu/snp_caller.py, with the same semantics:
coverage normalization (snpCaller.py:93-96), the per-base-probability
genotype decision tree (:113-163), haploid decode (:166-198), Phred
formulas incl. the haploid ×100 scale (:192), VCF text formats byte for
byte, and the two-file output contract ({prefix}.unfiltered.snps.vcf.gz
+ PASS-only {prefix}.snps.vcf.gz).

Per decode group the host builds one observation payload
(pileup/snp_features.py; one per member where the group is over the
payload caps, each then a group of one); on the state's device, kernel K3
(pileup/snp_pileup.py) selects each candidate's 41 neighbour columns and
builds its pileup from the payload, one launch a cohort, and the SNP CNN
(models/snp.py, torch/cuDNN) runs on it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .io.vcf import VcfWriter, standard_snp_header, view_filter
from .models import (HaploidSNPModel, SNPModel, load_model,
                     torch_state_dict_from_params)
from .models.registry import HAPLOID_TRAIN_COVERAGE
from .pileup.snp_features import get_snp_group_payloads
from .pileup.snp_pileup import group_wire, site_depth, snp_pileup
from .runtime.chunker import group_adjacent_chunks
from .runtime.device import resolve_device

NUM_TO_BASE = "AGTC"  # snpCaller.py:14


def _phred(p, cap=99, scale=10, eps=1e-10):
    """min(cap, -scale*log10(eps + 1 - p)) with the reference's effective
    NaN behavior: float32 softmax can give p marginally above 1, where
    numpy log10 yields NaN and Python's min(cap, nan) returns cap
    (snpCaller.py:135 et al.) — so out-of-domain clamps to cap."""
    x = eps + 1.0 - float(p)
    if x <= 0:
        return float(cap)
    return min(cap, -scale * math.log10(x))


@dataclass
class SnpCallerState:
    model: SNPModel
    train_coverage: float
    hap_model: HaploidSNPModel
    device: torch.device
    hap_train_coverage: float = HAPLOID_TRAIN_COVERAGE

    @classmethod
    def create(cls, snp_model_name, device="cuda"):
        """The diploid pack plus `haploid`, with the pack's `.coverage`
        training depth; "cuda" without a GPU raises."""
        dev = resolve_device(device)

        def _load(module, name):
            params, cov = load_model("snp", name)
            module.load_state_dict(torch_state_dict_from_params(params))
            return module.to(dev).eval(), cov

        model, cov = _load(SNPModel(), snp_model_name)
        hap_model, _ = _load(HaploidSNPModel(), "haploid")
        return cls(model=model, train_coverage=cov, hap_model=hap_model,
                   device=dev)


def _member_norm(state, sec, cfg):
    """Coverage scale of a member's rows in numpy float32, as the JAX
    package computes it (snp_caller.py:1442-1449)."""
    train_cov = state.hap_train_coverage if sec.ploidy == "haploid" \
        else state.train_coverage
    if cfg.disable_coverage_normalization:
        return train_cov / np.maximum(sec.dp.astype(np.float32), 1e-6)
    cov = sec.coverage
    return np.full(len(sec), train_cov / cov if cov > 0 else 1.0,
                   np.float32)


def pileup_cohorts(state, gf, cfg):
    """K3's launches for one decode group, as infer_snp_group makes them.

    The members' rows pack into (ploidy, deep) cohorts; the payload goes
    to state.device once. Returns [(ploidy, deep, args, dst_mi, dst_j)] in
    launch order, where snp_pileup(*args) builds the cohort's pileups
    and row k of it belongs to member dst_mi[k], row dst_j[k]. Normal
    rows count every covering read, which the payload keeps within
    maxcov (checked here, for both devices); deep rows (depth > maxcov)
    count their host-sampled read ids."""
    dev = state.device
    depth = site_depth(gf)
    cohorts = {}  # (ploidy, deep) -> dict of row lists
    for mi, (_oi, sec) in enumerate(gf.members):
        if sec is None or len(sec) == 0:
            continue
        B = len(sec)
        norm = _member_norm(state, sec, cfg)
        deep_mask = np.zeros(B, bool)
        deep_mask[sec.deep_idx] = True
        for deep in (False, True):
            rows = sec.deep_idx if deep else np.flatnonzero(~deep_mask)
            if not len(rows):
                continue
            if not deep and depth[sec.cand_site[rows]].max() > gf.maxcov:
                raise ValueError("a normal row is deeper than maxcov=%d"
                                 % gf.maxcov)
            c = cohorts.setdefault((sec.ploidy, deep), {
                "cand_site": [], "cand_pos": [], "norm": [], "lo": [],
                "hi": [], "mi": [], "j": [], "rids": []})
            nr = len(rows)
            c["cand_site"].append(sec.cand_site[rows])
            c["cand_pos"].append(sec.cand_pos32[rows])
            c["norm"].append(norm[rows])
            c["lo"].append(np.full(nr, sec.nbr_lo, np.int32))
            c["hi"].append(np.full(nr, sec.nbr_hi, np.int32))
            c["mi"].append(np.full(nr, mi, np.int32))
            c["j"].append(rows)
            if deep:
                c["rids"].append(sec.deep_rids)
    if not cohorts:
        return []

    def put(parts, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(np.concatenate(parts), dtype)).to(dev)

    wire = group_wire(gf, dev)
    out = []
    for (ploidy, deep), c in sorted(cohorts.items(),
                                    key=lambda kv: (kv[0][1], kv[0][0])):
        rids = n_valid = None
        if deep:
            rids = put(c["rids"], np.int32)
            n_valid = torch.full((rids.shape[0],), gf.maxcov,
                                 dtype=torch.int32, device=dev)
        args = (wire, *(put(c[k], np.int32) for k in
                        ("cand_site", "cand_pos", "lo", "hi")),
                put(c["norm"], np.float32), rids, n_valid)
        out.append((ploidy, deep, args, np.concatenate(c["mi"]),
                    np.concatenate(c["j"])))
    return out


def infer_snp_group(state, gf, cfg, async_mode=False):
    """Run the model over a whole decode group from ONE device payload.

    gf: pileup.snp_features.SnpGroupFeatures. Each (ploidy, deep) cohort
    of the members' rows takes one K3 launch (pileup_cohorts) and the CNN
    in chunks of cfg.batch_size rows.

    Returns a list of per-member (B, 4) probability arrays aligned with
    gf.members (async_mode=True: a zero-arg finisher returning it; the
    launches are queued on the current stream and the finisher does the
    device→host copy)."""
    outs = [np.zeros((len(sec) if sec is not None else 0, 4), np.float32)
            for _oi, sec in gf.members]
    parts = []  # (dst_mi, dst_j, device probs)
    bs = cfg.batch_size
    with torch.inference_mode():
        for ploidy, _deep, args, mis, js in pileup_cohorts(state, gf, cfg):
            # ref: the centre-ref one-hot, all zero for N as jax.nn.one_hot's
            x, _soc, ref = snp_pileup(*args)
            probs = []
            for lo in range(0, x.shape[0], bs):
                xs, rs = x[lo:lo + bs], ref[lo:lo + bs]
                probs.append(state.hap_model(xs, rs) if ploidy == "haploid"
                             else state.model(xs, rs)[0][:, :, 1])
            parts.append((mis, js, torch.cat(probs)))

    def finish():
        for mis, js, probs in parts:
            pr = probs.cpu().numpy()
            for mi in np.unique(mis):
                m = mis == mi
                outs[mi][js[m]] = pr[m]
        return outs

    return finish if async_mode else finish()


def decode_diploid(batch, probs):
    """Genotype decision tree → VCF body lines (snpCaller.py:113-163)."""
    lines = []
    pred_sort = np.argsort(probs, axis=1)
    n_ge = (probs >= 0.5).sum(axis=1)
    for j in range(len(batch)):
        pos1 = int(batch.pos[j]) + 1
        ref = int(batch.center_ref[j])
        pj = probs[j]
        dp = int(batch.dp[j])
        info = "PR=" + ",".join("%.4f" % x for x in pj[[0, 3, 1, 2]]) + \
               ";FQ=%.4f" % batch.freq[j]
        fwd, rev = batch.fwd_dp[j], batch.rev_dp[j]
        ref_dp = (int(fwd[ref]), int(rev[ref]))
        pred1, pred2 = int(pred_sort[j, -1]), int(pred_sort[j, -2])

        def line(alt, qual, filt, gt, sample_tail):
            return "%s\t%d\t.\t%s\t%s\t%.3f\t%s\t%s\tGT:DP:VF:AD:ADF:ADR\t%s:%s\n" % (
                batch.contig, pos1, NUM_TO_BASE[ref], alt, qual, filt, info,
                gt, sample_tail)

        if n_ge[j] >= 2:  # het-like
            if pred1 == ref:
                alt = pred2
                alt_dp = (int(fwd[alt]), int(rev[alt]))
                qual = _phred(pj[alt])
                lines.append(line(
                    NUM_TO_BASE[alt], qual, "PASS", "0/1",
                    "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                        dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                        ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
            elif pred2 == ref and pj[pred2] >= 0.5:
                alt = pred1
                alt_dp = (int(fwd[alt]), int(rev[alt]))
                qual = _phred(pj[pred2])
                lines.append(line(
                    NUM_TO_BASE[alt], qual, "PASS", "0/1",
                    "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                        dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                        ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
            elif pred2 != ref and pred1 != ref and pj[pred2] >= 0.5:
                alt1_dp = (int(fwd[pred1]), int(rev[pred1]))
                alt2_dp = (int(fwd[pred2]), int(rev[pred2]))
                qual = _phred(pj[pred2])
                lines.append(line(
                    "%s,%s" % (NUM_TO_BASE[pred1], NUM_TO_BASE[pred2]),
                    qual, "PASS", "1/2",
                    "%d:%.4f,%.4f:%d,%d,%d:%d,%d,%d:%d,%d,%d" % (
                        dp, sum(alt1_dp) / dp, sum(alt2_dp) / dp,
                        sum(ref_dp), sum(alt1_dp), sum(alt2_dp),
                        ref_dp[0], alt1_dp[0], alt2_dp[0],
                        ref_dp[1], alt1_dp[1], alt2_dp[1])))
        elif n_ge[j] == 1 and ref != pred1 and pj[pred1] >= 0.5:  # hom-alt
            alt_dp = (int(fwd[pred1]), int(rev[pred1]))
            qual = _phred(pj[pred1])
            lines.append(line(
                NUM_TO_BASE[pred1], qual, "PASS", "1/1",
                "%d:%.4f:%d,%d:%d,%d:%d,%d" % (
                    dp, sum(alt_dp) / dp, sum(ref_dp), sum(alt_dp),
                    ref_dp[0], alt_dp[0], ref_dp[1], alt_dp[1])))
        else:
            if n_ge[j] == 1 and ref == pred1:
                qual = _phred(pj[pred1])
                lines.append(line(".", qual, "REF", "./.", "%d:.:.:.:." % dp))
            else:
                lines.append(line(".", 0.0, "LOW", "./.", "%d:.:.:.:." % dp))
    return lines


def decode_haploid(batch, probs):
    """Haploid decode (snpCaller.py:187-198)."""
    lines = []
    preds = np.argmax(probs, axis=1)
    for j in range(len(batch)):
        pos1 = int(batch.pos[j]) + 1
        ref = int(batch.center_ref[j])
        pred = int(preds[j])
        pj = probs[j]
        info = "PR=" + ",".join("%.4f" % x for x in pj[[0, 3, 1, 2]]) + \
               ";FQ=%.4f" % batch.freq[j]
        qual = _phred(pj[pred], cap=999, scale=100)
        filt = "PASS" if pred != ref else "REF"
        lines.append(
            "%s\t%d\t.\t%s\t%s\t%.3f\t%s\t%s\tGT:DP:VF:AD:ADF:ADR\t%s:%d:%.4f:.:.:.\n"
            % (batch.contig, pos1, NUM_TO_BASE[ref], NUM_TO_BASE[pred], qual,
               filt, info, "1/1", int(batch.dp[j]), batch.freq[j]))
    return lines


def _group_adjacent(ordered_chunks, todo, cfg):
    """Pack coordinate-adjacent pending chunks into shared-decode groups.

    The group span adapts to keep ≥ ~4 tasks per feature worker while
    amortizing the ±50 kb halo re-decode and per-window decode setup.
    Groups never span contigs, gaps (e.g. chunks completed by --resume),
    or ploidy changes."""
    span_cap = int(getattr(cfg, "snp_group_span", 0) or 0)
    if span_cap <= -1:
        raise NotImplementedError(
            "snp_group_span <= -1 (the per-chunk SNP path) is not ported "
            "yet: ROADMAP A2 (SNP fallbacks, kernels B6)")
    if span_cap == 0:
        total = sum(c["end"] - c["start"] + 1 for c in ordered_chunks)
        span_cap = max(500_000,
                       min(8_000_000, total // max(1, 4 * cfg.cpu)))
    return group_adjacent_chunks(ordered_chunks, todo, span_cap)


def _check_supported(cfg):
    for flag, on in (("dedup_transfer", cfg.dedup_transfer),
                     ("snp_group_payload", cfg.snp_group_payload)):
        if not on:
            raise NotImplementedError(
                "%s=False (the per-chunk / dense SNP oracle paths) is not "
                "ported yet: ROADMAP A2 (SNP fallbacks, kernels B6)" % flag)


def call_snps(cfg, bam, fasta, regions_list, chunks, out_dir, exclude=None,
              progress=None, manifest=None, metrics=None):
    """Run SNP calling over all chunks; write unfiltered + PASS VCFs.

    Inline for --cpu 1: each decode group's payload is built on the host,
    then inferred on the device with up to cfg.snp_pipeline_depth groups
    in flight (a group's device→host copy and decode wait until the next
    group's features are built and its launches queued). With a
    RunManifest, completed chunks are reloaded from their shard files.
    Returns the PASS VCF path (snpCaller.py:287)."""
    from contextlib import nullcontext

    _check_supported(cfg)
    state = SnpCallerState.create(cfg.snp_model, device=cfg.device)
    timer = metrics.timer if metrics is not None else (lambda _: nullcontext())
    contigs = list(dict.fromkeys(x[0] for x in regions_list))
    order = sorted(range(len(chunks)),
                   key=lambda i: (contigs.index(chunks[i]["chrom"]),
                                  chunks[i]["start"]))
    ordered_chunks = [chunks[i] for i in order]

    results = {}
    todo = []
    for idx, chunk in enumerate(ordered_chunks):
        if manifest is not None and manifest.is_done("snp", chunk):
            with open(manifest.shard_path("snp", chunk)) as fh:
                results[idx] = fh.readlines()
            if progress:
                progress(1)
        else:
            todo.append(idx)

    def _store(idx, lines):
        results[idx] = lines
        if manifest is not None:
            chunk = ordered_chunks[idx]
            shard = os.path.join(
                manifest.shard_dir, "snp_%s_%d.body" % (chunk["chrom"],
                                                        chunk["start"]))
            with open(shard, "w") as fh:
                fh.writelines(lines)
            manifest.mark_done("snp", chunk, shard)
        if progress:
            progress(1)

    in_flight = []  # [(gf, finisher)]
    depth = max(1, int(cfg.snp_pipeline_depth))

    def _finalize_one():
        gf, finish = in_flight.pop(0)
        outs = finish()
        for (oi, sec), probs in zip(gf.members, outs):
            if sec is None or len(sec) == 0:
                _store(oi, [])
            elif sec.ploidy == "haploid":
                _store(oi, decode_haploid(sec, probs))
            else:
                _store(oi, decode_diploid(sec, probs))

    kw = dict(seq_type=cfg.sequencing, mincov=cfg.mincov, maxcov=cfg.maxcov,
              min_allele_freq=cfg.min_allele_freq,
              min_nbr_sites=cfg.min_nbr_sites, threshold=cfg.threshold,
              exclude=exclude)
    for group in _group_adjacent(ordered_chunks, todo, cfg):
        with timer("snp.features"):
            payloads = get_snp_group_payloads(
                bam, fasta, [c for _, c in group], **kw)
        # a group over the payload caps comes back as one payload a member
        idx_of = {id(c): oi for oi, c in group}
        for gf in payloads:
            gf.members = [(idx_of[id(m)], sec) for m, sec in gf.members]
            if metrics is not None:
                metrics.count("snp_candidates", len(gf))
            with timer("snp.infer_decode"):
                finish = infer_snp_group(state, gf, cfg, async_mode=True)
                while len(in_flight) >= depth:
                    _finalize_one()
                in_flight.append((gf, finish))
    with timer("snp.infer_decode"):
        while in_flight:  # drain the inference pipeline
            _finalize_one()

    header = standard_snp_header(contigs, cfg.sample)
    all_path = os.path.join(out_dir, "%s.unfiltered.snps.vcf.gz" % cfg.prefix)
    pass_path = os.path.join(out_dir, "%s.snps.vcf.gz" % cfg.prefix)
    with VcfWriter(all_path, header) as w:
        for idx in range(len(ordered_chunks)):
            for ln in results.get(idx, []):
                w.write(ln)
    view_filter(all_path, pass_path, lambda r: r.filter == "PASS")
    return pass_path
