"""SNP calling: pileups on the device (kernels K3 and K5) + CNN +
genotype decode + VCF output.

The SNP stage of nanocaller_tpu/snp_caller.py, with the same semantics:
coverage normalization (snpCaller.py:93-96), the per-base-probability
genotype decision tree (:113-163), haploid decode (:166-198), Phred
formulas incl. the haploid ×100 scale (:192), VCF text formats byte for
byte, and the two-file output contract ({prefix}.unfiltered.snps.vcf.gz
+ PASS-only {prefix}.snps.vcf.gz).

The host builds the observation payloads (pileup/snp_features.py) and
this process turns them into pileups on the state's device, by one of
three paths, as the JAX package's payload types choose them:
- a decode group's SnpGroupFeatures (the main path; one per member where
  the group is over the payload caps, each then a group of one):
  kernel K3 (pileup/snp_pileup.py) selects each candidate's 41
  neighbour columns and builds its pileup, one launch a cohort
  (infer_snp_group);
- a chunk's SnpChunkFeatures (--no_snp_group_payload, snp_group_span
  <= -1, a chunk over the group payload caps on its own): K3 on the
  chunk's wire, its windows the whole neighbour array (infer_snp_chunk);
- a chunk's dense SnpBatch (--no_dedup_transfer, a chunk over
  _TABLE_CELL_CAP): kernel K5 (pileup/snp_dense.py) (infer_snp_batch).
The three build the same x, bit for bit, for the same candidates; the
SNP CNN (models/snp.py, torch/cuDNN) runs on it in cfg.batch_size rows.
With several replicas (SnpCallerState.replicas, one a card) each route
splits its rows over them in cfg.batch_size slices (sharding.dp_rows):
the kernel and the CNN of a slice run on its replica, and the
probabilities are those of one device, bit for bit.
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
from .pileup.snp_dense import snp_dense_pileup
from .pileup.snp_features import (SnpChunkFeatures, SnpGroupFeatures,
                                  get_snp_candidates, get_snp_chunk_features)
from .pileup.snp_pileup import chunk_wire, group_wire, site_depth, snp_pileup
from .runtime import sharding
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
    # in-process data parallelism: [(device, model, hap_model)] of every
    # replica, the first this state's own; one entry on a single device
    replicas: list
    hap_train_coverage: float = HAPLOID_TRAIN_COVERAGE

    @property
    def devices(self):
        return [dev for dev, _m, _h in self.replicas]

    @classmethod
    def create(cls, snp_model_name, device="cuda", devices="auto"):
        """The diploid pack plus `haploid`, with the pack's `.coverage`
        training depth; "cuda" without a GPU raises. `devices`: the
        replicas' devices ("auto": sharding.inference_devices, every
        card of a bare "cuda" when there are two or more; None: one
        device), each holding a copy of the weights."""
        dev = resolve_device(device)

        def _load(module, name):
            params, cov = load_model("snp", name)
            module.load_state_dict(torch_state_dict_from_params(params))
            return module.to(dev).eval(), cov

        model, cov = _load(SNPModel(), snp_model_name)
        hap_model, _ = _load(HaploidSNPModel(), "haploid")
        reps = sharding.replicas(dev, devices, model, hap_model)
        return cls(model=reps[0][1], train_coverage=cov,
                   hap_model=reps[0][2], device=reps[0][0], replicas=reps)


def _coverage_norm(state, feats, ploidy, cfg):
    """Coverage scale of a payload's rows (a group member, a chunk's
    features or a dense batch) in numpy float32, as the JAX package
    computes it (snp_caller.py:1081-1086, :1166-1172, :1442-1449)."""
    train_cov = state.hap_train_coverage if ploidy == "haploid" \
        else state.train_coverage
    if cfg.disable_coverage_normalization:
        return train_cov / np.maximum(feats.dp.astype(np.float32), 1e-6)
    cov = feats.coverage
    return np.full(len(feats), train_cov / cov if cov > 0 else 1.0,
                   np.float32)


def _check_depth(depth, rows, maxcov):
    """K3 counts every covering read of a normal row: refuse a normal row
    deeper than maxcov (the payload's deep rows carry sampled ids)."""
    if len(rows) and depth[rows].max() > maxcov:
        raise ValueError("a normal row is deeper than maxcov=%d" % maxcov)


def _snp_cnn(replica, ploidy, x, ref, bs):
    """A replica's SNP CNN over x (B, 5, 41, 5) in slices of bs rows →
    the (B, 4) probabilities on x's device."""
    _dev, model, hap_model = replica
    probs = []
    for lo in range(0, x.shape[0], bs):
        xs, rs = x[lo:lo + bs], ref[lo:lo + bs]
        probs.append(hap_model(xs, rs) if ploidy == "haploid"
                     else model(xs, rs)[0][:, :, 1])
    return torch.cat(probs) if probs else torch.zeros(
        (0, 4), device=x.device)


def pileup_cohorts(state, gf, cfg):
    """K3's launches for one decode group, as infer_snp_group makes them.

    The members' rows pack into (ploidy, deep) cohorts, and each
    cohort's rows split over the state's replicas (sharding.dp_rows at
    cfg.batch_size): one launch a cohort and replica, on the replica's
    device, to which the payload goes once. Returns [(ploidy, deep,
    args, dst_mi, dst_j, r)] in launch order, where snp_pileup(*args)
    builds the pileups of replica r's rows and row k of it belongs to
    member dst_mi[k], row dst_j[k]. Normal rows count every covering
    read, which the payload keeps within maxcov (checked here, for both
    devices); deep rows (depth > maxcov) count their host-sampled read
    ids."""
    depth = site_depth(gf)
    cohorts = {}  # (ploidy, deep) -> dict of row lists
    for mi, (_oi, sec) in enumerate(gf.members):
        if sec is None or len(sec) == 0:
            continue
        B = len(sec)
        norm = _coverage_norm(state, sec, sec.ploidy, cfg)
        deep_mask = np.zeros(B, bool)
        deep_mask[sec.deep_idx] = True
        for deep in (False, True):
            rows = sec.deep_idx if deep else np.flatnonzero(~deep_mask)
            if not len(rows):
                continue
            if not deep:
                _check_depth(depth, sec.cand_site[rows], gf.maxcov)
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

    wires = {}  # replica -> the payload on its device
    out = []
    for (ploidy, deep), c in sorted(cohorts.items(),
                                    key=lambda kv: (kv[0][1], kv[0][0])):
        c = {k: np.concatenate(v) for k, v in c.items() if v}
        for r, rows in enumerate(sharding.dp_rows(
                len(c["mi"]), cfg.batch_size, state.devices)):
            if not len(rows):
                continue
            dev = state.replicas[r][0]
            if r not in wires:
                wires[r] = group_wire(gf, dev)
            put = lambda k, dtype=np.int32: torch.from_numpy(
                np.ascontiguousarray(c[k][rows], dtype)).to(dev)
            rids = n_valid = None
            if deep:
                rids = put("rids")
                n_valid = torch.full((len(rows),), gf.maxcov,
                                     dtype=torch.int32, device=dev)
            args = (wires[r], *(put(k) for k in
                                ("cand_site", "cand_pos", "lo", "hi")),
                    put("norm", np.float32), rids, n_valid)
            out.append((ploidy, deep, args, c["mi"][rows], c["j"][rows], r))
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
        for ploidy, _deep, args, mis, js, r in pileup_cohorts(state, gf,
                                                               cfg):
            # ref: the centre-ref one-hot, all zero for N as jax.nn.one_hot's
            x, _soc, ref = snp_pileup(*args)
            parts.append((mis, js, _snp_cnn(state.replicas[r], ploidy, x,
                                            ref, bs)))

    def finish():
        for mis, js, probs in parts:
            pr = probs.cpu().numpy()
            for mi in np.unique(mis):
                m = mis == mi
                outs[mi][js[m]] = pr[m]
        return outs

    return finish if async_mode else finish()


def chunk_cohorts(state, feats, cfg, ploidy):
    """K3's launches for one chunk's payload (SnpChunkFeatures) called at
    `ploidy`, as infer_snp_chunk makes them: the chunk's normal rows,
    then its deep rows, split over the state's replicas
    (sharding.dp_rows at cfg.batch_size), one launch each on the
    replica's device, to which the payload goes once as a chunk wire;
    their windows are the whole neighbour array [0, M). Returns [(deep,
    args, rows, r)] where snp_pileup(*args) builds the pileups of the
    candidates `rows` on replica r. Normal rows count every covering
    read (checked within maxcov, for both devices); deep rows count
    their host-sampled read ids."""
    B = len(feats)
    if B == 0:
        return []
    norm = _coverage_norm(state, feats, ploidy, cfg)
    deep_mask = np.zeros(B, bool)
    deep_mask[feats.deep_idx] = True
    normal = np.flatnonzero(~deep_mask)
    _check_depth(site_depth(feats), feats.cand_site[normal], feats.maxcov)
    devices = state.devices
    wires = {}
    out = []
    for deep, kind_rows in ((False, normal), (True, feats.deep_idx)):
        for r, sub in enumerate(sharding.dp_rows(len(kind_rows),
                                                 cfg.batch_size, devices)):
            n = len(sub)
            if not n:
                continue
            dev = devices[r]
            if r not in wires:
                wires[r] = chunk_wire(feats, dev)
            wire = wires[r]
            put = lambda a, dtype=np.int32: torch.from_numpy(
                np.ascontiguousarray(a, dtype)).to(dev)
            rows = kind_rows[sub]
            rids = n_valid = None
            if deep:
                rids = put(feats.deep_rids[sub])
                n_valid = torch.full((n,), feats.maxcov, dtype=torch.int32,
                                     device=dev)
            args = (wire, put(feats.cand_site[rows]),
                    put(feats.cand_pos32[rows]), put(np.zeros(n)),
                    put(np.full(n, wire.n_nbrs)),
                    put(norm[rows], np.float32), rids, n_valid)
            out.append((deep, args, rows, r))
    return out


def _finisher(B, parts, async_mode):
    out = np.zeros((B, 4), np.float32)

    def finish():
        for rows, probs in parts:
            out[rows] = probs.cpu().numpy()
        return out

    return finish if async_mode else finish()


def infer_snp_chunk(state, feats, cfg, ploidy, async_mode=False):
    """Run the model over one chunk's SnpChunkFeatures: K3 on the chunk's
    wire (chunk_cohorts), the CNN in cfg.batch_size rows.

    Returns the (B, 4) probabilities in candidate order (async_mode=True:
    a zero-arg finisher returning them; the launches are queued on the
    current stream and the finisher does the device→host copy)."""
    parts = []
    with torch.inference_mode():
        for _deep, args, rows, r in chunk_cohorts(state, feats, cfg, ploidy):
            x, _soc, ref = snp_pileup(*args)
            parts.append((rows, _snp_cnn(state.replicas[r], ploidy, x, ref,
                                         cfg.batch_size)))
    return _finisher(len(feats), parts, async_mode)


def infer_snp_batch(state, batch, cfg, ploidy, async_mode=False):
    """Run the model over one chunk's dense SnpBatch: its rows split over
    the state's replicas (sharding.dp_rows at cfg.batch_size), one K5
    launch a replica on its device (codes cut to the batch's deepest
    row's sampled reads, which lie first in every row), the CNN in
    cfg.batch_size rows. Returns as infer_snp_chunk does."""
    B = len(batch)
    parts = []
    if B:
        norm = _coverage_norm(state, batch, ploidy, cfg)
        R_b = max(1, int(batch.sampled_depth.max()))
        devices = state.devices
        with torch.inference_mode():
            for r, rows in enumerate(sharding.dp_rows(B, cfg.batch_size,
                                                      devices)):
                if not len(rows):
                    continue
                put = lambda a: torch.from_numpy(
                    np.ascontiguousarray(a[rows])).to(devices[r])
                x, ref = snp_dense_pileup(
                    put(batch.codes[:, :R_b]), put(batch.read_mask[:, :R_b]),
                    put(batch.col_ref), put(batch.col_valid),
                    put(batch.center_ref), put(norm))
                parts.append((rows, _snp_cnn(state.replicas[r], ploidy, x,
                                             ref, cfg.batch_size)))
    return _finisher(B, parts, async_mode)


def infer_snp_any(state, feats, cfg, ploidy, async_mode=False):
    """A chunk's payload by its type: SnpChunkFeatures on K3
    (infer_snp_chunk), a dense SnpBatch on K5 (infer_snp_batch)."""
    infer = infer_snp_chunk if isinstance(feats, SnpChunkFeatures) \
        else infer_snp_batch
    return infer(state, feats, cfg, ploidy, async_mode=async_mode)


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


def call_chunk(state, bam, fasta, chunk, cfg, exclude=None):
    """Feature-gen + inference + decode for one chunk → VCF body lines,
    on the state's device: the chunk's SnpChunkFeatures (K3 on its
    chunk wire), or with cfg.dedup_transfer off its dense SnpBatch
    (K5)."""
    builder = get_snp_chunk_features \
        if getattr(cfg, "dedup_transfer", True) else get_snp_candidates
    ploidy = chunk.get("ploidy", "diploid")
    batch = builder(
        bam, fasta, chunk,
        seq_type=cfg.sequencing, mincov=cfg.mincov, maxcov=cfg.maxcov,
        min_allele_freq=cfg.min_allele_freq, min_nbr_sites=cfg.min_nbr_sites,
        threshold=cfg.threshold, ploidy=ploidy, exclude=exclude)
    if len(batch) == 0:
        return []
    probs = infer_snp_any(state, batch, cfg, ploidy)
    if ploidy == "haploid":
        return decode_haploid(batch, probs)
    return decode_diploid(batch, probs)


def _group_adjacent(ordered_chunks, todo, cfg):
    """Pack coordinate-adjacent pending chunks into shared-decode groups;
    None for snp_group_span <= -1 (one decode a chunk:
    runtime/workers.snp_features_worker).

    The group span adapts to keep ≥ ~4 tasks per feature worker while
    amortizing the ±50 kb halo re-decode and per-window decode setup.
    Groups never span contigs, gaps (e.g. chunks completed by --resume),
    or ploidy changes."""
    span_cap = int(getattr(cfg, "snp_group_span", 0) or 0)
    if span_cap <= -1:
        return None
    if span_cap == 0:
        total = sum(c["end"] - c["start"] + 1 for c in ordered_chunks)
        span_cap = max(500_000,
                       min(8_000_000, total // max(1, 4 * cfg.cpu)))
    return group_adjacent_chunks(ordered_chunks, todo, span_cap)


def call_snps(cfg, bam, regions_list, chunks, out_dir, progress=None,
              manifest=None, metrics=None, exclude_path=None):
    """Run SNP calling over all chunks; write unfiltered + PASS VCFs.

    The payloads are built on the host from cfg.bam, cfg.ref and
    exclude_path, inline at --cpu 1 and by cfg.cpu feature workers
    otherwise, in completion order (runtime/scheduler.feature_stream):
    one task a decode group (runtime/workers.snp_features_group_worker),
    or one a chunk where cfg.snp_group_span <= -1
    (snp_features_worker). The CRAM windows those decodes gave the
    Python decoder are added to `bam`'s count (the main process's
    reader). This process infers each payload on the device by its type
    (SnpGroupFeatures: infer_snp_group; a chunk's SnpChunkFeatures or
    SnpBatch: infer_snp_any) with up to cfg.snp_pipeline_depth payloads
    in flight (a payload's device→host copy and decode wait until the
    next one's launches are queued); lines are stored by chunk index,
    so the order of arrival changes nothing. With a RunManifest,
    completed chunks are reloaded from their shard files. The
    `snp.features` timer is this process's wait for the next task's
    payloads. Returns the PASS VCF path (snpCaller.py:287)."""
    from contextlib import nullcontext

    from .runtime.scheduler import feature_stream
    from .runtime.workers import (cfg_kwargs_for_workers,
                                  snp_features_group_worker,
                                  snp_features_worker)

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

    # [(members, finisher)]: members [(chunk index, payload section)] and
    # finisher() their probabilities, one array a member
    in_flight = []
    depth = max(1, int(cfg.snp_pipeline_depth))

    def _finalize_one():
        members, finish = in_flight.pop(0)
        for (oi, sec), probs in zip(members, finish()):
            if sec is None or len(sec) == 0:
                _store(oi, [])
            elif ordered_chunks[oi].get("ploidy") == "haploid":
                _store(oi, decode_haploid(sec, probs))
            else:
                _store(oi, decode_diploid(sec, probs))

    def _infer(p):
        if isinstance(p, SnpGroupFeatures):
            return p.members, infer_snp_group(state, p, cfg, async_mode=True)
        idx, feats = p
        ploidy = ordered_chunks[idx].get("ploidy", "diploid")
        finish = infer_snp_any(state, feats, cfg, ploidy, async_mode=True)
        return [p], lambda: [finish()]

    init_args = (cfg.bam, cfg.ref, cfg_kwargs_for_workers(cfg), exclude_path)
    groups = _group_adjacent(ordered_chunks, todo, cfg)
    if groups is None:
        stream = ((i, [(todo[i], feats)], pyw) for i, feats, pyw in
                  feature_stream([ordered_chunks[i] for i in todo],
                                 snp_features_worker, init_args, cfg.cpu))
    else:
        stream = feature_stream(groups, snp_features_group_worker,
                                init_args, cfg.cpu)
    while True:
        with timer("snp.features"):
            item = next(stream, None)
        if item is None:
            break
        _i, payloads, py_windows = item
        if py_windows:
            bam.note_python_windows(py_windows)
        # a decode group's payload, one a member where the group is over
        # the payload caps, or (chunk index, its own payload)
        for p in payloads:
            with timer("snp.infer_decode"):
                members, finish = _infer(p)
                while len(in_flight) >= depth:
                    _finalize_one()
                in_flight.append((members, finish))
            if metrics is not None:
                metrics.count("snp_candidates", sum(
                    len(sec) for _oi, sec in members if sec is not None))
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
