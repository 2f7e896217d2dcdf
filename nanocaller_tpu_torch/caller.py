"""End-to-end orchestration of the port: `--mode snps --cpu 1` (without
--phase) and `--mode indels --cpu 1`.

The inline paths of nanocaller_tpu/caller.py::run, with the same output
contract for those modes:

    PREFIX.unfiltered.snps.vcf.gz   all SNP candidate records (snps)
    PREFIX.snps.vcf.gz              PASS SNP calls (snps)
    PREFIX.indels.vcf.gz            decomposed non-SNP calls (indels)

snps: BAM → one observation payload per decode group (host decode +
scan) → neighbour selection and pileups on the device (kernel K3) → SNP
CNN → genotype decode (snp_caller.py).
indels: BAM → candidates (host decode + scan) → read-vs-ref and allele
NW on the device (kernels K1 + K2) → indel CNN → decode → rtg-style
decomposition. The input BAM is expected to be haplotagged (HP/PS), as
the reference's indel stage reads it.

`--resume` reuses completed chunks through the run manifest. Other
modes and `--cpu N > 1` raise NotImplementedError naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import os
import shutil

from .config import Config, resolve_exclude_bed
from .indel_caller import (IndelCallerState, decode_diploid_indels,
                           decode_haploid_indels, infer_haploid_indel_many,
                           infer_indel_many, write_indel_vcf)
from .io.bam import open_alignment
from .io.bed import BedIntervals
from .io.fasta import FastaFile
from .pileup.indel_features import get_indel_candidates
from .runtime.chunker import get_chunks, get_regions_list
from .runtime.metrics import Metrics
from .runtime.scheduler import Progress, RunManifest
from .snp_caller import call_snps


def _check_supported(cfg):
    if cfg.mode == "all" or (cfg.mode == "snps" and cfg.phase):
        raise NotImplementedError(
            "--mode %s%s is not ported yet: the port runs --mode snps "
            "(without --phase) and --mode indels; phasing is ROADMAP queue "
            "A item A3 (--mode all --cpu 1 with phasing)"
            % (cfg.mode, " --phase" if cfg.phase else ""))
    if cfg.cpu != 1:
        raise NotImplementedError(
            "--cpu %d is not ported yet: the port runs --cpu 1; feature "
            "workers are ROADMAP queue A item A5 (--cpu N workers)"
            % cfg.cpu)
    if cfg.num_processes > 1 or cfg.num_shards > 1:
        raise NotImplementedError(
            "multi-process / sharded runs are ROADMAP queue A item A6 "
            "(multi-GPU)")
    if cfg.watchdog:
        raise NotImplementedError("--watchdog is not ported")


def run(cfg: Config, progress=None):
    """Execute the configured pipeline; returns dict of output paths."""
    _check_supported(cfg)
    state = IndelCallerState.create(cfg.indel_model, device=cfg.device) \
        if cfg.mode == "indels" else None

    os.makedirs(cfg.output, exist_ok=True)
    cfg.dump(os.path.join(cfg.output, "args"))
    metrics = Metrics()
    owns_progress = False
    if progress is None and not cfg.suppress_progress:
        bar = Progress(None, "calling", suppress=cfg.suppress_progress)
        progress = bar.update
        owns_progress = True

    manifest_path = os.path.join(cfg.output, "run_manifest.json")
    shard_dir = os.path.join(cfg.output, "intermediate_shards")
    if not cfg.resume:
        # fresh run: wipe stale state (the reference always restarts from
        # scratch, snpCaller.py:228-229; --resume opts into reuse)
        for p in (manifest_path, shard_dir):
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
    manifest = RunManifest(manifest_path, shard_dir=shard_dir)

    fasta = FastaFile(cfg.ref)
    bam = open_alignment(cfg.bam, fasta=fasta)
    exclude = None
    if cfg.exclude_bed:
        exclude = BedIntervals(resolve_exclude_bed(cfg.exclude_bed))

    regions_list = get_regions_list(cfg, bam)
    outputs = {"snps": None, "phased_snps": None, "indels": None, "final": None}
    if cfg.mode == "snps":
        chunks = get_chunks(regions_list, cfg.cpu)
        with metrics.timer("snp_calling"):
            outputs["snps"] = call_snps(
                cfg, bam, fasta, regions_list, chunks, cfg.output,
                exclude=exclude, progress=progress, manifest=manifest,
                metrics=metrics)
        metrics.count("snp_chunks", len(chunks))
    else:
        outputs["indels"] = _call_indels(cfg, state, bam, fasta,
                                         regions_list, exclude, manifest,
                                         metrics, progress)
    if owns_progress:
        bar.close()
    metrics.dump(os.path.join(cfg.output, "metrics.json"))
    return outputs


def _call_indels(cfg, state, bam, fasta, regions_list, exclude, manifest,
                 metrics, progress):
    """The inline indel stage; returns the indels.vcf.gz path."""
    # contig extents (indelCaller.py:299-305)
    contigs = {}
    for c, s, e, ploidy in regions_list:
        if c not in contigs:
            contigs[c] = [c, s, e, ploidy]
        else:
            contigs[c][1] = min(contigs[c][1], s)
            contigs[c][2] = max(contigs[c][2], e)

    indel_chunks = get_chunks(regions_list, cfg.cpu, max_chunk_size=100000)
    order = sorted(range(len(indel_chunks)),
                   key=lambda i: (list(contigs).index(indel_chunks[i]["chrom"]),
                                  indel_chunks[i]["start"]))
    ordered_chunks = [indel_chunks[i] for i in order]

    results = {}
    todo = []
    for idx, chunk in enumerate(ordered_chunks):
        if manifest.is_done("indel", chunk):
            with open(manifest.shard_path("indel", chunk)) as fh:
                results[idx] = fh.readlines()
            if progress:
                progress(1)
        else:
            todo.append(idx)

    def _inline():
        for idx in todo:
            chunk = ordered_chunks[idx]
            with metrics.timer("indel.features"):
                batch = get_indel_candidates(
                    bam, fasta, chunk, seq_type=cfg.sequencing,
                    mincov=cfg.mincov, maxcov=cfg.maxcov,
                    ins_t=cfg.ins_threshold, del_t=cfg.del_threshold,
                    win_size=cfg.win_size,
                    small_win_size=cfg.small_win_size,
                    impute_indel_phase=cfg.impute_indel_phase,
                    exclude=exclude,
                    ploidy=chunk.get("ploidy", "diploid"),
                    device=state.device)
            yield idx, batch

    def _write_shard(idx):
        chunk = ordered_chunks[idx]
        shard = os.path.join(
            manifest.shard_dir,
            "indel_%s_%d.body" % (chunk["chrom"], chunk["start"]))
        with open(shard, "w") as fh:
            fh.writelines(results[idx])
        manifest.mark_done("indel", chunk, shard)
        if progress:
            progress(1)

    with metrics.timer("indel_calling"):
        # accumulate chunks and run one device pass per ~flush_at
        # candidates: 100 kb chunks carry only a handful each
        pending = []  # (idx, batch)
        pend_n = 0
        flush_at = 384

        def _flush():
            nonlocal pending, pend_n
            dip = [(i, b) for i, b in pending
                   if ordered_chunks[i].get("ploidy") != "haploid"]
            hap = [(i, b) for i, b in pending
                   if ordered_chunks[i].get("ploidy") == "haploid"]
            with metrics.timer("indel.infer_decode"):
                for probs, (i, b) in zip(
                        infer_indel_many(state, [b for _, b in dip]), dip):
                    results[i] = decode_diploid_indels(b, probs)
                    _write_shard(i)
                for probs, (i, b) in zip(
                        infer_haploid_indel_many(state, [b for _, b in hap]),
                        hap):
                    results[i] = decode_haploid_indels(b, probs)
                    _write_shard(i)
            pending = []
            pend_n = 0

        for idx, batch in _inline():
            metrics.count("indel_candidates", len(batch))
            if len(batch) == 0:
                results[idx] = []
                _write_shard(idx)
                continue
            pending.append((idx, batch))
            pend_n += len(batch)
            if pend_n >= flush_at:
                _flush()
        _flush()
    metrics.count("indel_chunks", len(ordered_chunks))
    chunk_lines = [results.get(i, []) for i in range(len(ordered_chunks))]
    return write_indel_vcf(cfg, list(contigs), chunk_lines, cfg.output)
