"""Feature workers of the port: host processes that never import torch.

The device has one owner, the main process. Under `--cpu N` the host
work fans out to N worker processes (started with `spawn` by
runtime/scheduler.py): the SNP payloads (by decode group or by chunk),
the per-contig phasing and the indel job records. A worker stops before
anything that runs on the device: it returns the indel candidates' MSA
jobs, and the main process aligns every worker's pairs on the card
(kernels K1, K2, K4, pileup/indel_features.finish_indel_jobs) and builds
the SNP pileups (kernels K3 and K5). A worker that imported torch could
create a CUDA context and hold card memory, so this module and
everything it imports use only io/, pileup/ (not snp_pileup.py or
snp_dense.py), phase/, align/{nw,msa}.py, numpy and the standard
library.

Each task returns, last, the number of CRAM windows its Python decoder
took, which the main process adds to its own reader's count.
"""

from __future__ import annotations

import time

from . import watchdog

_G = {}


def init_worker(bam_path, fasta_path, cfg_kwargs, exclude_path):
    """Open this process's file handles (the pool initializer; the inline
    path calls it in the main process)."""
    from ..io.bam import open_alignment
    from ..io.bed import BedIntervals
    from ..io.fasta import FastaFile

    _G["fasta"] = FastaFile(fasta_path)
    _G["bam"] = open_alignment(bam_path, fasta=_G["fasta"])
    if _G["bam"].format == "CRAM":
        # the main process's reader prints the layout warning, once for
        # all the workers (_python_windows)
        _G["bam"].warn_python_windows = False
    _G["bam_path"] = bam_path
    _G["bam_cache"] = {bam_path: _G["bam"]}
    _G["cfg"] = cfg_kwargs
    _G["exclude"] = BedIntervals(exclude_path) if exclude_path else None


def _python_windows():
    """The CRAM windows the Python decoder took since the last task (0
    for a BAM)."""
    bam = _G["bam"]
    n = getattr(bam, "python_windows", 0)
    if n:
        bam.python_windows = 0
    return n


def _bam_for(path):
    from ..io.bam import open_alignment

    cache = _G["bam_cache"]
    if path not in cache:
        cache[path] = open_alignment(path, fasta=_G["fasta"])
    return cache[path]


def snp_features_worker(task):
    """(idx, chunk) → (idx, SnpChunkFeatures | SnpBatch, python_windows):
    one chunk decoded and scanned on its own (snp_group_span <= -1), as
    SnpChunkFeatures, or the dense SnpBatch under dedup_transfer=False
    (and where the chunk is over _TABLE_CELL_CAP)."""
    idx, chunk = task
    from ..pileup.snp_features import (get_snp_candidates,
                                       get_snp_chunk_features)

    cfg = _G["cfg"]
    builder = get_snp_chunk_features if cfg["dedup_transfer"] \
        else get_snp_candidates
    feats = builder(
        _G["bam"], _G["fasta"], chunk,
        seq_type=cfg["sequencing"], mincov=cfg["mincov"],
        maxcov=cfg["maxcov"], min_allele_freq=cfg["min_allele_freq"],
        min_nbr_sites=cfg["min_nbr_sites"], threshold=cfg["threshold"],
        ploidy=chunk.get("ploidy", "diploid"), exclude=_G["exclude"])
    return idx, feats, _python_windows()


def snp_features_group_worker(task):
    """(idx, [(orig_idx, chunk), ...]) → (idx, payloads, python_windows).

    The coordinate-adjacent chunks of a decode group are decoded once
    and scanned. By default (pileup/snp_features.get_snp_group_payloads)
    the payloads are one SnpGroupFeatures for the group, or one a member
    where the group is over the payload caps, each with members
    (orig_idx, SnpGroupMember | None), and (orig_idx, SnpChunkFeatures |
    SnpBatch) for a member over the caps on its own. With
    snp_group_payload=False or dedup_transfer=False every member comes
    back as (orig_idx, its own payload) (get_snp_group_features)."""
    idx, group = task
    from ..pileup.snp_features import (get_snp_group_features,
                                       get_snp_group_payloads)

    cfg = _G["cfg"]
    kw = dict(
        seq_type=cfg["sequencing"], mincov=cfg["mincov"],
        maxcov=cfg["maxcov"], min_allele_freq=cfg["min_allele_freq"],
        min_nbr_sites=cfg["min_nbr_sites"], threshold=cfg["threshold"],
        exclude=_G["exclude"])
    chunks = [c for _, c in group]
    if not (cfg["dedup_transfer"] and cfg["snp_group_payload"]):
        feats = get_snp_group_features(_G["bam"], _G["fasta"], chunks,
                                       dedup=cfg["dedup_transfer"], **kw)
        return idx, [(oi, f) for (oi, _), f in zip(group, feats)], \
            _python_windows()
    payloads = get_snp_group_payloads(_G["bam"], _G["fasta"], chunks, **kw)
    idx_of = {id(c): oi for oi, c in group}
    for k, p in enumerate(payloads):
        if isinstance(p, tuple):
            payloads[k] = (idx_of[id(p[0])], p[1])
        else:
            p.members = [(idx_of[id(m)], sec) for m, sec in p.members]
    return idx, payloads, _python_windows()


def write_tags(path, tags):
    """Write a contig's haplotag sidecar (tags.tsv): one
    qname\thp\tps line a read of {qname: (hp, ps)}."""
    with open(path, "w") as fh:
        for qn, t in tags.items():
            fh.write("%s\t%d\t%d\n" % (qn, t[0], t[1]))


def load_tags(path):
    """Read a haplotag sidecar written by write_tags."""
    tags = {}
    with open(path) as fh:
        for line in fh:
            qn, hp, ps = line.rstrip("\n").split("\t")
            tags[qn] = (int(hp), int(ps))
    return tags


def _tags_for(path):
    """A contig's haplotag sidecar, loaded once per process."""
    cache = _G.setdefault("tags_cache", {})
    if path not in cache:
        cache[path] = load_tags(path)
    return cache[path]


def indel_features_group_worker(task):
    """(idx, [(orig_idx, chunk), ...]) →
    (idx, [(orig_idx, job record), ...], seconds, python_windows).

    Coordinate-adjacent indel chunks share one deferred decode + one
    pseudo-event emit (pileup/indel_features.get_indel_group_candidates);
    each member's record holds its candidates' MSA jobs, which the main
    process finishes on the device (finish_indel_jobs). A chunk with a
    'tags_path' takes its contig's haplotag sidecar, injected in memory
    after the decode. `seconds` is the task's wall in the worker, summed
    into metrics.timers["indel.features_core"]."""
    t0 = time.perf_counter()
    idx, group = task
    from ..pileup.indel_features import get_indel_group_candidates

    cfg = _G["cfg"]
    chunk0 = group[0][1]
    bam = _bam_for(chunk0.get("sam_path") or _G["bam_path"])
    tags = None
    tags_path = chunk0.get("tags_path")
    if tags_path and not chunk0.get("sam_path"):
        tags = _tags_for(tags_path)
    records = get_indel_group_candidates(
        bam, _G["fasta"], [c for _, c in group], seq_type=cfg["sequencing"],
        mincov=cfg["mincov"], maxcov=cfg["maxcov"],
        ins_t=cfg["ins_threshold"], del_t=cfg["del_threshold"],
        win_size=cfg["win_size"], small_win_size=cfg["small_win_size"],
        impute_indel_phase=cfg["impute_indel_phase"], exclude=_G["exclude"],
        tags=tags)
    return (idx, [(oi, r) for (oi, _), r in zip(group, records)],
            time.perf_counter() - t0, _python_windows())


def phase_one_contig(bam, snp_reader, chrom, start, end, out_vcf, lowq_vcf,
                     *, phase_qual_score, distrust, cell_budget,
                     n_threads=None):
    """Phase one diploid contig from the PASS SNP VCF's records: split
    them by QUAL as written (%.3f) at phase_qual_score, decode the
    contig's reads at the high-QUAL het sites, run exact wMEC, and write
    the phased VCF (and the low-QUAL passthrough when there is one).
    Shared by the inline path (caller._phase) and phase_contig_worker.
    Returns (the reads' {qname: (hp, ps)}, files written, decode seconds,
    wMEC seconds)."""
    from ..io.vcf import VcfWriter
    from ..phase.mec import haplotag_reads, phase_contig, write_phased_vcf
    from ..pileup.engine import decode_reads_parallel

    # milestone heartbeats: a contig's decode and phasing are legitimate
    # multi-minute host work at genome scale and must not look like a
    # stall to a supervising --watchdog (spawned workers inherit the
    # heartbeat env; they never touch the device)
    watchdog.beat()
    recs = list(snp_reader.fetch(chrom, start, end))
    hiq = [r for r in recs if r.qual_value >= phase_qual_score]
    lowq = [r for r in recs if r.qual_value < phase_qual_score]
    watchdog.beat()
    t0 = time.perf_counter()
    # site-filtered decode: phasing only needs read codes at the het sites
    rw = decode_reads_parallel(bam, chrom, max(0, start - 1), end,
                               keep_seq=False,
                               sites=sorted(r.pos - 1 for r in hiq))
    watchdog.beat()
    t1 = time.perf_counter()
    result, phase_map = phase_contig(hiq, rw, distrust=distrust,
                                     cell_budget=cell_budget,
                                     n_threads=n_threads)
    watchdog.beat()
    t2 = time.perf_counter()

    class _Recs:
        header_lines = snp_reader.header_lines

        def __iter__(self):
            return iter(hiq)

    write_phased_vcf(_Recs(), out_vcf, phase_map)
    files = [out_vcf]
    if lowq:
        with VcfWriter(lowq_vcf, snp_reader.header_lines) as w:
            for r in lowq:
                w.write(r)
        files.append(lowq_vcf)
    return haplotag_reads(rw, result), files, t1 - t0, t2 - t1


def phase_contig_worker(task):
    """(idx, job) → (idx, summary, python_windows): phase one contig in a
    worker, so that a contig's indel chunks can start the moment it is
    phased while other contigs still phase (the reference's dual-role
    worker unlock, indelCaller.py:253-262,320-336).

    job keys: chrom, start, end (1-based), snp_vcf, out_vcf, lowq_vcf,
    tags_path, phase_threads. Writes what phase_one_contig writes and the
    qname→(hp, ps) sidecar."""
    t0 = time.perf_counter()
    idx, job = task
    from ..io.vcf import VcfReader

    cfg = _G["cfg"]
    tags, files, decode_s, mec_s = phase_one_contig(
        _G["bam"], VcfReader(job["snp_vcf"]), job["chrom"], job["start"],
        job["end"], job["out_vcf"], job["lowq_vcf"],
        phase_qual_score=cfg["phase_qual_score"],
        distrust=cfg["enable_whatshap"],
        cell_budget=cfg["phase_cell_budget"],
        n_threads=job["phase_threads"])
    write_tags(job["tags_path"], tags)
    return idx, {"chrom": job["chrom"], "files": files,
                 "tags_path": job["tags_path"], "n_tags": len(tags),
                 "seconds": time.perf_counter() - t0,
                 "decode_s": decode_s, "mec_s": mec_s}, _python_windows()


def cfg_kwargs_for_workers(cfg):
    """The Config fields a worker reads, as a picklable dict."""
    return dict(
        sequencing=cfg.sequencing, mincov=cfg.mincov, maxcov=cfg.maxcov,
        min_allele_freq=cfg.min_allele_freq, min_nbr_sites=cfg.min_nbr_sites,
        threshold=cfg.threshold, ins_threshold=cfg.ins_threshold,
        del_threshold=cfg.del_threshold, win_size=cfg.win_size,
        small_win_size=cfg.small_win_size,
        impute_indel_phase=cfg.impute_indel_phase,
        dedup_transfer=cfg.dedup_transfer,
        snp_group_payload=cfg.snp_group_payload,
        phase_qual_score=cfg.phase_qual_score,
        phase_cell_budget=cfg.phase_cell_budget,
        enable_whatshap=cfg.enable_whatshap)
