"""End-to-end orchestration of the port: SNPs → phasing → indels → final
VCF, at `--cpu 1`.

The inline path of nanocaller_tpu/caller.py::run, with the same output
contract:

    PREFIX.unfiltered.snps.vcf.gz   all SNP candidate records (snps, all)
    PREFIX.snps.vcf.gz              PASS SNP calls (snps, all)
    PREFIX.snps.phased.vcf.gz       phased SNPs (all, snps --phase)
    PREFIX.indels.vcf.gz            decomposed non-SNP calls (indels, all)
    PREFIX.vcf.gz                   phased SNPs + indels (all)

and, per diploid contig, the haplotagged artifact
intermediate_phase_files/CONTIG.phased.bam (CONTIG.phased.cram for a
CRAM input; unless --skip_phased_bam).

The host work runs on the port's C++ library (io/native): the BAM/CRAM
decode, the MSA projection, the phasing's read selection and trellis,
and the BAM artifact's retagger.
SNPs: BAM/CRAM → one observation payload per decode group (two-phase
native decode + scan) → neighbour selection and pileups on the device
(kernel K3) → SNP CNN → genotype decode (snp_caller.py).
Phasing, on the host: per diploid contig, the PASS SNP VCF's records
split by QUAL (as written) at --phase_qual_score; the contig's reads
decoded at the high-QUAL het sites; exact wMEC (phase/); the reads'
haplotags, the phased VCF and the artifact, written on a thread while
the indel stage runs.
Indels: BAM/CRAM → candidates (host decode + scan, the phasing's
haplotags injected in memory) → read-vs-ref and allele NW on the device
(kernels K1 + K2) → indel CNN → decode → rtg-style decomposition. In
`--mode indels` the input's own HP/PS tags are read, as the reference's
indel stage does.

`--resume` reuses completed SNP and indel chunks through the run
manifest; phasing reruns, as in the JAX package. `--cpu N > 1` and the
other options not ported yet raise NotImplementedError naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

from .config import Config, resolve_exclude_bed
from .indel_caller import (IndelCallerState, decode_diploid_indels,
                           decode_haploid_indels, infer_haploid_indel_many,
                           infer_indel_many, write_indel_vcf)
from .io.bam import BamWriter, open_alignment
from .io.bed import BedIntervals
from .io.cram import CramWriter
from .io.fasta import FastaFile
from .io.vcf import VcfReader, VcfWriter, concat
from .phase.mec import haplotag_reads, phase_contig, write_phased_vcf
from .pileup.engine import decode_reads_parallel
from .pileup.indel_features import get_indel_candidates
from .runtime.chunker import get_chunks, get_regions_list
from .runtime.metrics import Metrics, profile_region
from .runtime.scheduler import Progress, RunManifest
from .snp_caller import call_snps


def _check_supported(cfg):
    if cfg.cpu != 1:
        raise NotImplementedError(
            "--cpu %d is not ported yet: the port runs --cpu 1; feature "
            "workers and the phase→indel DAG are ROADMAP queue A item A5 "
            "(--cpu N workers)" % cfg.cpu)
    if cfg.num_processes > 1 or cfg.num_shards > 1:
        raise NotImplementedError(
            "multi-process / sharded runs are ROADMAP queue A item A6 "
            "(multi-GPU)")
    if cfg.watchdog:
        raise NotImplementedError("--watchdog is not ported")


def run(cfg: Config, progress=None):
    """Execute the configured pipeline; returns dict of output paths."""
    _check_supported(cfg)
    want_phase = cfg.mode == "all" or (cfg.mode == "snps" and cfg.phase)
    want_indels = cfg.mode in ("indels", "all")
    state = IndelCallerState.create(cfg.indel_model, device=cfg.device) \
        if want_indels else None

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
    if cfg.mode in ("snps", "all"):
        chunks = get_chunks(regions_list, cfg.cpu)
        with metrics.timer("snp_calling"), profile_region(
                os.path.join(cfg.output, "trace"), enabled=cfg.profile):
            outputs["snps"] = call_snps(
                cfg, bam, fasta, regions_list, chunks, cfg.output,
                exclude=exclude, progress=progress, manifest=manifest,
                metrics=metrics)
        metrics.count("snp_chunks", len(chunks))

    # contig extents (indelCaller.py:299-305)
    contigs = {}
    for c, s, e, ploidy in regions_list:
        if c not in contigs:
            contigs[c] = [c, s, e, ploidy]
        else:
            contigs[c][1] = min(contigs[c][1], s)
            contigs[c][2] = max(contigs[c][2], e)

    tags_by_contig = {}
    artifacts = []  # (thread, {"s": seconds, "error": exception})
    if want_phase:
        with metrics.timer("phasing"):
            outputs["phased_snps"] = _phase(cfg, bam, outputs["snps"],
                                            contigs, metrics,
                                            tags_by_contig, artifacts)
    if want_indels:
        outputs["indels"] = _call_indels(cfg, state, bam, fasta,
                                         regions_list, contigs, exclude,
                                         manifest, metrics, progress,
                                         tags_by_contig)
    if cfg.mode == "all" and outputs["phased_snps"] and outputs["indels"]:
        final = os.path.join(cfg.output, "%s.vcf.gz" % cfg.prefix)
        concat([outputs["phased_snps"], outputs["indels"]], final)
        outputs["final"] = final
    for th, res in artifacts:
        th.join()
        metrics.timers["phase.haplotag_bam"] += res["s"]
    errors = [res["error"] for _, res in artifacts if res["error"]]
    if errors:
        raise errors[0]
    if owns_progress:
        bar.close()
    metrics.dump(os.path.join(cfg.output, "metrics.json"))
    return outputs


def _phase(cfg, bam, snp_vcf, contigs, metrics, tags_by_contig, artifacts):
    """Phase each diploid contig from the written PASS SNP VCF (haploid
    contigs are copied unphased); fills tags_by_contig with each
    contig's {qname: (hp, ps)} and starts the artifact writers. Returns
    the snps.phased.vcf.gz path, or None without SNP records."""
    phase_dir = os.path.join(cfg.output, "intermediate_phase_files")
    os.makedirs(phase_dir, exist_ok=True)
    if not os.path.exists(snp_vcf):
        return None
    snp_reader = VcfReader(snp_vcf)
    phased_files = []
    for name, (c, s, e, ploidy) in contigs.items():
        out_vcf = os.path.join(phase_dir, "%s.snps.phased.vcf.gz" % name)
        recs = list(snp_reader.fetch(name, s, e))
        if ploidy == "haploid":
            # no phasing for haploid contigs (indelCaller.py:193-211)
            with VcfWriter(out_vcf, snp_reader.header_lines) as w:
                for r in recs:
                    w.write(r)
            phased_files.append(out_vcf)
            continue
        # QUAL as written (%.3f), not the in-memory probability: the
        # split is the JAX package's, on the same text
        hiq = [r for r in recs if r.qual_value >= cfg.phase_qual_score]
        lowq = [r for r in recs if r.qual_value < cfg.phase_qual_score]
        with metrics.timer("phase.decode"):
            # site-filtered decode: phasing only needs read codes at the
            # het sites
            het_sites = sorted(r.pos - 1 for r in hiq)
            rw = decode_reads_parallel(bam, name, max(0, s - 1), e,
                                       keep_seq=False, sites=het_sites)
        with metrics.timer("phase.mec"):
            result, phase_map = phase_contig(
                hiq, rw, distrust=cfg.enable_whatshap,
                cell_budget=cfg.phase_cell_budget)
        tags = haplotag_reads(rw, result)
        tags_by_contig[name] = tags

        class _Recs:
            header_lines = snp_reader.header_lines

            def __iter__(self):
                return iter(hiq)

        write_phased_vcf(_Recs(), out_vcf, phase_map)
        phased_files.append(out_vcf)
        if lowq:
            lowq_vcf = os.path.join(
                phase_dir, "%s.snps.lowq.unphased.vcf.gz" % name)
            with VcfWriter(lowq_vcf, snp_reader.header_lines) as w:
                for r in lowq:
                    w.write(r)
            phased_files.append(lowq_vcf)
        # the haplotagged BAM is a user artifact only (the indel stage
        # takes the tags in memory): written on a thread that overlaps
        # the indel stage, joined before run() returns
        if not cfg.skip_phased_bam:
            artifacts.append(_start_artifact_writer(
                cfg, name, max(0, s - 1), e, tags,
                _phased_path(phase_dir, name, bam.format)))
    if not phased_files:
        return None
    phased_out = os.path.join(cfg.output, "%s.snps.phased.vcf.gz" % cfg.prefix)
    concat(phased_files, phased_out)
    return phased_out


def _start_artifact_writer(cfg, contig, start0, end0, tags, out_path):
    """Write one contig's haplotagged BAM/CRAM artifact on a background
    thread with its own FASTA and alignment handles (readers are not
    thread-safe). Returns (thread, {"s": seconds, "error": exception})."""
    res = {"s": 0.0, "error": None}
    # deflate threads of the native retagger: beside the indel stage in
    # --mode all, leave the process's own core alone but keep at least
    # two (the JAX package's budget)
    threads = 0
    if cfg.mode == "all":
        threads = max(2, (os.cpu_count() or 2) - cfg.cpu)

    def _write():
        t0 = time.perf_counter()
        try:
            fasta = FastaFile(cfg.ref)
            abam = open_alignment(cfg.bam, fasta=fasta)
            try:
                write_haplotagged_bam(abam, out_path, contig, start0, end0,
                                      tags, fasta=fasta,
                                      level=cfg.phased_bam_compression,
                                      threads=threads)
            finally:
                abam.close()
        except Exception as e:  # noqa: BLE001 — re-raised by run()
            res["error"] = e
        res["s"] = time.perf_counter() - t0

    th = threading.Thread(target=_write, daemon=True)
    th.start()
    return th, res


def _phased_path(phase_dir, contig, fmt):
    """Per-contig haplotagged artifact path; the format follows the input
    (the reference emits phased CRAM for CRAM input, indelCaller.py:248)."""
    ext = "cram" if fmt == "CRAM" else "bam"
    return os.path.join(phase_dir, "%s.phased.%s" % (contig, ext))


def write_haplotagged_bam(bam, out_path, contig, start0, end0, tags,
                          fasta=None, level=6, threads=0, use_native=True):
    """Write the phased-BAM/CRAM artifact (whatshap haplotag | samtools
    view equivalent, indelCaller.py:243-251): the window's reads with
    HP/PS set from tags.

    A BAM is written by the native single-pass retagger (record bytes
    pass through, HP/PS spliced, BGZF at deflate `level` with `threads`
    deflate threads, BAI; the C++ pass releases the GIL); use_native=False
    takes the Python BamWriter, its oracle, which re-encodes each record
    (the BGZF bytes differ, the decoded records are the same). A path
    ending .cram is written by the CramWriter (needs `fasta`)."""
    if out_path.endswith(".cram"):
        writer = CramWriter(out_path, bam.references, bam.lengths, fasta)
    elif use_native:
        from .io.native import haplotag_native

        return haplotag_native(bam, out_path, contig, start0, end0, tags,
                               level=level, threads=threads)
    else:
        writer = BamWriter(out_path, bam.references, bam.lengths)
    with writer as w:
        for read in bam.fetch(contig, start0, end0):
            t = tags.get(read.qname)
            if t is not None:
                read.tags["HP"] = t[0]
                read.tags["PS"] = t[1]
            w.write(read)
    return out_path


def _call_indels(cfg, state, bam, fasta, regions_list, contigs, exclude,
                 manifest, metrics, progress, tags_by_contig):
    """The inline indel stage; returns the indels.vcf.gz path. A chunk's
    reads take the haplotags its contig's phasing found (haploid contigs
    are not phased, so theirs keep the BAM's own)."""
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
                    tags=tags_by_contig.get(chunk["chrom"]),
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
