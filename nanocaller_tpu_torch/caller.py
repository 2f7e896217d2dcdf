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
(kernels K1, K2, K4) → indel CNN → decode → rtg-style decomposition. In
`--mode indels` the input's own HP/PS tags are read, as the reference's
indel stage does.

`--cpu N > 1`: the host work runs in N feature workers that never
import torch (runtime/workers.py, spawned): the SNP group payloads, the
phasing of each diploid contig, and the indel candidates' MSA jobs. This
process owns the device: it runs K3 and the SNP CNN on each payload as
it arrives, and gathers the workers' indel jobs, contig by contig in
chunk order, into finish_indel_jobs (every pending chunk's pairs in one
K1/K2/K4 round) and the indel CNN. With phasing (`--mode all`, `snps
--phase`) the stages form a per-contig DAG: a contig's indel chunks
start the moment its phasing is done, while other contigs still phase
(_run_phase_indel_dag).

Several processes (`--num_processes N` with `--coordinator`,
`--process_id`; runtime/distributed.py): each process joins a Gloo
process group, takes a round-robin share of the regions and its own
card (cuda:(i mod cards)), and writes host-suffixed outputs
(PREFIX.host00i.*, intermediate_*.host00i, metrics.host00i.json); at
the end a barrier, the run counters summed over the processes, and
process 0's merge into the file set above. `--num_shards N
--shard_index i` runs one such share alone (merge with
`--merge_shards`). One process over several cards splits the CNN
batches over them (runtime/sharding.py).

`--resume` reuses completed SNP and indel chunks through the run
manifest; phasing reruns, as in the JAX package. `--watchdog` is
cli.main's: it supervises a child CLI process that runs this function
and relaunches it with --resume when it stops making progress
(runtime/watchdog.py; the run beats on its copy-backs, manifest writes
and phasing milestones).
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
from .pileup.indel_features import (finish_indel_jobs, get_indel_candidates,
                                    n_jobs)
from .runtime import distributed
from .runtime.chunker import (get_chunks, get_regions_list,
                              group_adjacent_chunks)
from .runtime.device import cpu_settings
from .runtime.metrics import Metrics, profile_region
from .runtime.scheduler import Progress, RunManifest, feature_stream
from .runtime.workers import (cfg_kwargs_for_workers,
                              indel_features_group_worker, load_tags,
                              phase_contig_worker, phase_one_contig)
from .snp_caller import call_snps

# shared-decode group span for 100 kb indel chunks: ~16 chunks per worker
# task amortizes the per-window decode while keeping dozens of tasks in
# flight for load balance
_INDEL_GROUP_SPAN = 1_600_000
# indel candidates (--cpu 1) or MSA jobs (--cpu N) gathered per device
# pass: 100 kb chunks carry only a handful each
_FLUSH_AT = 384


def run(cfg: Config, progress=None):
    """Execute the configured pipeline; returns dict of output paths."""
    # multi-process mode: join the process group and derive the region
    # shard and this process's card from the process index (one command
    # a process)
    dist_active = cfg.num_processes > 1
    base_prefix = cfg.prefix
    if dist_active:
        rank, world = distributed.initialize(
            cfg.coordinator or None, cfg.num_processes, cfg.process_id)
        cfg.num_shards, cfg.shard_index = world, rank
        cfg.device = distributed.process_device(cfg.device, rank)
    # concurrent same-directory shard runs keep all their mutable state
    # host-suffixed so they never clobber each other
    host_tag = (".host%03d" % cfg.shard_index) if cfg.num_shards > 1 else ""
    want_phase = cfg.mode == "all" or (cfg.mode == "snps" and cfg.phase)
    want_indels = cfg.mode in ("indels", "all")
    state = IndelCallerState.create(cfg.indel_model, device=cfg.device) \
        if want_indels else None

    os.makedirs(cfg.output, exist_ok=True)
    cfg.dump(os.path.join(cfg.output, "args" + host_tag))
    metrics = Metrics()
    # what this process's CPU ops (the NW twins on --device cpu) ran with
    metrics.extra["cpu_settings"] = cpu_settings()
    owns_progress = False
    if progress is None and not cfg.suppress_progress:
        bar = Progress(None, "calling", suppress=cfg.suppress_progress)
        progress = bar.update
        owns_progress = True

    def finish(outputs):
        """With several processes: the barrier, then the counters summed
        over the processes (metrics' `global_counts`, `hosts`), then
        process 0's merge of the shards, then leaving the group. Then
        this process's metrics."""
        if dist_active:
            distributed.barrier()
            metrics.extra["global_counts"] = distributed.allreduce_counts(
                dict(metrics.counts))
            metrics.extra["hosts"] = cfg.num_shards
            if cfg.shard_index == 0:
                outputs.update(distributed.merge_host_outputs(
                    cfg.output, base_prefix, cfg.num_shards))
            distributed.shutdown()
        metrics.dump(os.path.join(cfg.output, "metrics%s.json" % host_tag))
        return outputs

    manifest_path = os.path.join(cfg.output, "run_manifest%s.json" % host_tag)
    shard_dir = os.path.join(cfg.output, "intermediate_shards" + host_tag)
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
    exclude = exclude_path = None
    if cfg.exclude_bed:
        exclude_path = resolve_exclude_bed(cfg.exclude_bed)
        exclude = BedIntervals(exclude_path)

    regions_list = get_regions_list(cfg, bam)
    outputs = {"snps": None, "phased_snps": None, "indels": None, "final": None}
    if cfg.num_shards > 1:
        # region sharding across processes: a deterministic round-robin
        # share of the regions (contig-granular where there are enough
        # contigs, so per-contig phasing stays whole; split sub-contig
        # otherwise so every process gets work), written with suffixed
        # names that merge_host_outputs combines
        regions_list = distributed.shard_regions(
            regions_list, cfg.shard_index, cfg.num_shards)
        cfg.prefix = "%s.host%03d" % (cfg.prefix, cfg.shard_index)
        if not regions_list:
            return finish(outputs)
    if cfg.mode in ("snps", "all"):
        chunks = get_chunks(regions_list, cfg.cpu)
        # the profiler outside the stage's timer, so that the trace holds
        # the stage's own span
        with profile_region(os.path.join(cfg.output, "trace"),
                            enabled=cfg.profile), \
                metrics.timer("snp_calling"):
            outputs["snps"] = call_snps(
                cfg, bam, regions_list, chunks, cfg.output,
                progress=progress, manifest=manifest, metrics=metrics,
                exclude_path=exclude_path)
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
    phase_dir = os.path.join(cfg.output, "intermediate_phase_files" + host_tag)
    if want_phase and cfg.cpu > 1:
        # per-contig phase→indel DAG: contigs phase in workers and each
        # contig's indel chunks start the moment it is phased
        snp_vcf = outputs["snps"] or os.path.join(
            cfg.output, "%s.snps.vcf.gz" % cfg.prefix)
        with metrics.timer("phase_indel_dag"):
            dag = _run_phase_indel_dag(
                cfg, state, bam, snp_vcf, contigs, regions_list, manifest,
                metrics, progress, exclude_path, want_indels, artifacts,
                phase_dir)
        if dag["phased_files"]:
            phased_out = os.path.join(cfg.output,
                                      "%s.snps.phased.vcf.gz" % cfg.prefix)
            concat(dag["phased_files"], phased_out)
            outputs["phased_snps"] = phased_out
        if want_indels:
            outputs["indels"] = write_indel_vcf(
                cfg, list(contigs), dag["chunk_lines"], cfg.output)
    else:
        if want_phase:
            with metrics.timer("phasing"):
                outputs["phased_snps"] = _phase(cfg, bam, outputs["snps"],
                                                contigs, metrics,
                                                tags_by_contig, artifacts,
                                                phase_dir)
        if want_indels:
            outputs["indels"] = _call_indels(cfg, state, bam, fasta,
                                             regions_list, contigs, exclude,
                                             exclude_path, manifest, metrics,
                                             progress, tags_by_contig)
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
    if bam.format == "CRAM":
        metrics.count("cram.python_windows", bam.python_windows)
    if owns_progress:
        bar.close()
    return finish(outputs)


def _phase(cfg, bam, snp_vcf, contigs, metrics, tags_by_contig, artifacts,
           phase_dir):
    """Phase each diploid contig from the written PASS SNP VCF (haploid
    contigs are copied unphased) into phase_dir; fills tags_by_contig
    with each contig's {qname: (hp, ps)} and starts the artifact
    writers. Returns the snps.phased.vcf.gz path, or None without SNP
    records."""
    os.makedirs(phase_dir, exist_ok=True)
    if not os.path.exists(snp_vcf):
        return None
    snp_reader = VcfReader(snp_vcf)
    phased_files = []
    for name, (c, s, e, ploidy) in contigs.items():
        out_vcf = os.path.join(phase_dir, "%s.snps.phased.vcf.gz" % name)
        if ploidy == "haploid":
            # no phasing for haploid contigs (indelCaller.py:193-211)
            with VcfWriter(out_vcf, snp_reader.header_lines) as w:
                for r in snp_reader.fetch(name, s, e):
                    w.write(r)
            phased_files.append(out_vcf)
            continue
        tags, files, decode_s, mec_s = phase_one_contig(
            bam, snp_reader, name, s, e, out_vcf, os.path.join(
                phase_dir, "%s.snps.lowq.unphased.vcf.gz" % name),
            phase_qual_score=cfg.phase_qual_score,
            distrust=cfg.enable_whatshap, cell_budget=cfg.phase_cell_budget)
        metrics.timers["phase.decode"] += decode_s
        metrics.timers["phase.mec"] += mec_s
        tags_by_contig[name] = tags
        phased_files.extend(files)
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


class _IndelSink:
    """The indel stage's end in the device owner: batches or workers' job
    records in, each chunk's VCF lines (and manifest shard) out.

    add_batch (the inline --cpu 1 path) pools chunks' batches until they
    hold _FLUSH_AT candidates, then runs one CNN pass over them.
    add_record (--cpu N) takes a worker's job record in completion order
    and moves it into its contig's queue in chunk order; a contig's queue
    is finished (finish_indel_jobs: one K1/K2/K4 round over all its pairs,
    timer `indel.align_finish`, split in `indel.align_finish.*`) and sent
    through the CNN once it holds _FLUSH_AT jobs or the contig's last
    chunk. What shares a device pass
    therefore depends on the data only, never on the order of arrival,
    and two runs give the same bytes."""

    def __init__(self, cfg, state, ordered_chunks, manifest, metrics,
                 progress):
        self.cfg, self.state = cfg, state
        self.chunks = ordered_chunks
        self.manifest, self.metrics, self.progress = manifest, metrics, \
            progress
        self.results = {}
        self.todo = []
        for idx, chunk in enumerate(ordered_chunks):
            if manifest.is_done("indel", chunk):
                with open(manifest.shard_path("indel", chunk)) as fh:
                    self.results[idx] = fh.readlines()
                if progress:
                    progress(1)
            else:
                self.todo.append(idx)
        self.pending = []  # (idx, batch) awaiting a CNN pass
        self.pend_n = 0
        self.queue = {}  # contig -> [pending todo idx, in chunk order]
        for idx in self.todo:
            self.queue.setdefault(ordered_chunks[idx]["chrom"], []).append(idx)
        self.arrived = {}  # idx -> record, not yet in its contig's order
        self.ready = {}  # contig -> [(idx, record)] in chunk order

    def _write_shard(self, idx):
        chunk = self.chunks[idx]
        shard = os.path.join(
            self.manifest.shard_dir,
            "indel_%s_%d.body" % (chunk["chrom"], chunk["start"]))
        with open(shard, "w") as fh:
            fh.writelines(self.results[idx])
        self.manifest.mark_done("indel", chunk, shard)
        if self.progress:
            self.progress(1)

    def add_batch(self, idx, batch):
        self.metrics.count("indel_candidates", len(batch))
        if len(batch) == 0:
            self.results[idx] = []
            self._write_shard(idx)
            return
        self.pending.append((idx, batch))
        self.pend_n += len(batch)
        if self.pend_n >= _FLUSH_AT:
            self.flush()

    def flush(self):
        """One CNN pass over the pooled batches, then decode."""
        haploid = lambda i: self.chunks[i].get("ploidy") == "haploid"
        dip = [(i, b) for i, b in self.pending if not haploid(i)]
        hap = [(i, b) for i, b in self.pending if haploid(i)]
        with self.metrics.timer("indel.infer_decode"):
            for probs, (i, b) in zip(
                    infer_indel_many(self.state, [b for _, b in dip]), dip):
                self.results[i] = decode_diploid_indels(b, probs)
                self._write_shard(i)
            for probs, (i, b) in zip(
                    infer_haploid_indel_many(self.state,
                                             [b for _, b in hap]), hap):
                self.results[i] = decode_haploid_indels(b, probs)
                self._write_shard(i)
        self.pending = []
        self.pend_n = 0

    def add_record(self, idx, rec):
        contig = self.chunks[idx]["chrom"]
        self.arrived[idx] = rec
        queue = self.queue[contig]
        while queue and queue[0] in self.arrived:
            i = queue.pop(0)
            ready = self.ready.setdefault(contig, [])
            ready.append((i, self.arrived.pop(i)))
            if n_jobs([r for _, r in ready]) >= _FLUSH_AT:
                self._finish(contig)
        if not queue:
            self._finish(contig)

    def _finish(self, contig):
        ready = self.ready.pop(contig, [])
        if not ready:
            return
        with self.metrics.timer("indel.align_finish"):
            batches = finish_indel_jobs([r for _, r in ready],
                                        device=self.state.device,
                                        timers=self.metrics.timers)
        for (idx, _), batch in zip(ready, batches):
            self.add_batch(idx, batch)
        self.flush()

    def chunk_lines(self):
        self.flush()
        missing = [i for i in self.todo if i not in self.results]
        if missing:
            raise RuntimeError("indel chunks %s got no result" % missing[:5])
        return [self.results[i] for i in range(len(self.chunks))]


def _ordered_indel_chunks(cfg, regions_list, contigs):
    """The 100 kb indel chunks in contig order, then by start."""
    indel_chunks = get_chunks(regions_list, cfg.cpu, max_chunk_size=100000)
    names = list(contigs)
    return sorted(indel_chunks,
                  key=lambda c: (names.index(c["chrom"]), c["start"]))


def _call_indels(cfg, state, bam, fasta, regions_list, contigs, exclude,
                 exclude_path, manifest, metrics, progress, tags_by_contig):
    """The indel stage without the DAG; returns the indels.vcf.gz path.

    --cpu 1: each chunk's candidates are built and aligned here
    (get_indel_candidates), its reads taking the haplotags its contig's
    phasing found (haploid contigs are not phased, so theirs keep the
    BAM's own). --cpu N (`--mode indels`): coordinate-adjacent chunks go
    to the feature workers in groups and their job records come back to
    the sink; `indel.features` is this process's wait for them."""
    ordered_chunks = _ordered_indel_chunks(cfg, regions_list, contigs)
    sink = _IndelSink(cfg, state, ordered_chunks, manifest, metrics,
                      progress)
    with metrics.timer("indel_calling"):
        if cfg.cpu > 1:
            stream = feature_stream(
                group_adjacent_chunks(ordered_chunks, sink.todo,
                                      _INDEL_GROUP_SPAN),
                indel_features_group_worker,
                (cfg.bam, cfg.ref, cfg_kwargs_for_workers(cfg),
                 exclude_path), cfg.cpu)
            while True:
                with metrics.timer("indel.features"):
                    item = next(stream, None)
                if item is None:
                    break
                _gi, members, secs, py_windows = item
                if py_windows:
                    bam.note_python_windows(py_windows)
                metrics.timers["indel.features_core"] += secs
                for idx, rec in members:
                    sink.add_record(idx, rec)
        else:
            for idx in sink.todo:
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
                        device=state.device, timers=metrics.timers)
                sink.add_batch(idx, batch)
        chunk_lines = sink.chunk_lines()
    metrics.count("indel_chunks", len(ordered_chunks))
    return write_indel_vcf(cfg, list(contigs), chunk_lines, cfg.output)


def _run_phase_indel_dag(cfg, state, bam, snp_vcf, contigs, regions_list,
                         manifest, metrics, progress, exclude_path,
                         want_indels, artifacts, phase_dir):
    """Per-contig phase→indel DAG (cfg.cpu > 1 with phasing).

    Phasing fans out across the worker pool (one task per diploid
    contig, each with a share of the trellis threads), and each contig's
    indel chunks are submitted, in shared-decode groups, the moment that
    contig's phasing is done, with its haplotag sidecar (tags.tsv) — the
    reference's dual-role worker unlock (indelCaller.py:253-262,320-336).
    A haploid contig is copied unphased and unlocked at once. A phased
    contig's artifact is written on a thread of this process. This
    process owns the device: the workers' job records go through the
    _IndelSink (finish_indel_jobs on K1/K2/K4, then the indel CNN). A
    stage timeline lands in metrics.json (stage_timeline).

    Returns {"phased_files": [...ordered...], "chunk_lines": [...]}."""
    from concurrent.futures import FIRST_COMPLETED, wait
    from concurrent.futures.process import BrokenProcessPool

    from .runtime.scheduler import worker_pool

    t_start = time.perf_counter()
    stamp = lambda: round(time.perf_counter() - t_start, 4)
    timeline = []
    os.makedirs(phase_dir, exist_ok=True)
    phased_by_contig = {}
    ordered_chunks = _ordered_indel_chunks(cfg, regions_list, contigs)
    sink = _IndelSink(cfg, state, ordered_chunks, manifest, metrics,
                      progress) if want_indels else None
    todo_by_contig = {}
    for idx in (sink.todo if sink else []):
        todo_by_contig.setdefault(ordered_chunks[idx]["chrom"], []).append(idx)

    snp_reader = VcfReader(snp_vcf) if os.path.exists(snp_vcf) else None
    init_args = (cfg.bam, cfg.ref, cfg_kwargs_for_workers(cfg), exclude_path)
    fut_meta = {}
    pend = set()
    ex = worker_pool(cfg.cpu, init_args)
    try:
        def submit(fn, arg, kind):
            f = ex.submit(fn, arg)
            fut_meta[f] = kind
            pend.add(f)

        def unlock_indels(contig, tags_path):
            todo = todo_by_contig.pop(contig, [])
            if not todo:
                return
            timeline.append({"stage": "indels_unlocked", "contig": contig,
                             "n_chunks": len(todo), "t": stamp()})
            for g in group_adjacent_chunks(ordered_chunks, todo,
                                           _INDEL_GROUP_SPAN):
                members = []
                for idx, chunk in g:
                    chunk = dict(chunk)
                    if tags_path and chunk.get("ploidy") != "haploid":
                        chunk["tags_path"] = tags_path
                    members.append((idx, chunk))
                submit(indel_features_group_worker, (members[0][0], members),
                       "indel_group")

        # trellis threads per phasing task: the diploid contigs phase
        # side by side in the pool, so each takes a share of the cores
        n_phase = sum(1 for (_c, _s, _e, p) in contigs.values()
                      if p != "haploid") or 1
        phase_threads = max(2, cfg.cpu // min(n_phase, max(cfg.cpu, 1)))
        for name, (_c, s, e, ploidy) in contigs.items():
            out_vcf = os.path.join(phase_dir, "%s.snps.phased.vcf.gz" % name)
            if snp_reader is None:
                unlock_indels(name, None)
                continue
            if ploidy == "haploid":
                # no phasing for haploid contigs (indelCaller.py:193-211)
                with VcfWriter(out_vcf, snp_reader.header_lines) as w:
                    for r in snp_reader.fetch(name, s, e):
                        w.write(r)
                phased_by_contig[name] = [out_vcf]
                unlock_indels(name, None)
                continue
            job = dict(
                chrom=name, start=s, end=e, snp_vcf=snp_vcf, out_vcf=out_vcf,
                lowq_vcf=os.path.join(
                    phase_dir, "%s.snps.lowq.unphased.vcf.gz" % name),
                tags_path=os.path.join(phase_dir, "%s.tags.tsv" % name),
                phase_threads=phase_threads)
            submit(phase_contig_worker, (0, job), "phase")

        while pend:
            done, _ = wait(pend, return_when=FIRST_COMPLETED)
            for f in done:
                pend.discard(f)
                kind = fut_meta.pop(f)
                try:
                    res = f.result()
                except BrokenProcessPool:
                    raise RuntimeError(
                        "phase/indel worker died (killed/OOM?) — completed "
                        "chunks are in the run manifest, rerun with "
                        "--resume")
                if res[-1]:
                    bam.note_python_windows(res[-1])
                if kind == "phase":
                    info = res[1]
                    name = info["chrom"]
                    phased_by_contig[name] = info["files"]
                    metrics.timers["phasing"] += info["seconds"]
                    metrics.timers["phase.decode"] += info["decode_s"]
                    metrics.timers["phase.mec"] += info["mec_s"]
                    timeline.append({"stage": "phase_done", "contig": name,
                                     "t": stamp()})
                    if not cfg.skip_phased_bam:
                        _c, s, e, _p = contigs[name]
                        artifacts.append(_start_artifact_writer(
                            cfg, name, max(0, s - 1), e,
                            load_tags(info["tags_path"]),
                            _phased_path(phase_dir, name, bam.format)))
                    unlock_indels(name, info["tags_path"])
                else:
                    gi, members, secs = res[0], res[1], res[2]
                    metrics.timers["indel.features_core"] += secs
                    if len(timeline) < 2000:
                        timeline.append(
                            {"stage": "indel_group_done",
                             "contig": ordered_chunks[gi]["chrom"],
                             "n_chunks": len(members), "t": stamp()})
                    for idx, rec in members:
                        sink.add_record(idx, rec)
    finally:
        # device or consumer errors must not wait out the queued backlog
        ex.shutdown(wait=True, cancel_futures=True)

    metrics.extra["stage_timeline"] = timeline
    phased_files = []
    for name in contigs:
        phased_files.extend(phased_by_contig.get(name, []))
    chunk_lines = None
    if want_indels:
        chunk_lines = sink.chunk_lines()
        metrics.count("indel_chunks", len(ordered_chunks))
    return {"phased_files": phased_files, "chunk_lines": chunk_lines}
