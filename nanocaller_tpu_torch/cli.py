"""Command-line interface of the port: `python -m nanocaller_tpu_torch.cli`
(console script `nanocaller-tpu-torch`).

The JAX CLI's flags (nanocaller_tpu/cli.py, argument-compatible with the
reference `NanoCaller` script, NanoCaller:84-158, including preset
semantics, NanoCaller:162-171) plus `--device cuda|cpu`. With
`--watchdog SECONDS` this process only supervises a child copy of the
CLI (runtime/watchdog.py) and loads neither torch nor CUDA.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

from .config import PRESETS, Config, apply_preset


def build_parser():
    p = argparse.ArgumentParser(
        prog="nanocaller-tpu-torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    req = p.add_argument_group("Required Arguments")
    preset = p.add_argument_group("Preset")
    cfgg = p.add_argument_group("Configurations")
    region = p.add_argument_group("Variant Calling Regions")
    snp = p.add_argument_group("SNP Calling")
    indel = p.add_argument_group("Indel Calling")
    out = p.add_argument_group("Output Options")
    phase = p.add_argument_group("Phasing")

    cfgg.add_argument("--mode", default="all", choices=["snps", "indels", "all"])
    cfgg.add_argument("--sequencing", "--seq", dest="sequencing", default="ont",
                      choices=["short_ont", "ont", "ul_ont", "ul_ont_extreme", "pacbio"])
    cfgg.add_argument("--cpu", type=int, default=1)
    cfgg.add_argument("--mincov", type=int, default=4)
    cfgg.add_argument("--maxcov", type=int, default=160)
    cfgg.add_argument("--suppress_progress_bar", action="store_true")
    cfgg.add_argument("--haploid_genome", action="store_true")
    cfgg.add_argument("--haploid_X", action="store_true")
    cfgg.add_argument("--verbose", action="store_true")
    cfgg.add_argument("--resume", action="store_true",
                      help="Reuse completed chunks from a previous "
                           "interrupted run (chunk-level manifest).")
    cfgg.add_argument("--num_shards", type=int, default=1,
                      help="Region-shard the run across N hosts; this "
                           "process handles shard --shard_index and writes "
                           "host-suffixed outputs (merge with "
                           "--merge_shards).")
    cfgg.add_argument("--shard_index", type=int, default=0)
    cfgg.add_argument("--merge_shards", action="store_true",
                      help="Instead of calling, merge existing host-shard "
                           "outputs for --prefix/--num_shards in --output.")
    cfgg.add_argument("--coordinator", type=str, default="",
                      help="host:port of process 0 for the Gloo process "
                           "group. With --num_processes/--process_id, one "
                           "command per process runs its region shard on "
                           "its own card and process 0 merges the "
                           "outputs.")
    cfgg.add_argument("--num_processes", type=int, default=1)
    cfgg.add_argument("--process_id", type=int, default=0)
    cfgg.add_argument("--watchdog", type=int, default=0, metavar="SECONDS",
                      help="stall supervision: run the CLI in a child "
                           "process, kill it when it makes no progress "
                           "for SECONDS (a hung kernel, a dead Gloo "
                           "peer) and relaunch it with --resume. Choose "
                           "SECONDS above the start-up and a cold "
                           "kernel build; 0 disables.")
    cfgg.add_argument("--no_dedup_transfer", action="store_true",
                      help="the dense per-candidate SNP oracle path of "
                           "the JAX CLI (kernel K5)")
    cfgg.add_argument("--no_snp_group_payload", action="store_true",
                      help="one SNP payload per 500 kb member instead of "
                           "one per decode group")
    cfgg.add_argument("--snp_pipeline_depth", type=int, default=1,
                      help="dispatched-but-unsynced SNP inference units "
                           "riding the device queue (deeper hides "
                           "device-to-host latency spikes behind compute; "
                           "output is order-invariant)")
    cfgg.add_argument("--profile", action="store_true",
                      help="capture a torch.profiler trace of the SNP "
                           "stage into OUTPUT/trace/trace.json (Chrome "
                           "trace format)")
    cfgg.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="torch device of the port (the counterpart of "
                           "the JAX CLI's JAX_PLATFORMS); cuda without a "
                           "GPU raises.")

    out.add_argument("--output", "-o", type=str)
    out.add_argument("--prefix", default="variant_calls")
    out.add_argument("--sample", default="SAMPLE")

    region.add_argument("--regions", nargs="*")
    region.add_argument("--bed", type=str)
    region.add_argument("--wgs_contigs", choices=["chr1-22XY", "1-22XY"])
    region.add_argument("--exclude_bed", type=str)

    preset.add_argument("--preset", "-p", choices=list(PRESETS))

    req.add_argument("--bam", required=True)
    req.add_argument("--ref", required=True)

    snp.add_argument("--snp_model", default="ONT-HG002")
    snp.add_argument("--min_allele_freq", type=float, default=0.15)
    snp.add_argument("--min_nbr_sites", type=int, default=1)
    snp.add_argument("--neighbor_threshold", "--nbr_t", dest="neighbor_threshold",
                     default="0.4,0.6")
    snp.add_argument("--supplementary", "--sup", dest="supplementary",
                     action="store_true")
    snp.add_argument("--disable_coverage_normalization", action="store_true")

    indel.add_argument("--indel_model", default="ONT-HG002")
    indel.add_argument("--ins_threshold", "--ins_t", dest="ins_threshold",
                       type=float, default=0.4)
    indel.add_argument("--del_threshold", "--del_t", dest="del_threshold",
                       type=float, default=0.6)
    indel.add_argument("--win_size", type=int, default=40)
    indel.add_argument("--small_win_size", type=int, default=4)
    indel.add_argument("--impute_indel_phase", action="store_true")

    phase.add_argument("--phase", action="store_true")
    phase.add_argument("--phase_qual_score", type=float, default=10.0)
    phase.add_argument("--phase_cell_budget", type=int, default=600_000_000,
                       help="exact-wMEC trellis cell budget; bigger "
                            "keeps the whatshap cap-15 selection on "
                            "larger phase blocks at linear DP cost")
    phase.add_argument("--enable_whatshap", action="store_true")
    phase.add_argument("--skip_phased_bam", action="store_true",
                       help="do not write the per-contig haplotagged "
                            "BAM/CRAM artifact (nothing downstream reads "
                            "it; phase→indel handoff is in-memory)")
    phase.add_argument("--phased_bam_compression", type=int, default=1,
                       choices=range(1, 10), metavar="[1-9]",
                       help="deflate level of the haplotagged BAM "
                            "artifact (1 = fastest, 6 = samtools default "
                            "size; CRAM artifacts use the CRAM codecs and "
                            "ignore this)")
    return p


def config_from_args(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    args.supplementary = False  # force-disabled (NanoCaller:160)

    explicitly_set = set()
    for tok in argv:
        if tok.startswith("--"):
            explicitly_set.add(tok.lstrip("-").split("=")[0])
    # short-flag aliases map to their canonical names (NanoCaller:79-80)
    alias = {"seq": "sequencing", "p": "preset", "o": "output",
             "sup": "supplementary", "nbr_t": "neighbor_threshold",
             "ins_t": "ins_threshold", "del_t": "del_threshold"}
    explicitly_set = {alias.get(f, f) for f in explicitly_set}

    cfg = Config(
        bam=args.bam, ref=args.ref, mode=args.mode, sequencing=args.sequencing,
        cpu=args.cpu, mincov=args.mincov, maxcov=args.maxcov,
        haploid_genome=args.haploid_genome, haploid_X=args.haploid_X,
        supplementary=False, output=args.output or ".", prefix=args.prefix,
        sample=args.sample, regions=args.regions, bed=args.bed,
        wgs_contigs=args.wgs_contigs, exclude_bed=args.exclude_bed,
        snp_model=args.snp_model, min_allele_freq=args.min_allele_freq,
        min_nbr_sites=args.min_nbr_sites,
        neighbor_threshold=args.neighbor_threshold,
        disable_coverage_normalization=args.disable_coverage_normalization,
        indel_model=args.indel_model, ins_threshold=args.ins_threshold,
        del_threshold=args.del_threshold, win_size=args.win_size,
        small_win_size=args.small_win_size,
        impute_indel_phase=args.impute_indel_phase, phase=args.phase,
        phase_qual_score=args.phase_qual_score,
        phase_cell_budget=args.phase_cell_budget,
        enable_whatshap=args.enable_whatshap,
        suppress_progress=args.suppress_progress_bar, verbose=args.verbose,
        resume=args.resume, num_shards=args.num_shards,
        shard_index=args.shard_index, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        profile=args.profile, skip_phased_bam=args.skip_phased_bam,
        dedup_transfer=not args.no_dedup_transfer,
        snp_group_payload=not args.no_snp_group_payload,
        snp_pipeline_depth=args.snp_pipeline_depth,
        watchdog=args.watchdog,
        phased_bam_compression=args.phased_bam_compression,
        device=args.device)
    cfg._merge_shards = args.merge_shards
    if args.preset:
        apply_preset(cfg, args.preset, explicitly_set)
    return cfg


def main(argv=None):
    t0 = time.time()
    cfg = config_from_args(argv)
    if cfg.watchdog > 0 and not os.environ.get("NC_TPU_WATCHDOG_CHILD"):
        # stall supervision: re-exec self as a monitored child; a hung
        # kernel cannot be interrupted in-process (runtime/watchdog). This
        # process loads no torch, so it never holds a CUDA context
        from .runtime.watchdog import wrap_cli

        rc = wrap_cli(list(sys.argv[1:] if argv is None else argv),
                      cfg.watchdog, cfg.output)
        if rc != 0:
            raise SystemExit(rc)
        paths = {
            "snps": "%s.snps.vcf.gz",
            "phased_snps": "%s.snps.phased.vcf.gz",
            "indels": "%s.indels.vcf.gz",
            "final": "%s.vcf.gz",
        }
        return {k: p for k, p in
                ((k, os.path.join(cfg.output, pat % cfg.prefix))
                 for k, pat in paths.items())
                if os.path.exists(p)}
    print("%s: Starting nanocaller-tpu-torch." % datetime.datetime.now(),
          flush=True)
    if cfg._merge_shards:
        from .runtime.distributed import merge_host_outputs

        outputs = merge_host_outputs(cfg.output or ".", cfg.prefix,
                                     cfg.num_shards)
        print("merged shards:", outputs, flush=True)
        return outputs
    if cfg.num_processes > 1:
        from .runtime.distributed import initialize

        initialize(cfg.coordinator or None, cfg.num_processes,
                   cfg.process_id)
    from .caller import run

    outputs = run(cfg)
    print("%s: Total Time Elapsed: %.2f seconds"
          % (datetime.datetime.now(), time.time() - t0), flush=True)
    return outputs


if __name__ == "__main__":
    main()
