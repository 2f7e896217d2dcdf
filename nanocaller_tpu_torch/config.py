"""Typed run configuration + presets.

Mirrors the reference CLI surface (NanoCaller:96-156) and preset
semantics (NanoCaller:66-77,162-171: preset values apply only to flags
the user did not explicitly set). The config serializes into the run
manifest for reproducibility (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass
class Config:
    # required
    bam: str = None
    ref: str = None
    # mode / sequencing
    mode: str = "all"  # snps | indels | all
    sequencing: str = "ont"  # short_ont | ont | ul_ont | ul_ont_extreme | pacbio
    cpu: int = 1
    mincov: int = 4
    maxcov: int = 160
    haploid_genome: bool = False
    haploid_X: bool = False
    supplementary: bool = False  # force-disabled in reference (NanoCaller:160)
    # output
    output: str = None
    prefix: str = "variant_calls"
    sample: str = "SAMPLE"
    # regions
    regions: list = None
    bed: str = None
    wgs_contigs: str = None  # chr1-22XY | 1-22XY
    exclude_bed: str = None
    # snp
    snp_model: str = "ONT-HG002"
    min_allele_freq: float = 0.15
    min_nbr_sites: int = 1
    neighbor_threshold: str = "0.4,0.6"
    disable_coverage_normalization: bool = False
    # indel
    indel_model: str = "ONT-HG002"
    ins_threshold: float = 0.4
    del_threshold: float = 0.6
    win_size: int = 40
    small_win_size: int = 4
    impute_indel_phase: bool = False
    # phasing
    phase: bool = False
    phase_qual_score: float = 10.0
    enable_whatshap: bool = False
    # exact-wMEC trellis cell budget: the active-read cap of a block is
    # lowered until sites × 2^cap fits (phase/wmec._block_cap). The
    # native trellis admits 16× the budget in checkpoint mode, so the
    # default gives whatshap's cap 15 to blocks ≤ 292,968 het sites (the
    # JAX package's bound with its library loaded).
    phase_cell_budget: int = 600_000_000
    # framework extras (not in reference)
    # rows per SNP CNN forward (snp_caller.infer_snp_group); no padding
    batch_size: int = 4096
    # SNP device-path options of the JAX CLI. The port serves the group
    # payload path only: False for either raises NotImplementedError
    # (the per-chunk and dense oracle paths are ROADMAP A2b)
    dedup_transfer: bool = True
    snp_group_payload: bool = True
    # decode groups whose launches are queued before the oldest one's
    # device→host copy and decode (output is order-invariant)
    snp_pipeline_depth: int = 1
    suppress_progress: bool = False
    verbose: bool = False
    skip_phased_bam: bool = False  # skip the per-contig phased BAM artifact
    # deflate level of the phased-BAM artifact (the native retagger's; a
    # regenerable intermediate: level 1 writes fastest, 6 is samtools'
    # default size; a CRAM artifact uses the CRAM codecs)
    phased_bam_compression: int = 1
    resume: bool = False  # reuse completed chunks from a prior run's manifest
    # >0: stall supervision of the JAX CLI (not ported; must stay 0)
    watchdog: int = 0
    # multi-host / multi-process runs (later slice; must stay 1/0)
    num_shards: int = 1
    shard_index: int = 0
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    profile: bool = False  # torch.profiler trace of the SNP stage
    # torch device of the port: "cuda" (default) or "cpu"; "cuda" without
    # a GPU raises (runtime/device.py)
    device: str = "cuda"

    @property
    def threshold(self):
        lo, hi = self.neighbor_threshold.split(",")
        return (float(lo), float(hi))

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=1, default=str)

    def dump(self, path):
        with open(path, "w") as fh:
            fh.write(self.to_json())


# preset values (NanoCaller:66-77)
PRESETS = {
    "ont": dict(sequencing="ont", snp_model="ONT-HG002", indel_model="ONT-HG002",
                neighbor_threshold="0.4,0.6", ins_threshold=0.4, del_threshold=0.6,
                enable_whatshap=False, impute_indel_phase=False),
    "short_ont": dict(sequencing="short_ont", snp_model="ONT-HG002",
                      indel_model="ONT-HG002", neighbor_threshold="0.3,0.7",
                      ins_threshold=0.4, del_threshold=0.6,
                      enable_whatshap=False, impute_indel_phase=False),
    "ul_ont": dict(sequencing="ul_ont", snp_model="ONT-HG002", indel_model="ONT-HG002",
                   neighbor_threshold="0.4,0.6", ins_threshold=0.4, del_threshold=0.6,
                   enable_whatshap=False, impute_indel_phase=False),
    "ul_ont_extreme": dict(sequencing="ul_ont_extreme", snp_model="ONT-HG002",
                           indel_model="ONT-HG002", neighbor_threshold="0.4,0.6",
                           ins_threshold=0.4, del_threshold=0.6,
                           enable_whatshap=False, impute_indel_phase=False),
    "ccs": dict(sequencing="pacbio", snp_model="CCS-HG002", indel_model="CCS-HG002",
                neighbor_threshold="0.3,0.7", ins_threshold=0.4, del_threshold=0.4,
                enable_whatshap=True, impute_indel_phase=True),
    "clr": dict(sequencing="pacbio", snp_model="CLR-HG002", indel_model="ONT-HG002",
                neighbor_threshold="0.3,0.6", ins_threshold=0.6, del_threshold=0.6,
                win_size=10, small_win_size=2, enable_whatshap=True,
                impute_indel_phase=False),
}

EXCLUDE_BED_PRESETS = ("hg38", "hg19", "mm10", "mm39")


def resolve_exclude_bed(value):
    """Map preset names to the bundled centromere/telomere BEDs
    (NanoCaller:21-22). They are data, read by path from the JAX
    package's nanocaller_tpu/data/bed_files/ directory."""
    if value in EXCLUDE_BED_PRESETS:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(repo, "nanocaller_tpu", "data", "bed_files",
                            "%s_centro_telo.bed.gz" % value)
        if not os.path.exists(path):
            raise FileNotFoundError("bundled exclude bed missing: %s" % path)
        return path
    return value


def apply_preset(cfg: Config, preset: str, explicitly_set=()):
    """Apply preset values for fields the user did not explicitly set."""
    for key, val in PRESETS[preset].items():
        if key not in explicitly_set:
            setattr(cfg, key, val)
    return cfg
