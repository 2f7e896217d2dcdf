"""Multi-process orchestration: torch.distributed (Gloo) + region sharding.

The counterpart of nanocaller_tpu/runtime/distributed.py. Scale-out
model: the model weights are replicated (they are ~110k params); the
regions are assigned round-robin by process index (each process's
feature workers and card handle its share), each process writes its
VCF shards on its own, and process 0 k-way merges them — the
reference's shard-files-then-merge contract (snpCaller.py:278-285),
with no data crossing processes. Collectives carry only control data:
the per-stage call counts are all-reduced, after a barrier, before
process 0 merges.

The process group is Gloo's, on the host, by design: what crosses
processes is about 20 run counters and a barrier, never a tensor of the
card. Gloo also lets several processes share one card, which NCCL
refuses (one rank a device). NCCL comes with the sharded train step,
where gradients on the device cross cards (ROADMAP A7).

With `--coordinator host:port --num_processes N --process_id i` a single
command per process runs its region shard AND, on process 0, writes the
merged final VCFs — no separate --merge_shards invocation.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .device import resolve_device

# shards finish hours apart on whole-genome runs: every collective of
# the group waits this long for the stragglers
_TIMEOUT = datetime.timedelta(hours=24)


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the Gloo process group (env-var fallback, idempotent).

    Returns (rank, world_size); (0, 1) for a single process. The
    coordinator is process 0's `host:port` (NANOCALLER_COORDINATOR,
    default localhost:12321); NANOCALLER_NUM_PROCESSES and
    NANOCALLER_PROCESS_ID stand in for the missing arguments. A failed
    init raises: no process carries on alone."""
    if num_processes is None:
        num_processes = int(os.environ.get("NANOCALLER_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return 0, 1
    if not dist.is_initialized():
        coordinator = coordinator_address or os.environ.get(
            "NANOCALLER_COORDINATOR", "localhost:12321")
        rank = process_id if process_id is not None else int(
            os.environ.get("NANOCALLER_PROCESS_ID", "0"))
        dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                                rank=rank, world_size=num_processes,
                                timeout=_TIMEOUT)
        # Establish the cross-process connections NOW, while all
        # processes are still aligned at startup: if the first
        # collective were the end-of-run reduction, a process that
        # finishes its region shard early (an empty shard) would wait
        # out its connect handshake against the stragglers.
        allreduce_counts({"_init": 1})
    return dist.get_rank(), dist.get_world_size()


def process_device(device, rank):
    """The device of process `rank`: a bare "cuda" becomes cuda:(rank mod
    the visible cards) and is made the current card before any state is
    built; an explicit "cuda:k" is kept as given; the CPU stays. Returns
    it as a string (Config.device). "cuda" without a GPU raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return str(dev)


def allreduce_counts(counts: dict) -> dict:
    """Sum small per-process counters over the process group.

    The processes first gather each other's keys (an empty shard counts
    nothing); then a float64 host tensor of the values under the sorted
    union of keys (0 where a process lacks one) is all-reduced (SUM). A
    sum that is an integer comes back as int. Single process: counts
    unchanged."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(counts)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, sorted(counts))
    keys = sorted(set().union(*every))
    vals = torch.tensor([float(counts.get(k, 0)) for k in keys] or [0.0],
                        dtype=torch.float64)
    dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    return {k: int(v) if float(v).is_integer() else float(v)
            for k, v in zip(keys, vals.tolist())}


def barrier():
    """Block until every process reaches this point, however late (the
    group's 24 h timeout: region shards finish hours apart)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown():
    """Leave the process group (run() calls it at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_chunks(chunks, process_id, process_count):
    """Deterministic round-robin chunk assignment for this host."""
    return [c for i, c in enumerate(chunks) if i % process_count == process_id]


def shard_regions(regions, process_id, process_count, min_piece=200_000):
    """Region shard for this host: round-robin over (contig, start, end,
    ploidy) regions; when there are fewer regions than processes (e.g. a
    single-contig genome) the regions are first split into length-
    proportional sub-regions so every host gets work. Mid-contig splits
    make phase sets local to each shard (PS values stay valid — they
    anchor to each block's first het site)."""
    regions = [tuple(r) for r in regions]
    if 0 < len(regions) < process_count:
        total = sum(e - s + 1 for _, s, e, _ in regions)
        pieces = []
        for c, s, e, pl in regions:
            ln = e - s + 1
            k = max(1, round(process_count * ln / max(total, 1)))
            k = min(k, max(1, ln // min_piece))
            step = (ln + k - 1) // k
            for off in range(0, ln, step):
                pieces.append((c, s + off, min(e, s + off + step - 1), pl))
        regions = pieces
    return [r for i, r in enumerate(regions) if i % process_count == process_id]


def host_shard_path(out_dir, prefix, stage, process_id):
    return os.path.join(out_dir, "%s.%s.host%03d.vcf.gz"
                        % (prefix, stage, process_id))


def merge_host_shards(paths, dst_path):
    """Process-0 k-way merge of per-host sorted shards."""
    from ..io.vcf import concat

    existing = [p for p in paths if os.path.exists(p)]
    return concat(existing, dst_path)


def merge_host_outputs(output_dir, prefix, num_shards):
    """Merge per-host suffix-tagged run outputs (written by runs with
    num_shards > 1) into the standard single-run file set. Returns the
    merged paths dict."""
    merged = {}
    for kind, suffix in (("snps", "snps.vcf.gz"),
                         ("unfiltered_snps", "unfiltered.snps.vcf.gz"),
                         ("phased_snps", "snps.phased.vcf.gz"),
                         ("indels", "indels.vcf.gz"),
                         ("final", "vcf.gz")):
        shard_paths = [
            os.path.join(output_dir, "%s.host%03d.%s" % (prefix, i, suffix))
            for i in range(num_shards)]
        existing = [p for p in shard_paths if os.path.exists(p)]
        if existing:
            dst = os.path.join(output_dir, "%s.%s" % (prefix, suffix))
            merged[kind] = merge_host_shards(existing, dst)
    return merged
