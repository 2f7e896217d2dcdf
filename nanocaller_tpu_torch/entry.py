"""Entry points of the port: the flagship forward and the multi-device dry
run (the counterpart of the JAX package's __graft_entry__.py).

    python -m nanocaller_tpu_torch.entry [--device cuda|cpu]

runs entry()'s forward once, then dryrun_multichip over every visible
card (or one CPU process).
"""

import numpy as np

# realistic per-chunk statistics for the flagship forward (an ONT ~2 Mb
# chunk at ~48×): S union sites ≈ 1.5 × candidates, reads span a sliding
# band of sites, read depth ~48 per site
_COV = 48
_N_READS = 4800


def _example_batch(B=1024, cov=_COV, seed=0, exc_rate=0.08,
                   minor_rate=0.25):
    """A chunk's observation payload (pileup.snp_features.SnpChunkFeatures,
    the interval + top-2-bitmask + exception encoding) for B candidates:
    the logical half of the JAX package's example, with the same draws
    from the same seed in the same order and the same statistics — reads
    cover a sliding band of `cov` ascending ids per site; ~25% of the
    covered cells carry the site's top-2 code (the span bitmask's set
    bits) and ~8% are explicit exceptions; no holes. Where JAX pads the
    arrays to its shape buckets and packs them into uint16 tunnel
    arrays, the port keeps them at their own sizes, for K3's chunk wire
    (pileup.snp_pileup.chunk_wire). Every row's depth is `cov`, which
    is also the ONT-HG002 pack's training coverage, so the coverage
    scale is 1 (the JAX example's norm)."""
    from .pileup.snp_features import SnpChunkFeatures

    rng = np.random.default_rng(seed)
    S = B * 3 // 2
    E = S * cov
    n_reads = _N_READS

    # reads cover a sliding band of `cov` ascending ids per site
    row_start = (np.arange(S, dtype=np.int64) * (n_reads - cov)) // max(S - 1, 1)
    rid = (row_start[:, None] + np.arange(cov)[None, :]).reshape(-1)
    obs_site = np.repeat(np.arange(S, dtype=np.int64), cov)
    read_lo = np.full(n_reads, np.iinfo(np.int32).max, np.int32)
    read_hi = np.zeros(n_reads, np.int32)
    np.minimum.at(read_lo, rid, obs_site.astype(np.int32))
    np.maximum.at(read_hi, rid, obs_site.astype(np.int32))
    cnt = np.bincount(rid, minlength=n_reads)
    read_lo[cnt == 0] = 1
    read_hi[cnt == 0] = 0

    site_ref = rng.integers(0, 4, S).astype(np.int8)

    exc = rng.random(E) < exc_rate
    exc_site = obs_site[exc]
    exc_rid = rid[exc]
    exc_code = (site_ref[exc_site] + 1 + rng.integers(0, 4, exc.sum())) % 5
    exc_packed = ((exc_rid.astype(np.int64) << 3)
                  | exc_code.astype(np.int64)).astype(np.uint32)
    exc_indptr = np.searchsorted(exc_site, np.arange(S + 1)).astype(np.int32)

    # site positions ~170 bp apart (ONT het+noise density over ~2 Mb);
    # every union site is neighbour-eligible, the selection runs on the
    # device from the band schedules
    positions = (np.arange(S, dtype=np.int32) * 170
                 + rng.integers(0, 100, S).astype(np.int32))
    cand_site = np.sort(rng.choice(S, size=B, replace=False)).astype(np.int32)
    site_major = site_ref.copy()  # the example's top-1 = ref
    site_minor = ((site_ref + 1) % 4).astype(np.int8)
    # span bitmask: spans are contiguous (no holes), total bits = E
    minor_bits = np.packbits(rng.random(E) < minor_rate, bitorder="little")
    zeros4 = np.zeros((B, 4), np.int32)
    return SnpChunkFeatures(
        contig="chr_example", read_lo=read_lo, read_hi=read_hi,
        exc_packed=exc_packed, exc_indptr=exc_indptr,
        hole_site=np.zeros(0, np.int32), hole_rid=np.zeros(0, np.int32),
        site_ref=site_ref, site_major=site_major, site_minor=site_minor,
        minor_bits=minor_bits, n_reads=n_reads, cand_site=cand_site,
        cand_pos32=positions[cand_site], nbr_pos=positions,
        nbr_union=np.arange(S, dtype=np.int32), seq_type="ont",
        deep_idx=np.zeros(0, np.int64),
        deep_rids=np.zeros((0, 160), np.int32),
        pos=positions[cand_site].astype(np.int64),
        center_ref=site_ref[cand_site], dp=np.full(B, cov, np.int32),
        freq=np.zeros(B, np.float32), fwd_dp=zeros4, rev_dp=zeros4.copy(),
        sampled_depth=np.full(B, cov, np.int32),
        nbr_counts=np.full(B, 1, np.int32), maxcov=160)


def entry(device="cuda", B=1024):
    """Returns (fn, args) for the flagship forward: fn(*args) runs K3
    (neighbour selection, the cells' codes from the interval + exception
    wire, the pileup) on the chunk's wire and the diploid SNP CNN
    (ONT-HG002) through snp_caller.infer_snp_chunk, and returns the
    (B, 4) probabilities. "cuda" without a GPU raises."""
    from .config import Config
    from .snp_caller import SnpCallerState, infer_snp_chunk

    state = SnpCallerState.create("ONT-HG002", device=device, devices=None)
    cfg = Config(batch_size=B)
    feats = _example_batch(B=B)

    def fn(feats):
        return infer_snp_chunk(state, feats, cfg, "diploid")

    return fn, (feats,)


def dryrun_multichip(n_devices, device="cuda"):
    """Over n_devices ranks or replicas: (1) one SNP training step,
    batch data-parallel and the dense layers tensor-parallel
    (runtime.sharding.shard_train_step_demo: one process a card on NCCL,
    or a CPU process a rank on Gloo); (2) the SNP inference with
    candidate rows split over the dp replicas and replicated weights
    (shard_inference_demo); (3) the real `--mode all --cpu 2` pipeline
    on a two-contig simulated BAM over every visible card and again on
    one, byte-identical (_dryrun_real_pipeline). Small shapes
    throughout. Raises where a step fails; returns the pipeline's counts
    of PASS SNP, indel and final records."""
    import torch

    from .runtime.device import resolve_device
    from .runtime.sharding import (make_mesh, shard_inference_demo,
                                   shard_train_step_demo)

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError("need %d devices, have %d"
                           % (n_devices, torch.cuda.device_count()))
    mesh = make_mesh(n_devices)
    shard_train_step_demo(n_devices, device=device)
    shard_inference_demo(mesh, device=device)
    return _dryrun_real_pipeline(device=device)


def _dryrun_real_pipeline(device="cuda"):
    """Run the `--mode all --cpu 2` pipeline over every visible card
    (SnpCallerState / IndelCallerState split the CNN batches over them),
    and again on one card (sharding.inference_devices suppressed); the
    VCFs must be byte-identical. With one card (or on the CPU) the
    second run is skipped, as in the JAX package. Two contigs: the DAG
    phases them in parallel workers and unlocks each contig's indel
    chunks on its own."""
    import gzip
    import pathlib
    import tempfile

    from .cli import main
    from .io.fasta import write_fasta
    from .io.vcf import VcfReader
    from .runtime import sharding
    from .sim import make_diploid_readset, random_seq, write_bam_multi

    devices = sharding.inference_devices(device)
    multi = devices is not None
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        rng = np.random.default_rng(5)
        L = 9000
        refs, reads_by, lens = {}, {}, {}
        for name in ("chr_t", "chr_u"):
            ref_seq = random_seq(rng, L)
            snps = [(p, "ACGT"[("ACGT".index(ref_seq[p]) + 1) % 4],
                     "het1" if i % 2 == 0 else "het2")
                    for i, p in enumerate(range(600, L - 600, 400))]
            indels = [(3300, "del", 5, "het1"), (7200, "ins", "GGTT", "hom")]
            refs[name] = ref_seq
            lens[name] = L
            reads_by[name] = make_diploid_readset(
                rng, ref_seq, snps=snps, indels=indels, depth=38,
                read_len=1300, error_rate=0.02)
        fasta_p = str(tmp / "ref.fa")
        write_fasta(fasta_p, refs)
        bam_p = str(tmp / "reads.bam")
        write_bam_multi(bam_p, reads_by, lens)
        argv = [
            "--bam", bam_p, "--ref", fasta_p, "--mode", "all",
            "--prefix", "dry", "--sample", "S", "--phase_qual_score", "4",
            "--suppress_progress_bar", "--cpu", "2", "--device", device]
        outputs = main(argv + ["--output", str(tmp / "out_mesh")])
        n_pass = sum(1 for _ in VcfReader(outputs["snps"]))
        n_indel = sum(1 for _ in VcfReader(outputs["indels"]))
        n_final = sum(1 for _ in VcfReader(outputs["final"]))
        if n_pass == 0 or n_indel == 0 or n_final == 0:
            raise RuntimeError(
                "multi-device dryrun missing calls: snps=%d indels=%d "
                "final=%d" % (n_pass, n_indel, n_final))
        if not multi:
            return {"snps": n_pass, "indels": n_indel, "final": n_final}
        orig = sharding.inference_devices
        sharding.inference_devices = lambda device="cuda": None
        try:
            outputs1 = main(argv + ["--output", str(tmp / "out_one")])
        finally:
            sharding.inference_devices = orig
        for key in ("snps", "phased_snps", "indels", "final"):
            if gzip.open(outputs[key]).read() != \
                    gzip.open(outputs1[key]).read():
                raise RuntimeError(
                    "%s differs between 1-device and %d-device runs"
                    % (key, len(devices)))
        return {"snps": n_pass, "indels": n_indel, "final": n_final}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fn_args = entry(device=args.device)
    out = fn(*fn_args)
    print("entry forward:", np.asarray(out).shape, flush=True)
    n = torch.cuda.device_count() if args.device == "cuda" else 1
    dryrun_multichip(n, device=args.device)
    print("dryrun_multichip ok", flush=True)


if __name__ == "__main__":
    main()
