"""nanocaller_tpu_torch: the PyTorch/CUDA port of nanocaller_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch, numpy and the standard library, never jax, flax or
nanocaller_tpu. Entry points run on "cuda" unless the caller passes
device="cpu". It runs `--mode snps|indels|all` at `--cpu 1` and
`--cpu N` end to end, with the NW traceback DP, its walk and the SNP
group pileup as hand-written CUDA kernels (csrc/). Under `--cpu N` the
host work runs in feature workers that never import torch
(runtime/workers.py); the device has one owner, the main process.
It trains both models (train/, with the training CLIs
`python -m nanocaller_tpu_torch.train.train_snp|train_indel`), runs the
SNP train step sharded over processes (runtime/sharding.py) and has the
JAX package's entry/dryrun module (entry.py) and user tools
(`python -m nanocaller_tpu_torch.tools.<name>`, tools/).

On the CPU (`--device cpu`) the port aligns with the plain twins of the
NW kernels, which open thousands of short parallel regions of torch's
OpenMP pool a launch. OpenMP's default makes a thread that waits at a
region's barrier spin; when other processes hold the cores, the thread
the barrier waits for is descheduled and the spinning ones hold its core
(on an 8-core host with six busy processes beside it, one (192,192)
launch of K1's twin took 53 s instead of about 1 s). So importing this package sets OMP_WAIT_POLICY to
PASSIVE (waiting threads sleep) unless the environment already sets it.
OpenMP reads it once, when torch loads it: the setting reaches every
`python -m nanocaller_tpu_torch.*` process and the processes they start,
but not a process that imported torch before this package. It changes
no thread count, so no result.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

__version__ = "0.1.0"
