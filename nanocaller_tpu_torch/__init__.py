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
"""

__version__ = "0.1.0"
