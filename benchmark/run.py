"""The benchmark of nanocaller_tpu_torch on one cell (benchmark/README.md).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port. Prints the check's
numbers beside their limits as the last lines of standard error and one
JSON object as the last line of standard output; exits non-zero, with no
result, without a CUDA device, without the port, or if the JAX package
or JAX was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# compile caches at fixed places inside the checkout (CUDA's JIT cache;
# the port builds its kernels into nanocaller_tpu_torch/_build itself)
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "ext"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
# one host thread for each library that keeps a pool (OpenMP, MKL,
# OpenBLAS, and so torch's intra-op pool): the host side of the timed
# path is numpy and launches, and a pool spread over the machine's shared
# cores only adds noise to the rate
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from nbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
