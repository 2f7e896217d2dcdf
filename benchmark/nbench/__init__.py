"""The benchmark harness of nanocaller_tpu_torch (see benchmark/README.md).

Everything here is the yardstick: the traffic generators, the plain
references, the operation and byte counts, the table of peaks and the
reduction of the profiler's trace. It imports torch, numpy and the
standard library; the port is imported only by the kinds of work
(benchmark/kinds/), and never the JAX package.
"""
