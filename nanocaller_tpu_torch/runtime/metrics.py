"""Tracing / metrics: per-stage timing, spans and counters.

- `Metrics`: every pipeline stage reports wall time and counters into a
  run's registry serialized next to the VCFs (metrics.json).
- `span(name, arg)`: a host range recorded in a running torch.profiler
  trace, on the clock of the device's kernels and copies; with no
  profiler running it is a shared null context and costs one flag check.
  Every `Metrics.timer` is such a span too.
- `count` / `counters` / `total` / `reset_counters`: the process's
  counters of the device path (kernel launches, host-to-device copies),
  kept on every device.
- `profile_region`: a torch.profiler Chrome trace around a region.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict

_NULL = contextlib.nullcontext()
_COUNTERS = defaultdict(int)


def span(name, arg=None):
    """A range named `name` while a torch.profiler records, else the
    shared null context. Never loads torch: a process that has not loaded
    it records no trace.

    The range is a user-scope RecordFunction, as
    torch.profiler.record_function opens (a `user_annotation` event of
    the Chrome trace), with `arg`, an int, as its input: a profiler
    started with record_shapes=True writes it under "Concrete Inputs"
    (record_function's own argument, a string, never reaches the
    trace)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _NULL
    return _recorded(torch._C._autograd, name, () if arg is None else (arg,))


@contextlib.contextmanager
def _recorded(autograd, name, args):
    handle = autograd._record_function_with_args_enter(name, *args)
    try:
        yield
    finally:
        autograd._record_function_with_args_exit(handle)


def count(name, k=1):
    """Add k to the process's counter `name`; → its new value."""
    _COUNTERS[name] += k
    return _COUNTERS[name]


def counters(prefix=""):
    """A copy of the process's counters (those whose name starts with
    `prefix`)."""
    return {n: v for n, v in _COUNTERS.items() if n.startswith(prefix)}


def total(prefix):
    """The sum of the counters whose name starts with `prefix`: a
    kernel's launches over its buckets or kinds of wire
    ("k1.launches", "k3.launches"), or its pairs ("k1.pairs")."""
    return sum(v for n, v in _COUNTERS.items() if n.startswith(prefix))


def reset_counters(prefix=None):
    """Drop every counter (prefix None) or those whose name starts with
    `prefix` (a string or a tuple of strings)."""
    if prefix is None:
        _COUNTERS.clear()
        return
    for name in [n for n in _COUNTERS if n.startswith(prefix)]:
        del _COUNTERS[name]


class Metrics:
    def __init__(self):
        self.timers = defaultdict(float)
        self.counts = defaultdict(int)
        self.extra = {}  # e.g. psum-reduced global counts in multi-host runs

    @contextlib.contextmanager
    def timer(self, name):
        """The block's seconds, added to timers[name], and a span of the
        same name."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.timers[name] += time.perf_counter() - t0

    def count(self, name, k=1):
        self.counts[name] += k

    def as_dict(self):
        d = {"timers_s": {k: round(v, 4) for k, v in self.timers.items()},
             "counts": dict(self.counts)}
        d.update(self.extra)
        return d

    def dump(self, path):
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=1)
        return path


@contextlib.contextmanager
def profile_region(log_dir, enabled=True):
    """Capture a torch.profiler trace of the host and (where a GPU is
    present) the device into log_dir/trace.json, a Chrome trace
    (chrome://tracing or Perfetto). It records no input shapes, which
    would slow every op further, so the spans' arguments are not in it."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
