"""Tracing / metrics: per-stage timing and counters.

Every pipeline stage reports wall time and counters into a run-wide
registry serialized next to the VCFs (metrics.json); a device trace can
be captured around any region with `profile_region`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class Metrics:
    def __init__(self):
        self.timers = defaultdict(float)
        self.counts = defaultdict(int)
        self.extra = {}  # e.g. psum-reduced global counts in multi-host runs

    @contextlib.contextmanager
    def timer(self, name):
        t0 = time.perf_counter()
        try:
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
    (chrome://tracing or Perfetto)."""
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
