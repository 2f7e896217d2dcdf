"""What every kind of work shares. A traffic file's `kind` names a
module benchmark/kinds/<kind>.py whose class `Kind` drives one device
path of nanocaller_tpu_torch as its device owner does, from inputs drawn
from the seed: it sets up the inputs (`inputs`) and the port's state,
`enqueue(k)` sends input k through the port's entry, `finish(k, handle)`
collects its outputs and counts its units, and `reference_probs(k,
tf32)` computes them again with the plain reference.

`window(seconds)` sends work until the deadline and then drains what is
in flight, one input ahead of its collection; its rate is every unit
over the whole window. It keeps the outputs of one occurrence of each
distinct input, chosen from the seed, for the check, which runs once the
window has closed and the port's state is freed.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from . import reference
from .trace import span

CONTIG = "bench"


class Stream:
    """The base of every kind: a subclass sets `inputs` (and its own
    state) before calling this."""

    def __init__(self, cfg, traffic, seed, device, root):
        self.cfg, self.traffic, self.device, self.root = \
            cfg, traffic, torch.device(device), root
        rng = np.random.default_rng([seed, 7])
        n = len(self.inputs)
        self.order = rng.permutation(n)
        self.pick = rng.integers(0, 3, n)  # the occurrence each input keeps
        self.kept = {}
        self.seen = np.zeros(n, np.int64)

    def _keep(self, k, out):
        if self.seen[k] <= self.pick[k]:
            self.kept[k] = out
        self.seen[k] += 1

    def window(self, seconds, traced=False):
        """Send work for `seconds`, drain it; → {units, window_s, sent
        (input indices in order), host_s (each call's host seconds)}. A
        traced window records spans for the profiler and keeps nothing."""
        sp = span if traced else (lambda _name: nullcontext())
        sent, host_s = [], []
        units = 0
        with sp("bench.window"):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            pending = None
            while time.perf_counter() < deadline:
                k = int(self.order[i % len(self.order)])
                i += 1
                a = time.perf_counter()
                with sp(self.enqueue_span):
                    fin = self.enqueue(k)
                host_s.append(time.perf_counter() - a)
                sent.append(k)
                if pending is not None:
                    with sp(self.finish_span):
                        units += self.finish(*pending, keep=not traced)
                pending = (k, fin)
            if pending is not None:
                with sp(self.finish_span):
                    units += self.finish(*pending, keep=not traced)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
        return {"units": units, "window_s": t1 - t0, "sent": sent,
                "host_s": host_s}

    def warm(self):
        """Every input once through the timed path (every shape the window
        uses), nothing kept."""
        for k in range(len(self.inputs)):
            self.finish(k, self.enqueue(k), keep=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self):
        self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def load_pack(root, rel):
    """A weight pack by its path from the checkout's root."""
    return reference.load_pack(os.path.join(root, rel))


def max_gap(a_list, b_list):
    """The widest gap between two lists of probability arrays."""
    gap = 0.0
    for a, b in zip(a_list, b_list):
        if len(a):
            gap = max(gap, float(np.abs(np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)).max()))
    return gap
