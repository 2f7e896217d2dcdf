"""The device's trace of a window, reduced to what the per-layer readers
and the result line take.

`profiled(fn)` runs fn() under torch.profiler (CPU and CUDA activities),
writes the Chrome trace to a temporary file under TMPDIR, reads it back
and deletes it. The window is the span "bench.window" that fn opens with
`span`; in it:
- busy_s: the union of the device's kernel, memcpy and memset intervals;
- kernels: {name: [launches, seconds]} of the device's operations;
- copies_s: host-to-device and device-to-host copies;
- device_ops: the ten device operations that took most time;
- idle_gaps: the ten longest stretches with nothing on the device, each
  named by the innermost of the benchmark's host spans open at its
  midpoint ("host" where none is);
- spans: {name: [count, seconds]} of the benchmark's host spans.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name):
    """A host span that the trace records (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


def profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return result, reduce_events(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, window_name="bench.window"):
    """Chrome trace events (ts and dur in microseconds) → the summary
    above, or None where the trace holds no window span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window_name
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in xs:
        a, d = float(e["ts"]), float(e["dur"])
        if a + d < w0 or a > w1:
            continue
        if e.get("cat") in _DEVICE_CATS:
            dev.append((max(a, w0), min(a + d, w1), e["name"], e["cat"]))
        elif e.get("cat") == "user_annotation" and e["name"] != window_name:
            host.append((a, a + d, e["name"]))
    kernels = {}
    copies = 0.0
    for a, b, name, cat in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
        if cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
            copies += (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _n, _c in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort(key=lambda h: (h[0], -(h[1] - h[0])))

    def label(t):
        best = None
        for a, b, name in host:
            if a > t:
                break
            if b >= t and (best is None or b - a <= best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "host"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    spans = {}
    for a, b, name in host:
        s = spans.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels, "copies_s": copies, "spans": spans,
            "device_ops": [[n, v[1]] for n, v in top[:10]],
            "idle_gaps": [[label((a + b) / 2), (b - a) * 1e-6]
                          for a, b in gaps[:10]]}


def kernel_seconds(summary, fragment):
    """(launches, seconds) of the device operations whose name holds
    `fragment`."""
    n = s = 0
    for name, (k, sec) in summary["kernels"].items():
        if fragment in name:
            n += k
            s += sec
    return n, s
