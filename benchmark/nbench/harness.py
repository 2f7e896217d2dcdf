"""One run of one cell: set-up, the measured window, the traced window
(--trace 1), the check against the plain reference, the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json,
its configuration's file (its `file` there), its traffic mix in
benchmark/traffic/<traffic>.json, whose `kind` names the class that
drives it in benchmark/kinds/<kind>.py (nbench/stream.py), and each
per-layer metric's reader in benchmark/metrics/<name>.py, a module with
`read(ctx)` that returns a number, or None where the run gave it
nothing to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "nanocaller_tpu")
# the traced window's length: long enough for about a hundred groups,
# short enough for the profiler's trace to stay some tens of MB
TRACE_SECONDS = 3.0


class Spec:
    """BENCHMARK.json and the pieces it names, found by name."""

    def __init__(self, root=ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError("no config %r in BENCHMARK.json" % name)

    def traffic(self, name):
        with open(os.path.join(self.root, "benchmark", "traffic",
                               name + ".json")) as fh:
            return json.load(fh)

    @staticmethod
    def _for(metric, workload):
        return "workloads" not in metric or workload in metric["workloads"]

    def end_to_end(self, workload):
        return [m for m in self.bench["end_to_end"]
                if self._for(m, workload)]

    def per_layer(self, workload):
        """The per-layer metrics this cell reports: those whose
        `workloads` list it (every per-layer entry has that list)."""
        return [m for m in self.bench["per_layer"]
                if workload in m["workloads"]]

    def _module(self, folder, name):
        path = os.path.join(self.root, "benchmark", folder, name + ".py")
        mod_spec = importlib.util.spec_from_file_location(
            "bench_%s_%s" % (folder, re.sub(r"\W", "_", name)), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod

    def reader(self, name):
        """The per-layer metric's read(ctx)."""
        return self._module("metrics", name).read

    def kind(self, name):
        """The class that drives a traffic file's kind of work."""
        return self._module("kinds", name).Kind


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: the modules
    this process has loaded), each compared whole."""
    tops = {m.split(".")[0] for m in (list(sys.modules) if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(spec, workload, seed, seconds, trace, device, t0, control=False):
    """One run → (the result without `checks`, checks {name: (value,
    limit)}, notes for standard error). With control=True the check's
    number is the reference computed in TF32 in the program's place, and
    `checks` holds the program's own as program_<name> beside it."""
    import torch

    from . import work
    from .trace import profiled

    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    kind = spec.kind(traffic["kind"])(cfg, traffic, seed, device, spec.root)
    kind.warm()
    cuda = kind.device.type == "cuda"
    setup_s = time.perf_counter() - t0
    main = kind.window(seconds)
    traced = summary = None
    if trace:
        traced, summary = profiled(lambda: kind.window(TRACE_SECONDS,
                                                       traced=True))
    peak = torch.cuda.max_memory_allocated(kind.device) if cuda else 0
    kind.free()
    need, checks = _check(kind, cfg, traffic["check"], control)
    value, limit = checks[traffic["check"]]
    # every distinct input the window sent has to have been compared
    result = {"correct": value <= limit and len(kind.kept) == len(
        set(main["sent"])), "attempted": main["units"], "failed": 0}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(kind.device) if cuda
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    metrics, notes = {}, []
    if not trace:
        rates = {"setup_s": setup_s,
                 traffic["rate_metric"]: main["units"] / main["window_s"]}
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": rates[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"cfg": cfg, "traffic": traffic, "kind": kind, "main": main,
               "traced": traced, "trace": summary,
               "peaks": work.PEAKS.get(dev["kind"]), "need": need,
               "work": work, "notes": notes}
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = dev
    return result, checks, notes


def _check(kind, cfg, name, control):
    """Every kept output against the plain reference, once the window
    has closed → (the reference's counts of each input, checks)."""
    from .stream import max_gap

    need = {}
    gap = ctrl_gap = 0.0
    for k in sorted(kind.kept):
        need[k] = {}
        ref = kind.reference_probs(k, tf32=False, need=need[k])
        gap = max(gap, max_gap(kind.kept[k], ref))
        if control:
            ctrl_gap = max(ctrl_gap, max_gap(
                kind.reference_probs(k, tf32=True), ref))
    limit = cfg["limits"][name]
    if control:
        return need, {name: (ctrl_gap, limit),
                      "program_" + name: (gap, limit)}
    return need, {name: (gap, limit)}


def main(argv, t0):
    args = parse(argv)
    spec = Spec()
    wl = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print("no CUDA device, or fewer than the %d the cell asks for"
              % wl["chips"], file=sys.stderr)
        return 3
    result, checks, notes = run(spec, args.workload, args.seed, args.seconds,
                                args.trace, "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print("loaded: %s" % ", ".join(bad), file=sys.stderr)
        return 4
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for line in notes:
        print(line, file=sys.stderr)
    for k, (v, lim) in checks.items():
        print("check %s %r limit %r" % (k, v, lim), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
