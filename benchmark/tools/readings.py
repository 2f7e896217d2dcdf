"""The readings a cell's check limit is set from, on the chip.

    python3 benchmark/tools/readings.py --workload <name> \
        --seeds <n>[,<n>...] [--seconds S]

For each seed, in one process: the cell's set-up and a short window at
its own load (--seconds, long enough to send every distinct input), then
the kept outputs against the plain reference (the program's reading)
and the reference computed in TF32 against it (the control's reading).
Prints one JSON line a seed; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

from nbench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    spec = harness.Spec()
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        res, checks, _notes = harness.run(spec, a.workload, seed, a.seconds,
                                         0, a.device, t0, control=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "attempted": res["attempted"],
                          "readings": {k: v for k, (v, _lim)
                                       in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
