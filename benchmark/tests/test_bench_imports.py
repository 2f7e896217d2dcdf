"""What a run loads: never JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

from nbench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# a run of the harness on the CPU at a tiny size, in a fresh interpreter
# (no test plugins), the way run.py sets its paths; prints the top-level
# modules it loaded and what forbidden_modules() says
RUN = r"""
import json, sys, time
sys.path[:0] = [%(bench)r, %(root)r]
from nbench import harness
class Tiny(harness.Spec):
    def traffic(self, name):
        t = super().traffic(name)
        t.update(groups=1, members_per_group=2, member_bp=40000,
                 halo_bp=10000, read_len_bp=8000)
        return t
res, checks, _ = harness.run(Tiny(), "ont_snp_stream", 5, 0.2, 0, "cpu",
                             time.perf_counter())
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules(),
                  "correct": res["correct"]}))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", RUN % {"bench": BENCH, "root": ROOT}],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["forbidden"] == []
    assert "nanocaller_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(harness.FORBIDDEN)


def test_forbidden_compares_whole_top_level_names():
    ok = ["nanocaller_tpu_torch", "nanocaller_tpu_torch.snp_caller",
          "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["nanocaller_tpu.io", "jax",
                                           "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib", "nanocaller_tpu"]


def test_no_source_imports_jax():
    """No file of the benchmark imports a forbidden top-level name."""
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in harness.FORBIDDEN, (f, n)
