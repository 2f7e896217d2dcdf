"""The port imports neither jax/flax/optax nor anything of nanocaller_tpu
(its native library, CRAM and rANS modules included; the library builds
from the port's own ncio.cpp), and device="cuda" without a GPU raises."""

import os
import re
import subprocess
import sys

import pytest
import torch

from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nanocaller_tpu_torch")


_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
sys.path.insert(0, %r)
BLOCK = ("jax", "jaxlib", "flax", "optax", "nanocaller_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
sys.meta_path.insert(0, Block())
for name in BLOCK:
    sys.modules.pop(name, None)
import nanocaller_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(nanocaller_tpu_torch.__path__,
                                              "nanocaller_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"nanocaller_tpu_torch.phase.mec", "nanocaller_tpu_torch.phase.wmec",
        "nanocaller_tpu_torch.phase.wmec_oracle",
        "nanocaller_tpu_torch.io.native", "nanocaller_tpu_torch.io.cram",
        "nanocaller_tpu_torch.io.rans", "nanocaller_tpu_torch.runtime.workers",
        "nanocaller_tpu_torch.runtime.scheduler",
        "nanocaller_tpu_torch.runtime.distributed",
        "nanocaller_tpu_torch.runtime.sharding"} <= set(mods), mods
# the native library builds from the port's own source and loads
from nanocaller_tpu_torch.io import native
assert native.get_lib() is not None
assert native._SRC.startswith(%r)
import chip_smoke
assert callable(chip_smoke.main)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCK]
assert not bad, bad
print("imported", len(mods))
""" % (REPO, os.path.join(REPO, "nanocaller_tpu_torch", ""))


def test_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax)\b"
    r"|^\s*(?:import|from)\s+nanocaller_tpu(?:\.|\s|$)", re.M)


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_source_scan_finds_no_forbidden_import():
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for m in _IMPORT_RE.finditer(fh.read()):
                hits.append((path, m.group(0).strip()))
    assert not hits, hits


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from nanocaller_tpu_torch.align.batch_nw import BatchAligner
    from nanocaller_tpu_torch.indel_caller import IndelCallerState
    from nanocaller_tpu_torch.runtime.device import resolve_device
    from nanocaller_tpu_torch.snp_caller import SnpCallerState

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        BatchAligner()
    with pytest.raises(RuntimeError):
        IndelCallerState.create("ONT-HG002")
    with pytest.raises(RuntimeError):
        SnpCallerState.create("ONT-HG002")
