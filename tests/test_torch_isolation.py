"""The port imports neither jax/flax/optax nor anything of nanocaller_tpu
(its native library, CRAM and rANS modules, training modules, training
CLIs and entry module included; the library builds from the port's own
ncio.cpp), and device="cuda" without a GPU raises, on the calling path
and on the training, sharded-step and entry paths."""

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
        "nanocaller_tpu_torch.runtime.sharding",
        "nanocaller_tpu_torch.train.snp_train",
        "nanocaller_tpu_torch.train.indel_train",
        "nanocaller_tpu_torch.train.data",
        "nanocaller_tpu_torch.train.indel_data",
        "nanocaller_tpu_torch.train.train_snp",
        "nanocaller_tpu_torch.train.train_indel",
        "nanocaller_tpu_torch.entry"} <= set(mods), mods
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


def test_training_and_entry_cuda_without_gpu_raise(tmp_path):
    """Every training entry point defaults to the card and raises without
    one; none gives way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import numpy as np

    from nanocaller_tpu_torch import entry
    from nanocaller_tpu_torch.runtime import sharding
    from nanocaller_tpu_torch.train import indel_data, indel_train, snp_train
    from nanocaller_tpu_torch.train.train_indel import main as indel_main
    from nanocaller_tpu_torch.train.train_snp import main as snp_main

    ex = {"x": np.zeros((4, 5, 41, 5), np.int8),
          "ref": np.zeros(4, np.uint8), "gt": np.zeros(4, np.uint8),
          "allele1": np.zeros(4, np.uint8), "allele2": np.zeros(4, np.uint8),
          "pos": np.arange(4, dtype=np.int64)}
    out = str(tmp_path / "out")
    cli = ["--bam", "x.bam", "--ref", "x.fa", "--truth_vcf", "x.vcf.gz",
           "--output", out]
    calls = [
        lambda: snp_train.train_snp_model(ex, None, out, epochs=1),
        lambda: indel_train.train_indel_model(
            np.zeros((4, 15, 128, 2), np.float32), np.zeros(4, np.int64),
            out, epochs=1),
        lambda: indel_data.generate_indel_training_examples(
            None, None, {}, {"chrom": "c", "start": 1, "end": 10}),
        lambda: snp_main(cli), lambda: indel_main(cli),
        lambda: sharding.shard_train_step_demo(1),
        lambda: sharding.shard_inference_demo(sharding.make_mesh(1)),
        lambda: entry.entry(), lambda: entry.dryrun_multichip(1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
