"""How the port runs its CPU twins of K1/K2/K4 (nw_tb_reference,
nw_walk_reference, nw_cigar_reference) beside other processes.

- A `python -m nanocaller_tpu_torch.cli` process runs with OpenMP's
  passive wait policy (the package sets it before torch loads OpenMP)
  and torch's default intra-op thread count, and records both in
  metrics.json (`cpu_settings`); values the environment sets are kept.
- The twins are integer work: their outputs are byte-identical at 1 and
  at 4 intra-op threads, so no thread or wait setting can move a call.
- The tools' `run_cli` hands the caller's torch thread count to the CLI
  child, unless the environment sets OMP_NUM_THREADS; a caller that has
  not loaded torch (a tool run from a shell) hands nothing down.
No timing is asserted."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.align.batch_nw import encode_pairs, pad_bytes
from nanocaller_tpu_torch.sim import make_fixture
from nanocaller_tpu_torch.tools import real_data_eval as p_eval

from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# BatchAligner's default scoring
PARAMS = (20, -10, 9, 1)


def _child_env(**extra):
    """This environment without the threading variables (this process
    may have set OMP_WAIT_POLICY by importing the package), plus
    `extra`, with the repo on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OMP_", "GOMP_", "KMP_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [REPO, os.environ.get("PYTHONPATH", "")] if p)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def tagged_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cpu_threads")
    fasta_p, bam_p, _, _ = make_fixture(
        tmp, seed=16, L=6000, depth=20, read_len=900, error_rate=0.02,
        indels=[(2000, "del", 3, "het1"), (4000, "ins", "GT", "hom")],
        tag_haplotypes=True)
    return str(tmp), fasta_p, bam_p


@pytest.mark.parametrize("user", [False, True], ids=["package", "user"])
def test_cli_child_cpu_settings(tagged_fixture, user):
    """The CLI's child process, running the twins (`--mode indels` on
    the CPU), reports PASSIVE and torch's default thread count; with
    OMP_WAIT_POLICY and OMP_NUM_THREADS in its environment, those."""
    tmp, fasta_p, bam_p = tagged_fixture
    extra = {"OMP_WAIT_POLICY": "ACTIVE", "OMP_NUM_THREADS": "3"} \
        if user else {}
    env = _child_env(**extra)
    out = os.path.join(tmp, "user" if user else "package")
    subprocess.run(
        [sys.executable, "-m", "nanocaller_tpu_torch.cli", "--bam", bam_p,
         "--ref", fasta_p, "--mode", "indels", "--cpu", "1", "--device",
         "cpu", "--output", out, "--prefix", "p", "--sample", "S",
         "--suppress_progress_bar"], env=env, cwd=REPO, check=True,
        capture_output=True)
    with open(os.path.join(out, "metrics.json")) as fh:
        got = json.load(fh)["cpu_settings"]
    assert got["cpu_count"] == os.cpu_count()
    if user:
        assert (got["omp_wait_policy"], got["intra_op_threads"]) == \
            ("ACTIVE", 3)
    else:
        default = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.get_num_threads())"],
            env=env, capture_output=True, text=True, check=True)
        assert got["omp_wait_policy"] == "PASSIVE"
        assert got["intra_op_threads"] == int(default.stdout)
    with open(os.path.join(out, "metrics.json")) as fh:
        assert json.load(fh)["counts"].get("indel_candidates", 0) > 0


def _pairs(rng, B, Q, R):
    """B pairs: half a read window (its ref window with 10% edits)
    against the window, half unrelated sequences; codes, lengths and
    bytes as BatchAligner gives them to the twins."""
    pairs = []
    for k in range(B):
        n = int(rng.integers(max(1, R - 40), R + 1))
        ref = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
        if k % 2:
            qry = "".join(
                c if rng.random() > 0.1 else "ACGT"[rng.integers(0, 4)] * 2
                for c in ref)
        else:
            qry = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
        pairs.append((qry[:Q] or "A", ref))
    q, r, ql, rl = encode_pairs(pairs, Q, R)
    return (torch.from_numpy(np.ascontiguousarray(q)),
            torch.from_numpy(np.ascontiguousarray(r)),
            torch.from_numpy(ql.astype(np.int32)),
            torch.from_numpy(rl.astype(np.int32)),
            torch.from_numpy(pad_bytes([a for a, _ in pairs], Q)[0]),
            torch.from_numpy(pad_bytes([b for _, b in pairs], R)[0]))


def _twins(q, r, ql, rl, qraw, rraw):
    Q, R = q.shape[1], r.shape[1]
    tb = K.nw_tb_reference(q, r, *PARAMS)
    ops = K.nw_walk_reference(tb, ql, rl, 2 * (Q + R) + 2)
    runs, counts = K.nw_cigar_reference(ops, qraw, rraw)
    return tb, ops, runs, counts


@pytest.mark.parametrize("Q,R", [(64, 192), (192, 192)])
def test_twins_identical_across_thread_counts(Q, R):
    """B = 256 rows of R + 1 = 193 cells are over torch's grain of 32,768
    elements, so at 4 threads the row ops split over the pool."""
    args = _pairs(np.random.default_rng(Q * 1000 + R), 256, Q, R)
    n = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = _twins(*args)
        torch.set_num_threads(4)
        four = _twins(*args)
    finally:
        torch.set_num_threads(n)
    for a, b in zip(one, four):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(one[3].min()) > 0


@pytest.mark.parametrize("user", [False, True], ids=["caller", "user"])
def test_run_cli_hands_down_thread_budget(monkeypatch, user):
    seen = {}

    def fake_run(argv, check, env):
        seen["argv"], seen["env"] = argv, env

    monkeypatch.setattr(p_eval.subprocess, "run", fake_run)
    if user:
        monkeypatch.setenv("OMP_NUM_THREADS", "3")
    else:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    p_eval.run_cli(["--mode", "all"], "cpu")
    assert seen["argv"][-2:] == ["--device", "cpu"]
    want = "3" if user else str(torch.get_num_threads())
    assert seen["env"]["OMP_NUM_THREADS"] == want


def test_run_cli_from_a_shell_hands_down_nothing():
    """A process that has not loaded torch (the tools import none)
    leaves the child's pool at its default."""
    code = (
        "import sys, subprocess\n"
        "from nanocaller_tpu_torch.tools import real_data_eval as e\n"
        "seen = {}\n"
        "subprocess.run = lambda argv, check, env: seen.update(env=env)\n"
        "e.run_cli(['--mode', 'all'], 'cpu')\n"
        "print('torch' in sys.modules, 'OMP_NUM_THREADS' in seen['env'])\n")
    res = subprocess.run([sys.executable, "-c", code], env=_child_env(),
                         cwd=REPO, capture_output=True, text=True, check=True)
    assert res.stdout.split() == ["False", "False"]
