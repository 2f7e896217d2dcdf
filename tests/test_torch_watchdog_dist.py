"""`--watchdog` over two port processes joined by Gloo, on the CPU (the
JAX package's contract of tests/test_distributed.py's rendezvous case):
process 1's child is SIGKILLed in the rendezvous window; its supervisor
relaunches it (a death by an outside signal is retried like a stall),
the pair forms the process group, both supervisors exit 0 and process 0
writes the merged outputs.

The supervisors' output goes to files: a supervisor whose pipe nobody
reads blocks in its log line and supervises nothing."""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from nanocaller_tpu_torch.sim import write_contigs_fixture

from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 300


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_of(pid):
    """PID of a live process whose parent is `pid` (None when none)."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % d) as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            return int(d)
    return None


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_watchdog_dist"))
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        tmp, [("chr1", 10_000, 41, 300, 1500, False),
              ("chrX", 9_500, 42, 300, 1500, True)], depth=30,
        read_len=3000)
    return tmp, fasta_p, bam_p


def _rendezvous_kill(fasta_p, bam_p, out):
    coord = "localhost:%d" % _free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [REPO, env.get("PYTHONPATH", "")] if p)
    env.pop("NC_TPU_WATCHDOG_CHILD", None)
    os.makedirs(out)
    logs = [os.path.join(out, "supervisor%d.log" % i) for i in range(2)]
    # the window covers a child's start-up and process 0's wait at the
    # rendezvous while process 1 relaunches, under the suite's workers
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanocaller_tpu_torch.cli", "--bam", bam_p,
         "--ref", fasta_p, "--mode", "all", "--cpu", "2", "--haploid_X",
         "--device", "cpu", "--output", out, "--prefix", "p", "--sample",
         "S", "--suppress_progress_bar", "--watchdog", "60",
         "--coordinator", coord, "--num_processes", "2", "--process_id",
         str(i)], env=env, cwd=REPO, stdout=open(logs[i], "w"),
        stderr=subprocess.STDOUT) for i in range(2)]
    try:
        t0 = time.time()
        child = None
        while child is None and time.time() - t0 < 30:
            child = _child_of(procs[1].pid)
            time.sleep(0.02)
        assert child is not None, "process 1's supervisor started no child"
        os.kill(child, signal.SIGKILL)
        rcs = [p.wait(timeout=PROC_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                c = _child_of(p.pid)
                if c is not None:
                    os.killpg(c, signal.SIGKILL)
                p.kill()
                p.wait()
    text = []
    for path in logs:
        with open(path) as fh:
            text.append(fh.read())
    return rcs, text


def test_rendezvous_kill_recovers(two_contigs, tmp_path):
    """The kill must land before the pair has formed: a kill after it
    ends the run (the survivor's collective fails; bounded, not
    recovered), so one more try absorbs a run where the machine's load
    put it late, as tests/test_distributed.py does."""
    _tmp, fasta_p, bam_p = two_contigs
    last = None
    for attempt in range(2):
        out = str(tmp_path / ("try%d" % attempt))
        rcs, logs = _rendezvous_kill(fasta_p, bam_p, out)
        try:
            assert rcs == [0, 0], [x[-3000:] for x in logs]
            assert "child killed by signal 9" in logs[1]
            assert "no progress" not in logs[0] + logs[1]
            for name in ("snps", "snps.phased", "indels", ""):
                assert os.path.exists(os.path.join(
                    out, "p.%s.vcf.gz" % name if name else "p.vcf.gz"))
            return
        except AssertionError as e:
            last = e
    raise last
