"""Stall watchdog: supervise the run, re-exec on a hang, resume.

The port's copy of nanocaller_tpu/runtime/watchdog.py (the standard
library only). A CUDA kernel that never ends (a device-side deadlock, a
bad loop bound, a hung collective) blocks the host for good at its
copy-back, and CUDA has no host-side way to cancel a kernel short of
ending the process; a Gloo peer that dies leaves the others blocked in
their next collective or failing it. So the only robust recovery is
process-level: `--watchdog SECONDS` makes the CLI supervise a child copy
of itself. The child touches a heartbeat file on every unit of pipeline
progress (device copy-backs, chunk completions, manifest writes, phasing
milestones, kernel and library builds); if the heartbeat goes stale past
the timeout the child's process group is killed (ending a process frees
its CUDA context and ends its kernels) and relaunched with --resume,
picking up from the chunk manifest (completed work replays
byte-identically). A child killed by an outside signal (the OOM killer,
an operator) is relaunched the same way. Bounded retries; a child that
exits non-zero without stalling is a real error and is not retried.

The supervising parent imports neither torch nor anything that loads
CUDA: it holds no card memory while its child runs.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

HEARTBEAT_ENV = "NC_TPU_HEARTBEAT"
CHILD_ENV = "NC_TPU_WATCHDOG_CHILD"

_last_beat = 0.0


def beat(min_interval=1.0):
    """Touch the heartbeat file if supervision is active (throttled).

    Called on pipeline PROGRESS, not liveness: a background touch-thread
    would keep ticking right through a hung kernel. On the device a site
    beats after a copy-back, never at a launch: launches are
    asynchronous, so a beat there goes on while a kernel hangs."""
    global _last_beat
    path = os.environ.get(HEARTBEAT_ENV)
    if not path:
        return
    now = time.monotonic()
    if now - _last_beat < min_interval:
        return
    _last_beat = now
    try:
        with open(path, "w") as fh:
            fh.write(str(time.time()))
    except OSError:
        pass


def communicate(proc, poll=1.0):
    """proc.communicate(), beating every `poll` seconds while the process
    runs: a compiler at work (nvcc, g++) is progress, as an XLA compile
    is in the JAX package, and a cold build takes tens of seconds."""
    while True:
        try:
            return proc.communicate(timeout=poll)
        except subprocess.TimeoutExpired:
            beat()


def supervise(cmd, heartbeat_path, timeout, max_retries=3, poll=2.0,
              resume_flag="--resume", log=print):
    """Run cmd under stall supervision; returns the child's exit code.

    cmd: argv list for the first attempt. On stall (heartbeat older
    than `timeout` seconds) the child process group is killed and the
    command relaunched with `resume_flag` appended (if not present).
    A child killed by an EXTERNAL signal (negative returncode: OOM
    killer, operator kill) is retried the same way: in a multi-process
    run this lets the killed process relaunch while the survivors'
    watchdogs cycle their stalled children. A non-stalled non-zero
    *exit* is returned as-is (real error). 124 after 1 + max_retries
    attempts.
    """
    env = dict(os.environ)
    env[HEARTBEAT_ENV] = heartbeat_path
    env[CHILD_ENV] = "1"
    attempt_cmd = list(cmd)
    for attempt in range(1 + max_retries):
        with open(heartbeat_path, "w") as fh:
            fh.write(str(time.time()))
        start = time.monotonic()
        child = subprocess.Popen(attempt_cmd, env=env,
                                 start_new_session=True)
        stalled = False
        while True:
            try:
                rc = child.wait(timeout=poll)
                break
            except subprocess.TimeoutExpired:
                try:
                    age = time.time() - os.path.getmtime(heartbeat_path)
                except OSError:
                    age = time.monotonic() - start
                if age > timeout:
                    stalled = True
                    log("watchdog: no progress for %.0fs — killing the "
                        "run and resuming in a fresh process (attempt "
                        "%d/%d)" % (age, attempt + 1, max_retries + 1))
                    try:
                        os.killpg(child.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        child.kill()
                    child.wait()
                    break
        if not stalled:
            if rc >= 0:
                return rc
            log("watchdog: child killed by signal %d — resuming in a "
                "fresh process (attempt %d/%d)"
                % (-rc, attempt + 1, max_retries + 1))
        if resume_flag not in attempt_cmd:
            attempt_cmd = attempt_cmd + [resume_flag]
    log("watchdog: giving up after %d attempts" % (1 + max_retries))
    return 124


def wrap_cli(argv, timeout, output_dir):
    """Supervise `python -m nanocaller_tpu_torch.cli <argv>` (watchdog
    flag stripped; child marked via env). Returns the child's exit code.
    The child picks its device from its own argv (`--device`)."""
    clean = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--watchdog":
            skip = True
            continue
        if tok.startswith("--watchdog="):
            continue
        clean.append(tok)
    os.makedirs(output_dir, exist_ok=True)
    hb = os.path.join(output_dir, ".heartbeat")
    cmd = [sys.executable, "-m", "nanocaller_tpu_torch.cli"] + clean
    return supervise(cmd, hb, timeout)
