"""chip_smoke.CudaContextWatch on the CPU: the check that no child of the
device owner maps libcuda, with a library that this process maps and a
plain child does not (numpy's core module) standing in for libcuda.

A child forked but not yet exec'd shares this process's mappings for
that moment; the watch must not flag it unless it stays so past the
grace, and must flag an exec'd child that maps the library. The forked
child here waits on a pipe before it execs, so the test decides how
long the window lasts, whatever the host's load."""

import os
import subprocess
import sys
import time

import numpy  # noqa: F401  (maps _multiarray_umath in this process)
import pytest

import chip_smoke


@pytest.fixture
def watch_lib(monkeypatch):
    def maps(pid):
        try:
            with open("/proc/%d/maps" % pid) as fh:
                return "_multiarray_umath" in fh.read()
        except OSError:
            return False

    monkeypatch.setattr(chip_smoke, "_maps_libcuda", maps)


def _until(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "the watch never saw it"
        time.sleep(0.01)


def _held_fork():
    """A child of this process that stays un-exec'd until released. It
    closes every other descriptor it inherited at once: a pipe of the
    watch's own nvidia-smi call, held open here, would stall the watch."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        try:
            os.closerange(3, r)
            os.closerange(r + 1, 1 << 16)
            os.read(r, 1)
            os.execv("/bin/true", ["true"])
        finally:
            os._exit(1)
    os.close(r)
    return pid, w


def _release(pid, w):
    os.write(w, b"x")
    os.close(w)
    os.waitpid(pid, 0)


@pytest.mark.parametrize("grace, flagged", [(30.0, False), (0.3, True)])
def test_fork_before_exec(watch_lib, grace, flagged):
    """A window shorter than the grace is a fork on its way to exec; one
    that outlasts it is a copy that keeps the mappings."""
    with chip_smoke.CudaContextWatch(period=0.02, fork_grace=grace) as w:
        pid, fd = _held_fork()
        try:
            if flagged:
                _until(lambda: w.cuda_children)
            else:
                _until(lambda: w.fork_windows >= 3)
        finally:
            _release(pid, fd)
        polls = w.polls
        _until(lambda: w.polls >= polls + 2)
    assert w.fork_windows >= 1
    assert (pid in w.cuda_children) is flagged, (w.polls, w.fork_windows)


def test_exec_child_mapping_the_library_is_flagged(watch_lib):
    with chip_smoke.CudaContextWatch(period=0.02, fork_grace=30.0) as w:
        p = subprocess.Popen([sys.executable, "-c",
                              "import numpy, sys; sys.stdin.read()"],
                             stdin=subprocess.PIPE)
        try:
            _until(lambda: w.cuda_children)
        finally:
            p.communicate(b"")
    assert w.cuda_children == {p.pid}


def test_plain_exec_child_is_not_flagged(watch_lib):
    with chip_smoke.CudaContextWatch(period=0.02, fork_grace=30.0) as w:
        p = subprocess.Popen([sys.executable, "-c",
                              "import sys; sys.stdin.read()"],
                             stdin=subprocess.PIPE)
        polls = w.polls
        _until(lambda: w.polls >= polls + 3)
        p.communicate(b"")
    assert not w.cuda_children
