"""The port's stall watchdog (nanocaller_tpu_torch/runtime/watchdog.py,
cli.main's --watchdog) against the JAX package's:

- supervise: the same scripted children (a stall then a resume, a real
  error, a stall that persists, a child that SIGKILLs itself once) give
  the same exit code, number of attempts and argv of each attempt
  through both packages' supervise;
- wrap_cli: the child's argv for `--watchdog 5`, `--watchdog=5` and the
  flag at the end equals the JAX package's but for the module name;
- cli.main's dispatch: an unmarked process hands the raw argv, the
  timeout and the output directory to wrap_cli and loads no torch; a
  marked child runs the pipeline itself; run(cfg) ignores cfg.watchdog;
- the CLI under a freeze: `--mode all --device cpu` frozen once after its
  first manifest entry, killed and resumed, writes the five VCFs of an
  unsupervised run byte for byte;
- the beat sites: each site fires in `--cpu 1` runs;
- the builds beat: nvcc (a fake one that sleeps) and the wait on another
  process's native-library build move the heartbeat.
"""

import gzip
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from nanocaller_tpu.runtime import watchdog as JW
from nanocaller_tpu_torch import cli
from nanocaller_tpu_torch.runtime import watchdog as W
from nanocaller_tpu_torch.runtime.watchdog import CHILD_ENV, HEARTBEAT_ENV
from nanocaller_tpu_torch.sim import write_contigs_fixture

from fixtures import make_fixture
from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VCFS = ("unfiltered.snps", "snps", "snps.phased", "indels", "")


def _script(path, body):
    with open(path, "w") as fh:
        fh.write(textwrap.dedent(body))
    return str(path)


# each scripted child appends its argv to RECORD, then acts; SENTINEL
# marks that an earlier attempt already ran
_CHILDREN = {
    "stall_then_resume": """
        open(HB, "w").write(str(time.time()))
        if not os.path.exists(SENTINEL):
            open(SENTINEL, "w").close()
            time.sleep(600)  # a hung device call
        assert "--resume" in sys.argv
    """,
    "real_error": """
        sys.exit(7)
    """,
    "persistent_stall": """
        time.sleep(600)
    """,
    "killed_once": """
        if not os.path.exists(SENTINEL):
            open(SENTINEL, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)  # the OOM killer
    """,
}
# (timeout, max_retries, poll) of each case: a window over a bare
# interpreter's start-up on a loaded machine where the child stalls
# after a beat, 1 s where it never beats
_SUPERVISE_ARGS = {"stall_then_resume": (8, 3, 0.3),
                   "real_error": (5, 2, 0.2),
                   "persistent_stall": (1, 1, 0.2),
                   "killed_once": (5, 2, 0.2)}
_WANT = {"stall_then_resume": (0, 2), "real_error": (7, 1),
         "persistent_stall": (124, 2), "killed_once": (0, 2)}


def _supervised(impl, case, d):
    os.makedirs(d)
    record = os.path.join(d, "argv.jsonl")
    head = ("import json, os, signal, sys, time\n"
            "HB = os.environ[%r]\nSENTINEL = %r\n"
            "open(%r, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
            % (HEARTBEAT_ENV, os.path.join(d, "sentinel"), record))
    script = _script(os.path.join(d, "job.py"),
                     head + textwrap.dedent(_CHILDREN[case]))
    timeout, retries, poll = _SUPERVISE_ARGS[case]
    logs = []
    rc = impl.supervise([sys.executable, script, "--x", "1"],
                        os.path.join(d, "hb"), timeout=timeout, poll=poll,
                        max_retries=retries, log=logs.append)
    with open(record) as fh:
        argvs = [json.loads(x) for x in fh]
    return rc, argvs, [re.sub(r"\d+s", "Ns", m) for m in logs]


@pytest.mark.parametrize("case", sorted(_CHILDREN))
def test_supervise_matches_jax(case, tmp_path):
    want = _supervised(JW, case, str(tmp_path / "jax"))
    got = _supervised(W, case, str(tmp_path / "port"))
    assert got == want
    rc, argvs, logs = got
    assert (rc, len(argvs)) == _WANT[case]
    assert argvs[0] == ["--x", "1"]
    assert all(a == ["--x", "1", "--resume"] for a in argvs[1:])
    if case == "persistent_stall":
        assert "giving up" in logs[-1]


@pytest.mark.parametrize("flag", [["--watchdog", "5"], ["--watchdog=5"],
                                  "end"], ids=["space", "equals", "end"])
def test_wrap_cli_argv_matches_jax(flag, tmp_path, monkeypatch):
    # a set platform keeps the JAX wrap_cli from writing one into os.environ
    monkeypatch.setenv("NC_TPU_PLATFORM", "cpu")
    argv = ["--bam", "b.bam", "--ref", "r.fa", "--mode", "all"]
    argv = argv + ["--watchdog", "5"] if flag == "end" else \
        argv[:2] + flag + argv[2:]
    calls = {}
    for name, impl in (("jax", JW), ("port", W)):
        def fake_supervise(cmd, hb, timeout, _name=name):
            calls[_name] = (cmd, hb, timeout)
            return 0

        monkeypatch.setattr(impl, "supervise", fake_supervise)
        assert impl.wrap_cli(list(argv), 5, str(tmp_path / "out")) == 0
    (jcmd, jhb, jt), (cmd, hb, t) = calls["jax"], calls["port"]
    assert jcmd[:3] == [sys.executable, "-m", "nanocaller_tpu.cli"]
    assert cmd[:3] == [sys.executable, "-m", "nanocaller_tpu_torch.cli"]
    assert cmd[3:] == jcmd[3:] == ["--bam", "b.bam", "--ref", "r.fa",
                                   "--mode", "all"]
    assert (hb, t) == (jhb, jt) == (str(tmp_path / "out" / ".heartbeat"), 5)


def test_dispatch(tmp_path, monkeypatch):
    calls = {}

    def fake_wrap(argv, timeout, output_dir):
        calls.update(argv=argv, timeout=timeout, output_dir=output_dir)
        return calls.get("rc", 0)

    monkeypatch.setattr(W, "wrap_cli", fake_wrap)
    monkeypatch.delenv(CHILD_ENV, raising=False)
    out = str(tmp_path)
    argv = ["--bam", "b.bam", "--ref", "r.fa", "--output", out, "--prefix",
            "w", "--watchdog", "120"]
    assert cli.main(argv) == {}
    assert calls == dict(argv=argv, timeout=120, output_dir=out)
    # the paths that exist come back; a failed child is the process's rc
    for name in ("w.snps.vcf.gz", "w.vcf.gz"):
        open(os.path.join(out, name), "w").close()
    assert cli.main(argv) == {"snps": os.path.join(out, "w.snps.vcf.gz"),
                              "final": os.path.join(out, "w.vcf.gz")}
    calls["rc"] = 124
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 124
    # a marked child runs the pipeline itself
    calls.clear()
    monkeypatch.setenv(CHILD_ENV, "1")
    import nanocaller_tpu_torch.caller as caller

    monkeypatch.setattr(caller, "run", lambda cfg: {"ran": cfg.watchdog})
    assert cli.main(argv) == {"ran": 120} and not calls


_NO_TORCH = r"""
import sys
sys.path.insert(0, %r)
import nanocaller_tpu_torch.runtime.watchdog as W
seen = []
W.wrap_cli = lambda argv, timeout, out: seen.append(argv) or 0
from nanocaller_tpu_torch import cli
cli.main(["--bam", "b.bam", "--ref", "r.fa", "--output", %r,
          "--watchdog", "120"])
assert seen, "wrap_cli was not called"
print("torch loaded:", "torch" in sys.modules)
"""


def test_supervisor_loads_no_torch(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != CHILD_ENV}
    res = subprocess.run([sys.executable, "-c", _NO_TORCH
                          % (REPO, str(tmp_path))], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "torch loaded: False"


def _vcfs(out, prefix):
    data = []
    for name in VCFS:
        path = os.path.join(out, "%s.%s.vcf.gz" % (prefix, name) if name
                            else "%s.vcf.gz" % prefix)
        with gzip.open(path) as fh:
            data.append(fh.read())
    return data


_FREEZE_HOOK = """
    import os, time
    import nanocaller_tpu_torch.runtime.scheduler as sched
    _orig = sched.RunManifest.mark_done
    def patched(self, stage, chunk, shard):
        _orig(self, stage, chunk, shard)
        if os.environ.get("%s") and not os.path.exists(%r):
            open(%r, "w").close()
            time.sleep(600)  # a hung kernel: no beat from here on
    sched.RunManifest.mark_done = patched
"""


def test_cli_recovers_from_a_freeze(tmp_path, monkeypatch):
    """The port's CLI, `--mode all --device cpu`, run under the port's
    supervise over a runner that freezes the first child right after its
    first manifest entry: the child is killed, the relaunch (--resume)
    completes, and the five VCFs equal an unsupervised run's byte for
    byte. As in tests/test_watchdog.py the runner goes through supervise
    directly: `--watchdog` re-execs `python -m nanocaller_tpu_torch.cli`,
    which would not load the hook."""
    import torch

    fasta_p, bam_p, _, _ = make_fixture(tmp_path, depth=25, L=9000,
                                        read_len=900, seed=4)
    argv = lambda out: ["--bam", bam_p, "--ref", fasta_p, "--mode", "all",
                        "--device", "cpu", "--output", str(tmp_path / out),
                        "--prefix", "w", "--sample", "S",
                        "--suppress_progress_bar"]
    cli.main(argv("plain"))
    sentinel = str(tmp_path / "froze_once")
    hook_dir = tmp_path / "hook"
    hook_dir.mkdir()
    _script(hook_dir / "nc_freeze_hook.py",
            _FREEZE_HOOK % (CHILD_ENV, sentinel, sentinel))
    runner = _script(tmp_path / "run_cli.py", """
        import nc_freeze_hook
        import sys
        from nanocaller_tpu_torch.cli import main
        main(sys.argv[1:])
    """)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO, str(hook_dir), os.environ.get("PYTHONPATH", "")]))
    # the children take this process's torch threads (torch_threads)
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    logs = []
    # 60 s, not the 30 s of tests/test_watchdog.py: the window has to
    # cover a child's start-up (interpreter, torch, the fixture's first
    # chunk) before its first beat, and under the test suite's six
    # workers 30 s did not cover a JAX child's, so every attempt was
    # killed before it could beat
    rc = W.supervise([sys.executable, runner, *argv("watched")],
                     str(tmp_path / "hb"), timeout=60, poll=0.5,
                     max_retries=2, log=logs.append)
    assert rc == 0, logs
    assert os.path.exists(sentinel)  # the freeze really happened
    assert sum("killing the run" in m for m in logs) == 1, logs
    assert _vcfs(str(tmp_path / "watched"), "w") == \
        _vcfs(str(tmp_path / "plain"), "w")


def _counting(monkeypatch):
    """Count watchdog.beat() by calling site: (file, qualified name)."""
    sites = {}

    def beat(min_interval=1.0):
        code = sys._getframe(1).f_code
        key = (os.path.basename(code.co_filename), code.co_qualname)
        sites[key] = sites.get(key, 0) + 1

    monkeypatch.setattr(W, "beat", beat)
    return sites


def test_beat_sites_fire(tmp_path, monkeypatch):
    """Each beat site fires in --cpu 1 runs: `--mode all` (run() ignores
    cfg.watchdog, which only cli.main acts on) and the per-chunk SNP path
    (`snp_group_payload=False`); the group and the chunk routes' copy-backs
    share one finisher, whose beat fires in both runs."""
    from nanocaller_tpu_torch.caller import run
    from nanocaller_tpu_torch.config import Config

    # planted indels, so that the indel CNN runs
    fasta_p, bam_p, _, _ = write_contigs_fixture(
        str(tmp_path), [("chr1", 10_000, 41, 300, 1500, False)], depth=30,
        read_len=3000)
    sites = _counting(monkeypatch)
    kw = dict(bam=bam_p, ref=fasta_p, cpu=1, prefix="b", sample="S",
              device="cpu")
    out = run(Config(mode="all", output=str(tmp_path / "all"),
                     suppress_progress=False, watchdog=5, **kw))
    assert out["final"] and os.path.exists(out["final"])
    snp_site = ("snp_caller.py", "_infer_launches.<locals>.finish")
    group_beats = sites.get(snp_site, 0)
    assert group_beats > 0, sites
    run(Config(mode="snps", output=str(tmp_path / "chunk"),
               suppress_progress=True, snp_group_payload=False, **kw))
    want = {("scheduler.py", "RunManifest.mark_done"),
            ("scheduler.py", "Progress.update"),
            ("workers.py", "phase_one_contig"), snp_site,
            ("indel_caller.py", "_run_stacked"),
            ("indel_features.py", "finish_indel_jobs")}
    assert want <= set(sites), sites
    assert sites[snp_site] > group_beats  # the chunk route's copy-backs
    assert sites[("workers.py", "phase_one_contig")] == 4  # one contig
    assert sites[("indel_features.py", "finish_indel_jobs")] % 2 == 0


def _mtimes_while(fn, path):
    """Run fn() while a thread samples path's mtime; returns (fn's
    result, the distinct mtimes seen after the start)."""
    seen, done = set(), threading.Event()
    t0 = time.time()

    def sample():
        while not done.is_set():
            try:
                m = os.path.getmtime(path)
            except OSError:
                m = 0
            if m > t0:
                seen.add(m)
            time.sleep(0.05)

    th = threading.Thread(target=sample)
    th.start()
    try:
        return fn(), seen
    finally:
        done.set()
        th.join()


@pytest.fixture
def heartbeat(tmp_path, monkeypatch):
    hb = str(tmp_path / "hb")
    open(hb, "w").close()
    os.utime(hb, (time.time() - 1000,) * 2)
    monkeypatch.setenv(HEARTBEAT_ENV, hb)
    monkeypatch.setattr(W, "_last_beat", 0.0)
    return hb


_FAKE_NVCC = """#!/bin/sh
# nvcc stand-in: sleeps as a compile does, then writes the -o target
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
sleep 3
: > "$out"
"""


def test_nvcc_build_beats(tmp_path, monkeypatch, heartbeat):
    """build() beats while its nvcc processes run (one compile a csrc/*.cu,
    all together, then the link: ~6 s with this stand-in), and a
    temporary directory that a killed build left behind does not stop the
    next one."""
    from nanocaller_tpu_torch.runtime import kernels as K

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "_build"
    stale = build_dir / "tmpkilled"
    stale.mkdir(parents=True)
    (stale / "nw_tb.cu.o").write_bytes(b"half written")
    monkeypatch.setattr(K, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(K, "BUILD_DIR", str(build_dir))
    lib, beats = _mtimes_while(K.build, heartbeat)
    assert os.path.exists(lib) and os.path.dirname(lib) == str(build_dir)
    assert len(beats) >= 3, beats
    # the build's own temporary directory is gone, the stale one unread
    assert sorted(os.listdir(build_dir)) == [os.path.basename(lib),
                                             "tmpkilled"]


def test_native_build_wait_beats(tmp_path, monkeypatch, heartbeat):
    """A process that waits on another's native-library build (the lock
    file) beats while it waits, then takes the library the other built."""
    import fcntl

    from nanocaller_tpu_torch.io import native

    build_dir = tmp_path / "_build"
    build_dir.mkdir()
    so = str(build_dir / "libncio_test.so")
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "library_path", lambda: so)
    locked = threading.Event()

    def other_build():
        with open(os.path.join(str(build_dir), "libncio.lock"), "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            locked.set()
            time.sleep(3)
            open(so, "w").close()
            fcntl.flock(fh, fcntl.LOCK_UN)

    th = threading.Thread(target=other_build)
    th.start()
    locked.wait()
    got, beats = _mtimes_while(native.build, heartbeat)
    th.join()
    assert got == so
    assert len(beats) >= 2, beats


def test_bench_e2e_passes_watchdog(tmp_path, capsys):
    """bench_e2e --watchdog runs the CLI under supervision (the child
    writes the calls, the supervisor's heartbeat file is there), as the
    JAX tool passes the flag through."""
    from nanocaller_tpu_torch.tools import bench_e2e

    wd = str(tmp_path / "bench")
    bench_e2e.main(["--workdir", wd, "--mb", "0.06", "--cpu", "1",
                    "--device", "cpu", "--watchdog", "60"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["results"]["snp"]["f1"] > 0.5
    assert os.path.exists(os.path.join(wd, "out", ".heartbeat"))
