"""The port's CUDA kernel library: its nvcc build and its launch functions.

Every kernel source csrc/*.cu is built at first use with nvcc for
sm_90a into nanocaller_tpu_torch/_build/ (a directory .gitignore lists),
into one library named by the hash of the sources, the headers they
include (csrc/*.cuh) and the flags, and loaded with ctypes. Each kernel's
wrapper binds its own `<name>_launch` function where it calls it
(launch_fn), declaring the arguments it passes; every launch function
returns a cudaError code. A new kernel thus adds its .cu file and its
wrapper, and nothing here.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

from . import watchdog

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the argument types a launch function declares
P, I = ctypes.c_void_p, ctypes.c_int

_LIB = None
_LAUNCH = {}  # name -> the bound launch function


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                       "in %s)" % CSRC)


def build():
    """Compile the kernel sources (if their hash changed) and return the
    library path: one nvcc per source, all started together, then one
    link into a .so. It beats a supervising --watchdog while nvcc runs
    (a cold build takes tens of seconds). Each build works in a fresh
    temporary directory and renames the library into place, so one
    that a killed process left behind is never read."""
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, "libnw_%s.so" % h.hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o",
                                   obj, src], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        results = [(watchdog.communicate(p)[0], p.returncode)
                   for p in procs]
        so = os.path.join(tmp, "lib.so")
        link = subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                                 *objs], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        results.append((watchdog.communicate(link)[0], link.returncode))
        for out, rc in results:
            if rc != 0:
                raise RuntimeError("nvcc failed (%d):\n%s" % (rc, out))
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def launch_fn(name, argtypes):
    """The library's launch function `name` (built and loaded at the first
    call), its arguments declared as `argtypes` (P and I) and its result
    an int, bound once."""
    global _LIB
    fn = _LAUNCH.get(name)
    if fn is None:
        if _LIB is None:
            _LIB = ctypes.CDLL(build())
        fn = getattr(_LIB, name)
        fn.argtypes = argtypes
        fn.restype = I
        _LAUNCH[name] = fn
    return fn
