"""Build the JAX package's native library once before the test workers
start.

`nanocaller_tpu.io.native` builds `libncio.so` through one shared
temporary file and caches a failed build for the rest of the process, so
xdist workers that build it at the same time can lose the race and skip
every test that needs the library. Building it here, in the controlling
process, leaves the workers an up-to-date library to load. A failed
build is left to the workers, which skip as before.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        from nanocaller_tpu.io.native import get_lib
    except ImportError:
        return
    get_lib()
