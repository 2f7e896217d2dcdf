"""The JAX package's native library for the port's tests that hold the
port's native code against it (tests/test_torch_{phase,native}.py)."""

import pytest

import nanocaller_tpu.io.native as j_native


def jax_native_lib(monkeypatch):
    """The JAX package's native library, loaded past a failure that
    get_lib cached earlier in this process.

    The JAX package builds libncio.so through one shared temporary file
    at first use, and get_lib keeps its first failure for the whole
    process: pytest-xdist workers that import it at collection time all
    at once can lose that race and run on without the library. By test
    time those builds are over, so the cached failure is cleared (for
    this test only) and the load tried once more. A library that still
    does not load fails the test with its error."""
    lib = j_native.get_lib()
    if lib is None:
        cached = j_native._build_error
        monkeypatch.setattr(j_native, "_build_error", None)
        lib = j_native.get_lib()
        if lib is None:
            pytest.fail("the JAX package's native library does not load: "
                        "%r (cached before: %r)"
                        % (j_native._build_error, cached))
    return lib
