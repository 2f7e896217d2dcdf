"""Worker functions for the port's scheduler tests (tests/test_torch_workers.py).
They live in a module of their own, which imports only the standard
library, so that a spawned worker loads them without torch or jax."""

import os
import signal


def crashy_worker(task):
    """Kills its own process the FIRST time the marked chunk is seen (a
    sentinel file records the first attempt); succeeds on the retry."""
    idx, chunk = task
    if chunk.get("kill"):
        if not os.path.exists(chunk["sentinel"]):
            open(chunk["sentinel"], "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
    return idx, chunk["val"] * 2


def always_crashy_worker(task):
    idx, chunk = task
    if chunk.get("kill"):
        os.kill(os.getpid(), signal.SIGKILL)
    return idx, chunk["val"] * 2
