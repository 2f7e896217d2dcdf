"""Device selection for the port's entry points.

The counterpart of the JAX package's JAX_PLATFORMS: every entry point
takes a `device` ("cuda" unless the caller asks for "cpu") and resolves
it here. "cuda" on a machine without a usable GPU raises; it never
carries on quietly on the CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda"):
    """str | torch.device → torch.device, checked.

    On CUDA this is also where the port pins its float32 numerics: TF32
    off for matmuls and cuDNN convolutions, and deterministic cuDNN
    algorithms, so the indel CNN on the card stays within 2e-5 of the
    CPU (and of the JAX package's flax models)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU" % str(device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % str(device))
    return dev


def to_host(t):
    """Queue t's copy into pinned host memory on the current stream of
    t's device, behind what is queued there → (the host tensor, a CUDA
    event recorded on that stream right after the copy); a CPU tensor is
    returned as it is, with no event. The host tensor holds t's values
    once the event has completed (or the stream has been synchronised);
    PyTorch's caching host allocator hands its pinned block out again
    only after the copy has completed."""
    if t.device.type == "cpu":
        return t, None
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return h, done


def cpu_settings():
    """What this process runs torch's CPU ops with: the intra-op thread
    count, OpenMP's wait policy as the environment gives it (the package
    sets PASSIVE unless the environment says otherwise; see its
    docstring) and the cores the OS reports."""
    return {"intra_op_threads": torch.get_num_threads(),
            "omp_wait_policy": os.environ.get("OMP_WAIT_POLICY"),
            "cpu_count": os.cpu_count()}
