"""In-process data parallelism for inference: the devices, the per-device
batch and the split of a batch's rows over replicas.

The inference half of nanocaller_tpu/runtime/sharding.py (the mesh,
the tensor-parallel layout and the sharded train step come with
training, ROADMAP A7). Candidate batches split over the process's cards
while the small CNNs are replicated — the multi-card analog of the
reference's N CPU inference workers (snpCaller.py:213-245).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .device import resolve_device


def inference_devices(device="cuda"):
    """The process's cards for in-process data parallelism; None when
    there are fewer than two (the counterpart of inference_mesh).

    Used by SnpCallerState / IndelCallerState when `devices="auto"`. A
    bare "cuda" takes every visible card; an explicit "cuda:k" (what
    each process of a multi-process run gets, caller.run) and the CPU
    are one device: under multi-process runs each process holds its own
    region shard on its own card, and in-process DP over local cards
    composes with that sharding."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def dp_scale(batch_size, devices):
    """Global batch for a PER-DEVICE batch size.

    cfg.batch_size is the per-device batch: with n replicas the global
    batch is n× that, so every replica runs the same (batch_size, ...)
    forward a single device would — which makes multi-device inference
    bit-identical to single-device by construction
    (tests/test_torch_distributed.py pins this down)."""
    return batch_size * len(devices) if devices else batch_size


def dp_rows(n_rows, batch_size, devices):
    """Each replica's rows of an n_rows batch, in order.

    The rows go in global batches of dp_scale(batch_size, devices) rows,
    each cut into consecutive batch_size slices, slice j to replica j.
    A replica's rows are thus whole batch_size slices of the
    single-device run (the last one may be short), and its forward in
    batch_size rows computes exactly what one device computes on them.
    One device: [arange(n_rows)]."""
    n = len(devices) if devices else 1
    slot = (np.arange(n_rows) % dp_scale(batch_size, devices)) // batch_size
    return [np.flatnonzero(slot == j) for j in range(n)]


def replicas(device, devices, *modules):
    """[(its device, *modules)] of each replica, for modules that lie on
    `device`.

    devices: the replicas' devices ("auto": inference_devices(device);
    None: `device` alone). A module goes to each replica as itself where
    it already lies and as a copy elsewhere (weights replicated)."""
    if devices == "auto":
        devices = inference_devices(device)
    if not devices:
        return [(device, *modules)]
    devs = [resolve_device(d) for d in devices]
    homes = [next(m.parameters()).device for m in modules]
    return [(d, *(m if d == home else copy.deepcopy(m).to(d)
                  for m, home in zip(modules, homes))) for d in devs]
