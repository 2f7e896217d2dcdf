"""K6 `snp_trunk`: the SNP CNN's convolutional trunk as one hand-written
CUDA kernel, its plain PyTorch twin, and the packing of its weights.

The kernel (csrc/snp_trunk.cu, built into the library of
runtime/kernels.py) replaces no TPU kernel: the JAX package's trunk is
XLA convolutions (nanocaller_tpu/models/snp.py). It runs, in one launch,
what models/snp.py::_Trunk computes before fc1: conv1_1, conv1_2 and
conv1_3 with flax's symmetric SAME padding, bias and SELU, into 48
channels; conv2 and conv3, (2,3) with stride (1,2), each with bias and
SELU. It reads the (B, 5, 41, 5) NHWC pileup as it lies and writes fc1's
(B, 1,728) input in the flax (H, W, C) order, with no intermediate in
device memory. _Trunk takes it for inference on CUDA (grad mode off);
training and the CPU run the module's nn.Conv2d trunk.

The weights go to the kernel packed (pack_trunk_weights): each
convolution's weight as (kh, kw, ci, co) in CONVS order, then the five
biases in the same order, PACKED_SIZE floats. _Trunk.trunk_weights keeps
a packed copy a device and refreshes it in place when a weight changes.

`snp_trunk` takes its twin `snp_trunk_reference` only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Counter
(runtime/metrics.py): `k6.launches`, on CUDA only (snp_caller._CnnGraph
counts its captured launches at each replay).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime import kernels
from ..runtime.kernels import I, P
from ..runtime.metrics import count

# the trunk's convolutions in packing order: (name, weight shape (co, ci,
# kh, kw), padding, stride)
CONVS = (("conv1_1", (16, 5, 1, 5), (0, 2), 1),
         ("conv1_2", (16, 5, 5, 1), (2, 0), 1),
         ("conv1_3", (16, 5, 5, 5), (2, 2), 1),
         ("conv2", (32, 48, 2, 3), 0, (1, 2)),
         ("conv3", (64, 32, 2, 3), 0, (1, 2)))
PACKED_SIZE = sum(math.prod(shape) + shape[0] for _n, shape, _p, _s in CONVS)
FLAT = 3 * 9 * 64  # fc1's inputs a row
X_SHAPE = (5, 41, 5)


def pack_trunk_weights(convs):
    """The five convolutions' weights and biases, `convs` a list of
    (weight (co, ci, kh, kw), bias (co,)) in CONVS order → one float32
    vector of PACKED_SIZE on their device: each weight permuted to (kh,
    kw, ci, co), then the biases."""
    for (w, b), (name, shape, _p, _s) in zip(convs, CONVS):
        if tuple(w.shape) != shape or tuple(b.shape) != shape[:1]:
            raise ValueError("%s: weight %s, bias %s, expected %s" % (
                name, tuple(w.shape), tuple(b.shape), shape))
    return torch.cat([w.permute(2, 3, 1, 0).reshape(-1) for w, _b in convs]
                     + [b.reshape(-1) for _w, b in convs]).float()


def unpack_trunk_weights(packed):
    """pack_trunk_weights' inverse: the packed vector → [(weight (co, ci,
    kh, kw), bias (co,))] in CONVS order (views of it)."""
    if packed.shape != (PACKED_SIZE,):
        raise ValueError("packed weights must have shape (%d,), got %s"
                         % (PACKED_SIZE, tuple(packed.shape)))
    weights, at = [], 0
    for _name, (co, ci, kh, kw), _p, _s in CONVS:
        n = co * ci * kh * kw
        weights.append(packed[at:at + n].view(kh, kw, ci, co)
                       .permute(3, 2, 0, 1))
        at += n
    out = []
    for w, (_name, (co, *_r), _p, _s) in zip(weights, CONVS):
        out.append((w, packed[at:at + co]))
        at += co
    return out


def _check(x, packed):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("x must be a float32 tensor")
    if x.dim() != 4 or tuple(x.shape[1:]) != X_SHAPE:
        raise ValueError("x must have shape (B, 5, 41, 5), got %s"
                         % (tuple(x.shape),))
    if packed.dtype != torch.float32 or packed.shape != (PACKED_SIZE,):
        raise ValueError("packed weights must be float32 of shape (%d,)"
                         % PACKED_SIZE)
    for name, t in (("x", x), ("packed", packed)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if x.device.type not in ("cpu", "cuda") or packed.device != x.device:
        raise ValueError("x and packed must be on one CPU or CUDA device, "
                         "got %s and %s" % (x.device, packed.device))


def snp_trunk(x, packed):
    """x (B, 5, 41, 5) float32 NHWC, packed (PACKED_SIZE,) float32
    (pack_trunk_weights) → (B, 1728) float32: the trunk's conv3 output
    after bias and SELU, flattened in (H, W, C) order. On CUDA one K6
    launch on the current stream, counted in `k6.launches`."""
    _check(x, packed)
    if x.device.type == "cpu":
        return snp_trunk_reference(x, packed)
    B = x.shape[0]
    out = torch.empty((B, FLAT), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    # x, packed weights, out, B and the stream
    launch = kernels.launch_fn("snp_trunk_launch", [P, P, P, I, P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), packed.data_ptr(), out.data_ptr(), B,
                    stream)
    if rc != 0:
        raise RuntimeError("snp_trunk launch failed: cudaError %d" % rc)
    count("k6.launches")
    return out


def snp_trunk_reference(x, packed):
    """Plain PyTorch twin of K6, on any device: the packed weights
    unpacked, then _Trunk's convolutions (F.conv2d in NCHW), SELUs and
    concat, and the flatten in (H, W, C) order. Same inputs and output
    as snp_trunk."""
    convs = [(w, b, pad, stride) for (w, b), (_n, _s, pad, stride)
             in zip(unpack_trunk_weights(packed), CONVS)]

    def conv(m, i):
        w, b, pad, stride = convs[i]
        return F.selu(F.conv2d(m, w, b, stride=stride, padding=pad))

    m = x.permute(0, 3, 1, 2)
    m = conv(conv(torch.cat([conv(m, 0), conv(m, 1), conv(m, 2)], dim=1),
                  3), 4)
    return m.permute(0, 2, 3, 1).reshape(m.shape[0], FLAT)
