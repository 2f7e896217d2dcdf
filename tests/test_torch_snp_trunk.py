"""K6 snp_trunk on the CPU: its plain twin from the packed weights against
the SNP models' nn.Conv2d trunk (every pack's shapes: ONT-HG002,
CCS-HG002 and haploid), the packed layout, the packed weights' in-place
refresh, the wrapper's refusals, and k6.launches left at 0 by CPU and
grad-enabled calls. The kernel's source itself, compiled for the host by
g++ (one thread a CUDA thread, a barrier for __syncthreads), against the
twin at B = 1, 3 and 17 (rows past B, a last CTA part full). The kernel
on the card: tests/test_torch_gpu.py."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nanocaller_tpu_torch.models import (HaploidSNPModel, SNPModel,
                                         load_model,
                                         torch_state_dict_from_params)
from nanocaller_tpu_torch.models import snp_trunk as K6
from nanocaller_tpu_torch.runtime.metrics import counters, reset_counters

from torch_threads import _torch_threads  # noqa: F401 (autouse)

PACKS = [("ONT-HG002", SNPModel), ("CCS-HG002", SNPModel),
         ("haploid", HaploidSNPModel)]


def _model(name, cls):
    params, _ = load_model("snp", name)
    m = cls()
    m.load_state_dict(torch_state_dict_from_params(params))
    return m.eval()


def _pileups(B, seed):
    """Pileup-like rows: signed, scaled counts and a ref one-hot row."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-30, 31, (B, 5, 41, 5)) * 0.8).astype(np.float32)
    x[:, 0] = rng.integers(0, 2, (B, 41, 5))
    return torch.from_numpy(x)


@pytest.mark.parametrize("name,cls", PACKS)
@pytest.mark.parametrize("B", [1, 17, 300])
def test_reference_matches_module_trunk(name, cls, B):
    """The twin from the packed weights against the module's nn.Conv2d
    trunk, which the CPU runs; its output goes to fc1 as the module's
    does (the flax (H, W, C) order)."""
    m = _model(name, cls)
    x = _pileups(B, B)
    got = K6.snp_trunk_reference(x, m.trunk_weights())
    with torch.no_grad():
        flat = m.conv_trunk(x)
        assert got.shape == (B, K6.FLAT) == flat.shape
        assert float((got - flat).abs().max()) <= 1e-6
        assert float((torch.nn.functional.selu(m.fc1(got)) - m.trunk(x))
                     .abs().max()) <= 1e-6


def test_packed_layout_round_trips():
    m = _model("ONT-HG002", SNPModel)
    packed = m.trunk_weights()
    assert packed.shape == (K6.PACKED_SIZE,) == (24448,)
    convs = [m.conv1_1, m.conv1_2, m.conv1_3, m.conv2, m.conv3]
    for (w, b), conv in zip(K6.unpack_trunk_weights(packed), convs):
        assert torch.equal(w, conv.weight.detach())
        assert torch.equal(b, conv.bias.detach())
    # (kh, kw, ci, co) a weight, the biases after the weights: the offsets
    # the kernel reads
    at = 400 + 400 + 2000
    assert packed[at + ((1 * 3 + 2) * 48 + 40) * 32 + 7] == \
        m.conv2.weight[7, 40, 1, 2]
    at += 9216
    assert packed[at + ((0 * 3 + 1) * 32 + 5) * 64 + 63] == \
        m.conv3.weight[63, 5, 0, 1]
    assert packed[24304 + 16 + 3] == m.conv1_2.bias[3]
    assert packed[24384 + 64 - 1] == m.conv3.bias[63]
    with pytest.raises(ValueError, match="conv2"):
        K6.pack_trunk_weights([(c.weight, c.bias) for c in convs[:3]]
                              + [(m.conv3.weight, m.conv3.bias)] * 2)


def test_packed_weights_refresh_in_place():
    m = _model("ONT-HG002", SNPModel)
    packed = m.trunk_weights()
    ptr = packed.data_ptr()
    assert m.trunk_weights() is packed  # unchanged weights: no repack
    other = _model("CCS-HG002", SNPModel)
    m.load_state_dict(other.state_dict())
    with torch.inference_mode():
        again = m.trunk_weights()
    assert again.data_ptr() == ptr and again is packed
    assert torch.equal(packed, other.trunk_weights())
    with torch.no_grad():
        m.conv2.weight.add_(0.5)
        m.conv1_1.bias.mul_(2)
    assert m.trunk_weights().data_ptr() == ptr
    assert torch.equal(packed, K6.pack_trunk_weights(
        [(c.weight.detach(), c.bias.detach()) for c in (
            m.conv1_1, m.conv1_2, m.conv1_3, m.conv2, m.conv3)]))
    # the packed tensor is a normal one, refreshable outside
    # inference_mode after an inference_mode pack
    fresh = _model("haploid", HaploidSNPModel)
    with torch.inference_mode():
        p0 = fresh.trunk_weights()
    assert not p0.is_inference()
    with torch.no_grad():
        fresh.conv3.bias.add_(1)
    assert fresh.trunk_weights() is p0
    assert torch.equal(p0[-64:], fresh.conv3.bias.detach())


def test_cpu_and_grad_calls_launch_nothing():
    reset_counters("k6.")
    m = _model("ONT-HG002", SNPModel)
    x = _pileups(5, 0)
    ref = torch.eye(4)[torch.tensor([0, 1, 2, 3, 0])]
    with torch.inference_mode():
        m(x, ref)
    loss = m(x, ref, return_logits=True)[0].sum()
    loss.backward()
    K6.snp_trunk(x, m.trunk_weights())
    assert counters("k6.") == {}


def test_wrapper_refuses():
    m = _model("ONT-HG002", SNPModel)
    packed = m.trunk_weights()
    x = _pileups(3, 1)
    with pytest.raises(TypeError):
        K6.snp_trunk(x.double(), packed)
    with pytest.raises(ValueError, match="shape"):
        K6.snp_trunk(x[:, :, :40], packed)
    with pytest.raises(ValueError, match="contiguous"):
        K6.snp_trunk(x.transpose(1, 2).contiguous().transpose(1, 2), packed)
    with pytest.raises(ValueError, match="packed"):
        K6.snp_trunk(x, packed[:-4])
    assert K6.snp_trunk(x[:0], packed).shape == (0, K6.FLAT)


# -- the kernel's source on the host ------------------------------------------

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 __ldg(const float4* p) { return *p; }
inline float __ldg(const float* p) { return *p; }
struct Dim3 { unsigned x, y, z; };
extern thread_local Dim3 threadIdx;
extern Dim3 blockIdx;
extern std::barrier<>* emu_bar;
extern float* emu_smem;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
"""

HARNESS = r"""
#include <thread>
#include <vector>
#include "kernel.inc"
thread_local Dim3 threadIdx;
Dim3 blockIdx;
std::barrier<>* emu_bar;
float* emu_smem;
extern "C" void emulate(const float* x, const float* w, float* out, int B) {
  std::vector<float> sm(SMEM / sizeof(float), 12345.f);
  emu_smem = sm.data();
  for (int b = 0; b < (B + TB - 1) / TB; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(THREADS);
    emu_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < THREADS; ++t)
      ts.emplace_back([=] { threadIdx.x = t; snp_trunk_kernel(x, w, out, B); });
    for (auto& th : ts) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/snp_trunk.cu's kernel (the text before its launch function)
    built by g++ with SHIM, one std::thread a CUDA thread."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("k6_host")
    src = open(os.path.join(os.path.dirname(K6.__file__), "..", "csrc",
                            "snp_trunk.cu")).read()
    body = src[:src.index('extern "C"')]
    body = body.replace("extern __shared__ float smem[];",
                        "float* smem = emu_smem;")
    body = body.replace("namespace {", "").replace("}  // namespace", "")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "kernel.inc").write_text(body)
    (tmp / "harness.cpp").write_text(HARNESS)
    lib = tmp / "libk6host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-I",
                    str(tmp), "-o", str(lib), str(tmp / "harness.cpp"),
                    "-pthread"], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).emulate
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


@pytest.mark.parametrize("name,cls", PACKS[::2])
@pytest.mark.parametrize("B", [1, 3, 17])
def test_kernel_source_on_host(host_kernel, name, cls, B):
    """The kernel's own indexing, sums and epilogues against the twin:
    within 2e-6 of the largest output on pileup-like rows, whose outputs
    reach ~100 (float32 sums in another order; the twin's own distance
    from a float64 trunk is ~6e-7 of it)."""
    m = _model(name, cls)
    packed = m.trunk_weights()
    x = _pileups(B, 10 + B)
    out = torch.full((B, K6.FLAT), float("nan"))
    host_kernel(x.data_ptr(), packed.data_ptr(), out.data_ptr(), B)
    want = K6.snp_trunk_reference(x, packed)
    assert not out.isnan().any()
    assert float((out - want).abs().max()) <= 2e-6 * float(want.abs().max())
