"""K5 `snp_dense_pileup`: the dense SNP path's pileup assembly, its plain
PyTorch twin, and its launch counter (`k5.launches`, runtime/metrics.py).

The hand-written CUDA kernel (csrc/snp_dense_pileup.cu, built with the
other kernels into the library of runtime/kernels.py) replaces the
assembly of nanocaller_tpu/snp_caller.py::_snp_forward_dense up to the
CNN: from a dense SnpBatch's per-candidate (R, 41) read codes to the
(B, 5, 41, 5) float32 NHWC tensor the SNP CNN takes, with K3's
epilogue, so that the x of a candidate is the same bit for bit whichever
of the three SNP paths built it.

`snp_dense_pileup` takes its twin `snp_dense_pileup_reference` only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from ..runtime.kernels import I, P
from ..runtime.metrics import count
from .snp_features import CENTER, WIDTH

# rows a step of the twin: bounds its (rows, R, 41, 5) one-hot
_TWIN_ROWS = 1024


def _check_inputs(codes, read_mask, col_ref, col_valid, center_ref, norm):
    if not isinstance(codes, torch.Tensor) or codes.dim() != 3 \
            or codes.shape[2] != WIDTH:
        raise ValueError("codes must be a (B, R, %d) tensor" % WIDTH)
    B, R = codes.shape[:2]
    dev = codes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("codes must be a CPU or CUDA tensor")
    for name, t, dtypes, shape in (
            ("codes", codes, (torch.int8,), (B, R, WIDTH)),
            ("read_mask", read_mask, (torch.bool, torch.uint8), (B, R)),
            ("col_ref", col_ref, (torch.int8,), (B, WIDTH)),
            ("col_valid", col_valid, (torch.bool, torch.uint8), (B, WIDTH)),
            ("center_ref", center_ref, (torch.int8,), (B,)),
            ("norm", norm, (torch.float32,), (B,))):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a tensor" % name)
        if t.dtype not in dtypes:
            raise TypeError("%s must be %s, got %s"
                            % (name, " or ".join(map(str, dtypes)), t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != dev:
            raise ValueError("%s is on %s, expected %s" % (name, t.device,
                                                             dev))
    return B, R


def snp_dense_pileup(codes, read_mask, col_ref, col_valid, center_ref, norm):
    """Pileups of B candidates from their dense read codes.

    codes (B, R, 41) int8 (0-3 a base, 4 none); read_mask (B, R) bool or
    uint8; col_ref (B, 41) int8 (4 at a padding column); col_valid
    (B, 41) bool or uint8; center_ref (B,) int8; norm (B,) float32
    coverage scale.
    → (x, ref): x (B, 5, 41, 5) float32, NHWC: row 0 the columns' ref
    one-hot, rows 1-4 the signed, scaled counts of the masked reads with
    centre base A/G/T/C and the ref channel; ref (B, 4) float32 the
    one-hot of center_ref (all zero for N)."""
    B, R = _check_inputs(codes, read_mask, col_ref, col_valid, center_ref,
                         norm)
    if codes.device.type == "cpu":
        return snp_dense_pileup_reference(codes, read_mask, col_ref,
                                          col_valid, center_ref, norm)
    dev = codes.device
    x = torch.empty((B, 5, WIDTH, 5), dtype=torch.float32, device=dev)
    ref = torch.empty((B, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return x, ref
    # codes, mask, col_ref, col_valid, center_ref, norm, B R, the two
    # outputs and the stream
    launch = kernels.launch_fn("snp_dense_pileup_launch",
                               [P] * 6 + [I, I] + [P] * 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            codes.data_ptr(), read_mask.data_ptr(), col_ref.data_ptr(),
            col_valid.data_ptr(), center_ref.data_ptr(), norm.data_ptr(), B,
            R, x.data_ptr(), ref.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("snp_dense_pileup launch failed: cudaError %d"
                           % rc)
    count("k5.launches")
    return x, ref


def snp_dense_pileup_reference(codes, read_mask, col_ref, col_valid,
                               center_ref, norm):
    """Plain PyTorch twin of K5: _snp_forward_dense's assembly (one-hot
    centre groups, a one-hot einsum over the reads, the ref channel, the
    flip, the coverage scale on rows 1-4 channels 0-3), _TWIN_ROWS rows a
    step. Same inputs and outputs as snp_dense_pileup, on any device."""
    one_hot = torch.nn.functional.one_hot
    xs = []
    for lo in range(0, codes.shape[0], _TWIN_ROWS):
        sl = slice(lo, lo + _TWIN_ROWS)
        c = codes[sl].long()
        grp = one_hot(c[:, :, CENTER], 5)[..., :4].float() \
            * read_mask[sl, :, None].float()
        oh = one_hot(c, 5).float()  # (b, R, 41, 5)
        mat = torch.einsum("brg,brwc->bgwc", grp, oh)[..., :4]
        ref_eq = one_hot(center_ref[sl].long(), 5)[:, :4].float()
        ch4 = ref_eq[:, :, None] * col_valid[sl, None, :].float()
        mat = torch.cat([mat, ch4[..., None]], dim=-1)  # (b, 4, 41, 5)
        total_ref = one_hot(col_ref[sl].long(), 5).float()
        total_ref[..., 4] = 0.0
        flip = 1.0 - 2.0 * total_ref
        x = torch.cat([total_ref[:, None], mat * flip[:, None]], dim=1)
        x[:, 1:, :, :4] *= norm[sl, None, None, None]
        xs.append(x)
    ref = one_hot(center_ref.long(), 5)[:, :4].float()
    if not xs:
        return torch.zeros((0, 5, WIDTH, 5), device=codes.device), ref
    return torch.cat(xs), ref
