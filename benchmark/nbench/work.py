"""What the work needs, counted from shapes and inputs, and the chip's
peaks it is held against.

- `cnn_flops(spec)`: floating-point operations of one row through a CNN
  whose layers a configuration file lists (`snp_cnn`): a
  convolution 2 * out * H_out * W_out * in * kh * kw, a dense layer
  2 * in * out; activations, softmaxes and biases are not counted.
- `k3_work(...)`: the bytes and int32 operations one launch of the SNP
  pileup kernel K3 needs, as the port's chip_smoke.py counted them
  (frozen here): each input byte read once and each output byte written
  once; 17 operations a cell code the pileup needs (the centre code of
  every covering read of a row, then the other valid columns' codes of
  each read whose centre code counts), 3 a counted cell, and the
  neighbour selection's binary searches, band arithmetic and column
  indices.
- `PEAKS`: published peaks of each device kind, dense rates without
  sparsity; `bound_s` is the least time the chip could take.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet at 700 W: HBM3 3.35 TB/s, float32 outside
# the tensor cores 67 TFLOP/s, TF32 495 TFLOP/s; int32 operations 132 SMs
# x 64 lanes x 1.98 GHz
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "int32_ops_per_s": 132 * 64 * 1.98e9,
                              "fp32_flops_per_s": 67e12,
                              "tf32_flops_per_s": 495e12},
}

K3_OPS_PER_CODE = 17
K3_OPS_PER_COUNT = 3
K3_OPS_PER_SEARCH_STEP = 5
K3_OPS_PER_BAND = 12
K3_OPS_PER_COLUMN = 3
WIDTH = 41
MAX_BANDS = 7


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def layer_flops(layer):
    if layer["kind"] == "dense":
        return 2 * layer["in"] * layer["out"]
    (H, W), (kh, kw) = layer["in_hw"], layer["kernel"]
    (sh, sw), (ph, pw) = layer["stride"], layer["padding"]
    return 2 * layer["out"] * _out(H, kh, sh, ph) * _out(W, kw, sw, pw) \
        * layer["in"] * kh * kw


def cnn_flops(spec):
    """FLOPs of one row through every layer of `spec["layers"]`."""
    return sum(layer_flops(layer) for layer in spec["layers"])


def weight_shapes(spec):
    """{layer: kernel shape} as the flax packs store them: HWIO for a
    convolution, (in, out) for a dense layer."""
    return {layer["name"]: ((*layer["kernel"], layer["in"], layer["out"])
                            if layer["kind"] == "conv"
                            else (layer["in"], layer["out"]))
            for layer in spec["layers"]}


def k3_bytes(dims, B, deep_width):
    """Bytes of one K3 launch's inputs and outputs. dims: the payload's N
    reads, S sites, T minor-bit bytes, E exceptions, H holes, M
    neighbours; B rows; deep_width the sampled ids a deep row (0 for a
    normal cohort)."""
    N, S, T, E, H, M = (dims[k] for k in "NSTEHM")
    wire = (4 * N * 4            # read_lo, read_hi, span_start, order
            + 3 * (S + 1)        # site_ref, site_major, site_minor
            + T                  # minor_bits
            + 2 * 4 * (S + 2)    # exc_indptr, hole_indptr
            + 5 * E + 4 * H      # exc_rid + exc_code, hole_rid
            + 2 * 4 * (S + 1)    # win_lo, win_hi
            + 2 * 4 * M          # nbr_pos, nbr_union
            + 2 * MAX_BANDS * 4 * 4)
    rows = 5 * 4 * B + (4 * B * deep_width + 4 * B if deep_width else 0)
    outs = B * 5 * WIDTH * 5 * 4 + B * WIDTH * 4 + B * 4 * 4
    return wire + rows + outs


def k3_ops(need, B, n_bands, M):
    """int32 operations one launch needs, from the reference's counts
    (reference.snp_pileup's `need`) of its B rows; n_bands the bands of
    the schedule with k > 0, M the neighbour list's length."""
    steps = math.ceil(math.log2(M + 1))
    selection = B * n_bands * (2 * steps * K3_OPS_PER_SEARCH_STEP
                               + K3_OPS_PER_BAND) \
        + need["selected_columns"] * K3_OPS_PER_COLUMN
    return need["cell_codes"] * K3_OPS_PER_CODE \
        + need["counted_cells"] * K3_OPS_PER_COUNT + selection


def bound_s(peaks, nbytes=0, ops=0, flops=0):
    """(least seconds, what bounds it: "bytes", "operations" or "flops")."""
    t = {"bytes": nbytes / peaks["bytes_per_s"],
         "operations": ops / peaks["int32_ops_per_s"],
         "flops": flops / peaks["fp32_flops_per_s"]}
    by = max(t, key=t.get)
    return t[by], by
