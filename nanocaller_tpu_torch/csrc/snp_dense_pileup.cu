// K5 snp_dense_pileup: the pileup of the dense SNP path, from the
// candidates' (R, 41) read-code matrices to the tensor the SNP CNN takes.
//
// Replaces the XLA-jitted assembly of the JAX package's dense oracle path
// (there was no Pallas kernel here), nanocaller_tpu/snp_caller.py::
// _snp_forward_dense (:79-105, reached through _snp_forward_packed, :61):
// the centre-base groups, the one-hot einsum over the reads, the ref
// channel, the flip and the coverage scale. Its plain twin is
// nanocaller_tpu_torch/pileup/snp_dense.py::snp_dense_pileup_reference.
//
// Inputs, one row a candidate: codes (B, R, 41) int8 (0-3 a base, 4 none),
// read_mask (B, R) bytes 0/1, col_ref (B, 41) int8 (4 at a padding
// column), col_valid (B, 41) bytes 0/1, center_ref (B,) int8, norm (B,)
// float32.
// Outputs: x (B, 5, 41, 5) float32, NHWC, laid out exactly as K3
// (snp_pileup.cu) writes it: row 0 the column's ref one-hot (channel 4
// zero); rows 1-4, for the masked reads whose centre code is g = 0-3,
// count[g][w][c] * flip * norm for c < 4 (flip = -1 where c is the
// column's ref base) and (centre ref == g) * (column valid) for c = 4.
// ref (B, 4) float32, the one-hot of center_ref (all zero for 4).
//
// The counts are exact integers and the epilogue is K3's, one float32
// rounding of count * flip * norm, so the x this kernel builds from a
// dense batch equals, bit for bit, the x K3 builds for the same
// candidates from a group or chunk wire, and equals its twin.
//
// What bounds it on an H100: bytes. A row reads R * 41 code bytes and
// writes 4,100 output bytes; the work is one compare and at most one
// shared-memory add a code (int32 operations far under the card's rate).
//
// Design: one CTA of 128 threads a row. The row's reads go in tiles of
// 128: each thread loads one read's centre code (4 where the read is
// masked off) into shared memory, then the threads take the tile's
// (read, column) cells in order, so that a warp's 32 byte loads are
// consecutive bytes of the row and its shared-memory adds fall on
// different counters (consecutive columns of one read). The counts
// [4][41][4] live in shared memory, as in K3.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 41;
constexpr int CENTER = 20;
constexpr int THREADS = 128;
constexpr int OUT_ROW = 5 * W * 5;

__global__ void __launch_bounds__(THREADS)
snp_dense_pileup_kernel(const int8_t* __restrict__ codes,
                        const uint8_t* __restrict__ mask,
                        const int8_t* __restrict__ col_ref,
                        const uint8_t* __restrict__ col_valid,
                        const int8_t* __restrict__ center_ref,
                        const float* __restrict__ norm, int R,
                        float* __restrict__ out, float* __restrict__ ref_out) {
  __shared__ int cnt[4 * W * 4];  // [g][w][c], c < 4
  __shared__ int8_t g_of[THREADS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < 4 * W * 4; i += THREADS) cnt[i] = 0;
  const int8_t* row = codes + (size_t)b * R * W;
  const uint8_t* m = mask + (size_t)b * R;
  for (int r0 = 0; r0 < R; r0 += THREADS) {
    const int n = min(THREADS, R - r0);
    __syncthreads();  // the counters' zeroing, or the last tile's reads
    if (t < n) g_of[t] = m[r0 + t] ? row[(size_t)(r0 + t) * W + CENTER] : 4;
    __syncthreads();
    const int8_t* tile = row + (size_t)r0 * W;
    for (int e = t; e < n * W; e += THREADS) {
      const int r = e / W;
      const int g = g_of[r];
      if (g >= 0 && g < 4) {
        const int w = e - r * W;
        const int c = tile[e];
        if (c >= 0 && c < 4) atomicAdd(&cnt[(g * W + w) * 4 + c], 1);
      }
    }
  }
  __syncthreads();

  const int cref = center_ref[b];
  const float nm = norm[b];
  if (t < 4) ref_out[(size_t)b * 4 + t] = cref == t ? 1.f : 0.f;
  // one (column, channel) pair a thread, its five rows (K3's epilogue)
  float* o = out + (size_t)b * OUT_ROW;
  for (int p = t; p < W * 5; p += THREADS) {
    const int col = p / 5;
    const int c = p - col * 5;
    const int cr = col_ref[(size_t)b * W + col];
    o[p] = (c < 4 && cr == c) ? 1.f : 0.f;
    if (c < 4) {
      const float f = cr == c ? -1.f : 1.f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        o[(g + 1) * W * 5 + p] =
            __fmul_rn(__fmul_rn((float)cnt[(g * W + col) * 4 + c], f), nm);
    } else {
      const bool valid = col_valid[(size_t)b * W + col] != 0;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        o[(g + 1) * W * 5 + p] = (cref == g && valid) ? 1.f : 0.f;
    }
  }
}

}  // namespace

extern "C" int snp_dense_pileup_launch(const int8_t* codes,
                                       const uint8_t* mask,
                                       const int8_t* col_ref,
                                       const uint8_t* col_valid,
                                       const int8_t* center_ref,
                                       const float* norm, int B, int R,
                                       float* out, float* ref, void* stream) {
  snp_dense_pileup_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      codes, mask, col_ref, col_valid, center_ref, norm, R, out, ref);
  return (int)cudaGetLastError();
}
