// K2 nw_walk: batched traceback walk over K1's traceback matrices.
//
// Replaces: nanocaller_tpu/align/batch_nw.py::_walk_device (an XLA
// lax.scan of T steps vectorised over the batch). Same state machine as
// batch_nw.py::_traceback_matrix, run step for step as _walk_device runs
// it, so the (B, T) int8 op stream (0 none, 1 diag, 2 ins, 3 del, in
// end-to-start order, T >= 2(Q+R)+2) is identical, zero steps included.
// Its plain twin is nanocaller_tpu_torch/align/nw_kernels.py::
// nw_walk_reference.
//
// What bounds it on an H100: latency, not bytes or operations. Each
// pair's walk is a serial chain of up to T dependent steps, each reading
// the traceback cell its previous step chose. Read from device memory,
// every step costs one memory latency.
//
// Design: one warp per pair, 4 pairs per CTA at B >= 4 x SMs, else 1.
// The walk only ever decreases i and j, so the warp loads into shared
// memory the TILE x TILE block of the traceback whose bottom-right corner
// is the current (i, j), 16 rows' loads in flight at a time, each row a
// coalesced run, and lane 0 walks inside it from shared memory until the
// walk leaves it; then the warp loads the next tile. Each tile serves at
// least TILE moving steps, so a step's dependent load costs a
// shared-memory latency instead of a device-memory one. Lane 0 writes the
// op codes into a shared buffer of OPB bytes, which the warp stores to the
// pair's op row with coalesced stores whenever it fills and at the end;
// the warp then zero-fills the rest of the row. The wrapper checks
// 0 <= qlen <= Q and 0 <= rlen <= R on the host and copies the lengths
// from pinned memory, so no call waits for the card; a walk that would
// leave the matrix (possible only for a traceback K1 did not write) stops
// there.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 78 registers, no spills.
//
// Read it as a serial chain: the time over the longest walk's steps. On
// an H100 (chip_smoke.py phase 3, PERF.md) the longest walks take 290
// steps at (192,192) B=1024, 309 at the main path's (192,192) B=2230,
// 203 at (64,192) B=64 and 780 at (512,512) B=1024, which is 130-200 ns
// a step, launch and the lengths copy included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 64;   // tile rows and columns
constexpr int OPB = 1024;  // op bytes staged per store
constexpr int PER_WARP = TILE * TILE + OPB;

__global__ void __launch_bounds__(128)
nw_walk_kernel(const uint8_t* __restrict__ tb,
               const int32_t* __restrict__ lens, int8_t* __restrict__ ops,
               int B, int Q, int R, int T) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int W = R + 1;
  const uint8_t* t = tb + (size_t)b * (Q + 1) * W;
  int8_t* out = ops + (size_t)b * T;
  uint8_t* tile = smem + warp * PER_WARP;
  int8_t* obuf = reinterpret_cast<int8_t*>(tile + TILE * TILE);

  int i = lens[b];
  int j = lens[B + b];
  int state = 0;
  int s = 0;   // steps taken
  int s0 = 0;  // step of obuf[0]
  bool more = (i > 0 || j > 0) && s < T;
  while (more) {
    const int ilo = max(0, i - TILE + 1);
    const int jlo = max(0, j - TILE + 1);
    const int nr = i - ilo + 1;
    const int nc = j - jlo + 1;
    // 16 rows a batch: all their loads in flight before the first store
    for (int r0 = 0; r0 < nr; r0 += 16) {
      uint8_t a[16], c[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const uint8_t* src = t + (size_t)(ilo + r0 + u) * W + jlo;
        const bool row = r0 + u < nr;
        a[u] = (row && lane < nc) ? src[lane] : 0;
        c[u] = (row && lane + 32 < nc) ? src[lane + 32] : 0;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        tile[(r0 + u) * TILE + lane] = a[u];
        tile[(r0 + u) * TILE + lane + 32] = c[u];
      }
    }
    __syncwarp();
    if (lane == 0) {
      int idx = (i - ilo) * TILE + (j - jlo);
      while (s < T && (i > 0 || j > 0) && i >= ilo && j >= jlo &&
             s - s0 < OPB) {
        const int cell = tile[idx];
        int emit = 0;
        if (state == 0) {
          if (j == 0) {
            state = 1;
          } else if (i == 0) {
            state = 2;
          } else {
            const int src = cell & 3;
            if (src == 0) {
              emit = 1;
              --i;
              --j;
              idx -= TILE + 1;
            } else {
              state = src;
            }
          }
        } else if (state == 1) {
          emit = 2;
          --i;
          idx -= TILE;
          if (!(cell & 4)) state = 0;
        } else if (state == 2) {
          emit = 3;
          --j;
          idx -= 1;
          if (!(cell & 8)) state = 0;
        }  // a source code 3 (never written by K1) stalls, as in JAX
        obuf[s - s0] = (int8_t)emit;
        ++s;
      }
    }
    __syncwarp();
    i = __shfl_sync(FULL, i, 0);
    j = __shfl_sync(FULL, j, 0);
    state = __shfl_sync(FULL, state, 0);
    s = __shfl_sync(FULL, s, 0);
    more = (i > 0 || j > 0) && s < T && i >= 0 && j >= 0;
    if (s - s0 == OPB || !more) {
      for (int k = lane; k < s - s0; k += 32) out[s0 + k] = obuf[k];
      s0 = s;
      __syncwarp();
    }
  }
  for (int k = s + lane; k < T; k += 32) out[k] = 0;
}

}  // namespace

extern "C" int nw_walk_launch(const uint8_t* tb, const int32_t* lens,
                              int8_t* ops, int B, int Q, int R, int T,
                              void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int pairs = (B >= 4 * sms) ? 4 : 1;
  nw_walk_kernel<<<(B + pairs - 1) / pairs, 32 * pairs,
                   (size_t)pairs * PER_WARP, (cudaStream_t)stream>>>(
      tb, lens, ops, B, Q, R, T);
  return (int)cudaGetLastError();
}
