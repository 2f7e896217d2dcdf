// K1 nw_tb: batched affine-gap (Gotoh) Needleman-Wunsch traceback DP.
//
// Replaces: nanocaller_tpu/align/pallas_nw.py::batch_nw_tb_pallas (the
// Pallas kernel _nw_row_kernel with _shift_right/_prefix_max). Output is
// bit-identical to nanocaller_tpu/align/batch_nw.py::_batch_nw's tb:
// (B, Q+1, R+1) uint8, bits 0-1 the H source (0 diag, 1 V, 2 Z), bit 2
// V-extend, bit 3 Z-extend. Its plain twin is
// nanocaller_tpu_torch/align/nw_kernels.py::nw_tb_reference.
//
// What bounds it on an H100: integer operations. Every cell needs the
// same 17 int32 operations (chip_smoke.py lists them) and writes one
// byte, so the int32 issue rate bounds it before the store stream does.
// A pair is a serial chain: row i needs row i-1, and within a row the
// horizontal gap Z[j] needs Z[j-1]. At the main path's small launches
// (56-120 pairs on 132 SMs) the latency of that chain, not throughput,
// is the limit.
//
// Design: a warp per pair, columns in registers, no block barrier.
// Common to both kernels below:
// - Column 0 is the boundary in closed form: H[i][0] = -(go+(i-1)ge),
//   byte 1|4 (1 on row 1).
// - Columns 1..R are cut into strips of K columns (K a template
//   parameter); lane v owns columns 1+vK .. (v+1)K and keeps their H, V
//   and ref codes in registers. Columns past R are computed but never
//   stored: every dependence points right or down, away from them.
// - The query codes come 32 at a time, one per lane, the next 32 loaded
//   a window ahead, and reach the lanes by __shfl_sync.
// - Every comparison is strict, exactly as in the reference
//   (Vnew > diag, Z > G, V-ge > H-go, z_ext): ties decide the traceback.
//   No DPX intrinsic: on sm_90 the fused max-and-compare __vibmax_s32
//   compiles to the same compare and two selects, and a wavefront built
//   on it ran slower on the main path's small launches.
// - Stores: a pair's traceback is one contiguous byte run. A pair stages
//   blocks of 8 rows in shared memory, each at the same offset mod 16 as
//   its place in device memory, and writes a finished block with 16-byte
//   stores between an unaligned head and tail.
//
// nw_tb_wave_kernel<K> (Q >= 96): a skewed wavefront over the 32
// lanes. At step s, lane v computes row i = s - v of its strip, so
// Q + (lanes in use - 1) steps cover the matrix. The row's horizontal gap
// runs left to right as Z[j] = max(Z[j-1] - ge, G[j-1] - go), z_ext[j] =
// (Z[j-1] - ge) > (G[j-1] - go), Z[1] = H[i][0] - go: the reference's
// prefix max M over c = G - go + j*ge rewritten exactly, since
// Z[j] = M[j-1] - (j-1)ge and M[j-2] > c[j-1] <=> Z[j-1] - ge > G[j-1] - go
// in integers. Lane v-1 hands lane v, one step later, Z and z_ext at the
// strip's first column, H[i][j0-1] (lane v's diag input a row later) and
// the query code: four __shfl_up_sync a step and no scan. 4 pairs per
// CTA at B >= 4 x SMs (fewer where the staging would pass 48 KB), else 1.
//
// nw_tb_rows_kernel<K> (Q < 96): the wavefront needs 31 steps before
// its last lane starts, which short queries cannot repay. One
// warp per pair walks the rows in order instead; each row's Z comes from
// an inclusive prefix max over the 32 lanes (a lane-local running max, a
// 5-step __shfl_up_sync scan of the lane totals with c[0] = H[i][0] - go
// folded into lane 0, one exclusive shift), then Z[j] = M[j-1] - (j-1)ge
// and z_ext[j] = M[j-2] > c[j-1]. 4 pairs per CTA at B >= 4 x SMs, else 1.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): wave<6> 96 registers, wave<16>
// 127, rows<6> 72 with 4 bytes of spills, rows<16> 167; no other spills
// but in the generic rows<32> (R > 512: 255 registers, 180 bytes) and
// wave<2> (8/40 bytes).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr unsigned FULL = 0xffffffffu;

// below this many query rows the wavefront's fill (31 steps before the
// last lane starts) costs more than the rows kernel's scan
constexpr int ROWS_BELOW_Q = 96;

// staged blocks of 8 rows: the 32 rows in flight span at most 5 blocks
constexpr int REGIONS = 5;

__device__ __forceinline__ void store_block(uint8_t* g, const uint8_t* s,
                                            int n, int lane) {
  // g and s are equal mod 16
  int head = (int)((16 - ((uintptr_t)g & 15)) & 15);
  if (head > n) head = n;
  if (lane < head) g[lane] = s[lane];
  const int nv = (n - head) >> 4;
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  for (int v = lane; v < nv; v += 32) gv[v] = sv[v];
  const int done = head + (nv << 4);
  if (lane < n - done) g[done + lane] = s[done + lane];
}

// K columns per lane
template <int K>
__global__ void __launch_bounds__(128)
nw_tb_wave_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                  uint8_t* __restrict__ tb, int B, int Q, int R, int match,
                  int mismatch, int go, int ge, int region_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int v = threadIdx.x & 31;  // lane
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps only: no block barrier follows
  const int W = R + 1;
  const int8_t* qb = q + (size_t)b * Q;
  const int8_t* rb = r + (size_t)b * R;
  uint8_t* out = tb + (size_t)b * (Q + 1) * W;
  uint8_t* stage = smem + warp * REGIONS * region_bytes;
  const int last = (R - 1) / K;  // last lane with a live column
  const bool first = (v == 0);   // takes the column-0 boundary

  const int j0 = 1 + v * K;  // first column of this lane's strip
  int rc[K], H[K], V[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    rc[k] = (j <= R) ? (int)rb[j - 1] : 4;
    H[k] = -(go + (j - 1) * ge);  // row 0
    V[k] = NEG;
    if (j <= R)
      stage[((uintptr_t)out & 15) + j] = (uint8_t)(j == 1 ? 2 : (2 | 8));
  }
  if (first) stage[(uintptr_t)out & 15] = 0;
  int hdiag = first ? 0 : -(go + (j0 - 2) * ge);  // H[i-1][j0-1]
  // query codes 32 at a time, the next window loaded one window ahead
  auto qload = [&](int at) {
    const int c = (at + v < Q) ? (int)qb[at + v] : 4;
    return (c < 4) ? c : 1000;  // a code >= 4 never matches
  };
  int qreg = qload(0), qnext = qload(32);
  int qc = 1000, zout = 0, bout = 0, hout = 0;
  uint8_t* srow = stage + ((uintptr_t)out & 15);  // row i's staging
  int nf = 0;  // next block of 8 rows to store

  // step s: lane v computes row i = s - v from what lane v-1 sent at
  // step s-1 (Z[i][j0], z_ext[i][j0] << 3, H[i][j0-1], the query code);
  // EDGE steps mask the lanes whose row is outside 1..Q
  auto step = [&](int s, auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    if (((s - 1) & 31) == 0 && s > 1) {
      qreg = qnext;
      qnext = qload(s - 1 + 32);
    }
    const int qw = __shfl_sync(FULL, qreg, (s - 1) & 31);
    int qup = __shfl_up_sync(FULL, qc, 1);
    int zup = __shfl_up_sync(FULL, zout, 1);
    int bup = __shfl_up_sync(FULL, bout, 1);
    int hup = __shfl_up_sync(FULL, hout, 1);
    const int i = s - v;
    const bool act = !EDGE || (i >= 1 && i <= Q);
    const int h0i = -(go + (i - 1) * ge);
    qc = first ? qw : qup;
    int zc = first ? h0i - go : zup;  // Z[i][j], then Z[i][j+1]
    int zb = first ? 0 : bup;         // z_ext[i][j] << 3
    const int hin = first ? h0i : hup;
    if ((i & 7) == 0 || EDGE) {  // a new block of 8 rows
      const int blk = max(i, 0) >> 3;
      srow = stage + (blk % REGIONS) * region_bytes +
             ((uintptr_t)(out + (size_t)blk * 8 * W) & 15) +
             (max(i, 0) & 7) * W;
    } else {
      srow += W;
    }
    int hd = hdiag;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int hk = H[k];
      const int diag = hd + ((qc == rc[k]) ? match : mismatch);
      const int hg = hk - go;
      const int vg = V[k] - ge;
      const int vnew = max(hg, vg);
      const int G = max(diag, vnew);
      const int byte = ((zc > G) ? 2 : (vnew > diag ? 1 : 0)) |
                       (vg > hg ? 4 : 0) | zb;
      if (act) {
        H[k] = max(G, zc);
        V[k] = vnew;
        if (j0 + k <= R) srow[j0 + k] = (uint8_t)byte;
      }
      const int gopen = G - go;
      const int zext = zc - ge;
      zb = (zext > gopen) ? 8 : 0;  // z_ext[j+1], as its traceback bit
      zc = max(zext, gopen);        // Z[j+1]
      hd = hk;
    }
    if (first && act) srow[0] = (uint8_t)(i > 1 ? (1 | 4) : 1);
    zout = zc;
    bout = zb;
    hout = H[K - 1];
    if (act) hdiag = hin;
  };

  // lane `last` finished row d at step d + last: store the full blocks
  auto flush_to = [&](int d) {
    while (8 * nf + 7 <= d) {
      __syncwarp();
      store_block(out + (size_t)nf * 8 * W,
                  stage + (nf % REGIONS) * region_bytes +
                      ((uintptr_t)(out + (size_t)nf * 8 * W) & 15),
                  8 * W, v);
      __syncwarp();
      ++nf;
    }
  };

  int s = 1;
  for (; s <= last; ++s) step(s, std::true_type{});  // lanes starting
  // every live lane on a live row; narrow strips run groups of 8 steps,
  // each ending on a block (wider strips lose more to the code size)
  if constexpr (K <= 6) {
    for (; s <= Q && ((s - last) & 7) != 0; ++s) {
      step(s, std::false_type{});
      flush_to(s - last);
    }
    for (; s + 7 <= Q; s += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) step(s + u, std::false_type{});
      flush_to(s + 7 - last);
    }
  }
  for (; s <= Q; ++s) {
    step(s, std::false_type{});
    flush_to(s - last);
  }
  for (; s <= Q + last; ++s) {  // lanes finishing
    step(s, std::true_type{});
    flush_to(s - last);
  }
  __syncwarp();
  if (8 * nf <= Q)  // the last, partial block
    store_block(out + (size_t)nf * 8 * W,
                stage + (nf % REGIONS) * region_bytes +
                    ((uintptr_t)(out + (size_t)nf * 8 * W) & 15),
                (Q + 1 - 8 * nf) * W, v);
}

// short queries: rows in order, each row's Z from a scan over the lanes
template <int K>
__global__ void __launch_bounds__(128)
nw_tb_rows_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                  uint8_t* __restrict__ tb, int B, int Q, int R, int match,
                  int mismatch, int go, int ge, int region_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps only: no block barrier follows
  const int W = R + 1;
  const int8_t* qb = q + (size_t)b * Q;
  const int8_t* rb = r + (size_t)b * R;
  uint8_t* out = tb + (size_t)b * (Q + 1) * W;
  uint8_t* stage = smem + warp * region_bytes;

  const int j0 = 1 + lane * K;
  int rc[K], H[K], V[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    rc[k] = (j <= R) ? (int)rb[j - 1] : 4;
    H[k] = -(go + (j - 1) * ge);  // row 0
    V[k] = NEG;
  }
  auto qload = [&](int at) {
    const int c = (at + lane < Q) ? (int)qb[at + lane] : 4;
    return (c < 4) ? c : 1000;  // a code >= 4 never matches
  };
  int qreg = qload(0), qnext = qload(32);
  int r0 = 0;  // first row of the staged block
  int sh = (int)((uintptr_t)out & 15);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    if (j <= R) stage[sh + j] = (uint8_t)(j == 1 ? 2 : (2 | 8));
  }
  if (lane == 0) stage[sh] = 0;

  for (int i = 1; i <= Q; ++i) {
    if (((i - 1) & 31) == 0 && i > 1) {
      qreg = qnext;
      qnext = qload(i - 1 + 32);
    }
    const int qc = __shfl_sync(FULL, qreg, (i - 1) & 31);
    const int h0prev = (i == 1) ? 0 : -(go + (i - 2) * ge);
    const int h0i = -(go + (i - 1) * ge);
    const int hup = __shfl_up_sync(FULL, H[K - 1], 1);
    int hd = (lane == 0) ? h0prev : hup;
    int G[K], c[K], m[K], pb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int diag = hd + ((qc == rc[k]) ? match : mismatch);
      const int hg = H[k] - go;
      const int vg = V[k] - ge;
      const int vnew = max(hg, vg);
      pb[k] = (vnew > diag ? 1 : 0) | (vg > hg ? 4 : 0);
      G[k] = max(diag, vnew);
      V[k] = vnew;
      hd = H[k];
      c[k] = G[k] - go + (j0 + k) * ge;
      m[k] = (k == 0) ? c[k] : max(m[k - 1], c[k]);
    }
    // inclusive scan of the lane totals; lane 0 folds in c[0]
    const int c0 = h0i - go;
    int t = m[K - 1];
    if (lane == 0) t = max(t, c0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t = max(t, o);
    }
    const int ex = __shfl_up_sync(FULL, t, 1);
    const int carry = (lane == 0) ? c0 : ex;  // M[j0 - 1]
    // ext bit k: M[j-1] > c[j], the z_ext of the column after it
    unsigned ext = 0;
    uint8_t* srow = stage + sh + (i - r0) * W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int mp = (k == 0) ? carry : max(carry, m[k - 1]);
      const int Z = mp - (j0 + k - 1) * ge;
      ext |= (mp > c[k] ? 1u : 0u) << k;
      if (Z > G[k]) pb[k] = (pb[k] & 4) | 2;
      H[k] = max(G[k], Z);
    }
    const unsigned zin = __shfl_up_sync(FULL, (ext >> (K - 1)) & 1u, 1);
    const unsigned zx = (ext << 1) | (lane == 0 ? 0u : zin);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      if (j <= R) srow[j] = (uint8_t)(pb[k] | (((zx >> k) & 1u) << 3));
    }
    if (lane == 0) srow[0] = (uint8_t)(i > 1 ? (1 | 4) : 1);
    if (i - r0 == 7 || i == Q) {  // 8 rows staged, or the last
      __syncwarp();
      store_block(out + (size_t)r0 * W, stage + sh, (i + 1 - r0) * W, lane);
      __syncwarp();
      r0 = i + 1;
      sh = (int)((uintptr_t)(out + (size_t)r0 * W) & 15);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int K>
int launch(const int8_t* q, const int8_t* r, uint8_t* tb, int B, int Q,
           int R, int match, int mismatch, int go, int ge,
           cudaStream_t stream) {
  const int region_bytes = (8 * (R + 1) + 16 + 15) & ~15;
  const int pair_bytes = REGIONS * region_bytes;
  int pairs = (B >= 4 * sm_count()) ? 4 : 1;
  while (pairs > 1 && pairs * pair_bytes > 48 * 1024) pairs >>= 1;
  nw_tb_wave_kernel<K><<<(B + pairs - 1) / pairs, 32 * pairs,
                         (size_t)pairs * pair_bytes, stream>>>(
      q, r, tb, B, Q, R, match, mismatch, go, ge, region_bytes);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rows(const int8_t* q, const int8_t* r, uint8_t* tb, int B, int Q,
                int R, int match, int mismatch, int go, int ge,
                cudaStream_t stream) {
  const int region_bytes = (8 * (R + 1) + 16 + 15) & ~15;
  const int pairs = (B >= 4 * sm_count()) ? 4 : 1;
  nw_tb_rows_kernel<K><<<(B + pairs - 1) / pairs, 32 * pairs,
                         (size_t)pairs * region_bytes, stream>>>(
      q, r, tb, B, Q, R, match, mismatch, go, ge, region_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nw_tb_launch(const int8_t* q, const int8_t* r, uint8_t* tb,
                            int B, int Q, int R, int match, int mismatch,
                            int go, int ge, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || R > 1023 || Q < 1) return (int)cudaErrorInvalidValue;
#define NW_TB_ROWS(K) \
  launch_rows<K>(q, r, tb, B, Q, R, match, mismatch, go, ge, st)
#define NW_TB_WAVE(K) \
  launch<K>(q, r, tb, B, Q, R, match, mismatch, go, ge, st)
  const int need = (R + 31) / 32;  // columns per lane, 32 lanes a pair
  if (Q < ROWS_BELOW_Q) {
    if (need <= 2) return NW_TB_ROWS(2);
    if (need <= 4) return NW_TB_ROWS(4);
    if (need <= 6) return NW_TB_ROWS(6);
    if (need <= 8) return NW_TB_ROWS(8);
    if (need <= 16) return NW_TB_ROWS(16);
    return NW_TB_ROWS(32);
  }
  if (need <= 2) return NW_TB_WAVE(2);
  if (need <= 4) return NW_TB_WAVE(4);
  if (need <= 6) return NW_TB_WAVE(6);
  if (need <= 8) return NW_TB_WAVE(8);
  if (need <= 10) return NW_TB_WAVE(10);
  if (need <= 16) return NW_TB_WAVE(16);
  return NW_TB_WAVE(32);
#undef NW_TB_ROWS
#undef NW_TB_WAVE
}
