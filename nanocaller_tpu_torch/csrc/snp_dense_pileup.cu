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
// What bounds it on an H100: bytes at a large batch (a row reads R * 41
// code bytes and writes 4,100 output bytes), and one row's chain of waits
// at the real batches (B = 625 rows of R = 45 are 1.15 MB in, 2.6 MB
// out, under a microsecond of the card's bandwidth): one global round
// trip for the row's inputs, then shared-memory steps.
//
// The earlier design (0.00643 ms at B = 625, R = 45; 0.0361 ms at
// B = 4096, R = 160; 0.0194 ms at R = 64; NVIDIA H100 80GB HBM3, 700 W)
// took a row a 128-thread CTA and read the codes a byte a thread from
// global memory, with an integer division by 41 and a shared-memory
// atomic add a code and two barriers a tile of 128 reads; each of a
// thread's codes waited on its own L2 round trip before its atomic.
//
// This design takes a row a warp, four rows a CTA, with no CTA-wide
// barrier. A warp:
// 1. stages the row's codes and read mask, a tile of up to TILE_MAX reads
//    at a time, in shared memory at their source's address mod 16
//    (b*R*41 is not 16-byte aligned in general): the 16-byte-aligned
//    bodies by cp.async, all in flight together, the under-16-byte heads
//    and tails by byte loads issued before their stores (the epilogue's
//    inputs, col_ref, col_valid, center_ref and norm, are loaded first
//    and not waited on until the end). One round trip a tile (one tile
//    for R <= 224);
// 2. sorts the tile's reads by centre group: 32 reads at a time, a
//    masked-in read with centre code g = 0-3 appends its code offset to
//    list g at the place a ballot gives it (reads in order, no atomics);
// 3. counts in registers: lane l takes column l and, for l < 9, column
//    l + 32 (the other lanes read past column 40 and drop what they
//    count). Over group g's list a code c adds 1 << 8c (a funnel shift:
//    a code 4, or any other, shifts out and adds 0) to a word of four byte
//    counters; four list entries come in one 8-byte load, the next four
//    loaded ahead, so eight code bytes are in flight at a time. No
//    division, no atomic. A tile has at most 224 reads, so no byte counter
//    overflows; after each tile the bytes are added to int32 totals, so a
//    count is exact at any R;
// 4. writes the row of x in shared memory over the codes, with K3's
//    arithmetic __fmul_rn(__fmul_rn((float)count, flip), norm), row 0 the
//    ref one-hot, channel 4 the centre-ref x valid mask, and stores it in
//    16-byte stores (the row's unaligned head and tail alone).
// Shared memory a warp: rup16(max(41 tile + 47, 4,112)) + rup16(tile +
// 15) + rup16(8 rup4(tile)) bytes (4,560 at R = 45, 11,264 at 224); four
// rows a CTA stay under 48 KB.
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 80 registers, no stack, no
// spills, no barrier; shared memory dynamic (above).

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int W = 41;
constexpr int CENTER = 20;
constexpr int ROWS = 4;  // rows (warps) a CTA
constexpr int THREADS = 32 * ROWS;
constexpr int OUT_ROW = 5 * W * 5;
constexpr int TILE_MAX = 224;  // reads a tile: under a byte counter's 255

// One warp's shared bytes at a tile of `tile` reads: the row's codes (at
// their source's offset mod 16, with 32 bytes over for the lanes past
// column 40; in the epilogue the row of x, at the output's offset mod
// 16), its read mask (likewise), and the group lists [4][stride] of
// uint16 code offsets.
struct Layout {
  int codes, mask, stride, total;  // stride: a list's entries, 4k
  __host__ __device__ explicit Layout(int tile)
      : codes(rup16(tile * W + 15 + 32) > rup16(4 * (OUT_ROW + 3))
                  ? rup16(tile * W + 15 + 32)
                  : rup16(4 * (OUT_ROW + 3))),
        mask(rup16(tile + 15)),
        stride((tile + 3) & ~3),
        total(codes + mask + rup16(4 * stride * 2)) {}
};

// 1 << 8c: byte c of a word of four counters (c = 0-3); a code 4, or any
// other, shifts out and adds 0
__device__ __forceinline__ unsigned one_hot(unsigned c) {
  return __funnelshift_lc(0u, 1u, 8u * c);
}

__device__ __forceinline__ void add_bytes(int* tot, unsigned acc) {
#pragma unroll
  for (int c = 0; c < 4; ++c) tot[c] += (acc >> (8 * c)) & 0xff;
}

// x's 25 values of column w (its ref one-hot, then the four groups'
// scaled counts and the centre-ref channel), at o = the row's x + 5w.
__device__ __forceinline__ void write_column(float* o, const int (*tot)[4],
                                             int cr, bool cv, int cref,
                                             float nm) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = cr == c ? 1.f : 0.f;
    const float f = cr == c ? -1.f : 1.f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      o[(g + 1) * W * 5 + c] = __fmul_rn(__fmul_rn((float)tot[g][c], f), nm);
  }
  o[4] = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    o[(g + 1) * W * 5 + 4] = (cref == g && cv) ? 1.f : 0.f;
}

__global__ void __launch_bounds__(THREADS)
snp_dense_pileup_kernel(const int8_t* __restrict__ codes,
                        const uint8_t* __restrict__ mask,
                        const int8_t* __restrict__ col_ref,
                        const uint8_t* __restrict__ col_valid,
                        const int8_t* __restrict__ center_ref,
                        const float* __restrict__ norm, int B, int R,
                        int tile, float* __restrict__ out,
                        float* __restrict__ ref_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * ROWS + warp;
  if (b >= B) return;  // no CTA-wide barrier below
  const Layout L(tile);
  uint8_t* s_codes = smem + (size_t)warp * L.total;
  uint8_t* s_mask = s_codes + L.codes;
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_mask + L.mask);
  const unsigned below = (1u << lane) - 1;
  const bool two = lane + 32 < W;  // lanes 0-8 also take column lane + 32
  int tot[2][4][4] = {};           // [column][g][c]
  // the epilogue's inputs, loaded here and not waited on until then
  const int cr0 = col_ref[(size_t)b * W + lane];
  const int cv0 = col_valid[(size_t)b * W + lane];
  const int cr1 = two ? col_ref[(size_t)b * W + 32 + lane] : 4;
  const int cv1 = two ? col_valid[(size_t)b * W + 32 + lane] : 0;
  const int cref = center_ref[b];
  const float nm = norm[b];
  for (int r0 = 0; r0 < R; r0 += tile) {
    const int n = min(tile, R - r0);
    // stage the tile's codes and mask: the bodies, then the edges, each
    // lane's two loaded before either is stored
    const Span sc(codes + ((size_t)b * R + r0) * W, n * W, s_codes);
    const Span sm(mask + (size_t)b * R + r0, n, s_mask);
    sc.body(lane, 32);
    sm.body(lane, 32);
    const int ec = sc.edge(lane), em = sm.edge(lane);
    const uint8_t vc = ec >= 0 ? sc.src[ec] : 0;
    const uint8_t vm = em >= 0 ? sm.src[em] : 0;
    if (ec >= 0) sc.dst[ec] = vc;
    if (em >= 0) sm.dst[em] = vm;
    cp_async_wait_all();
    __syncwarp();

    // the group lists, 32 reads at a time in order: a masked-in read
    // with centre code g = 0-3 adds its code offset to list g at the
    // place a ballot gives it
    int len[4] = {};
    for (int r = lane; r - lane < n; r += 32) {
      const unsigned g =
          r < n && sm.dst[r] != 0 ? sc.dst[r * W + CENTER] : 4u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(FULL, g == k);
        if (g == k)
          s_list[k * L.stride + len[k] + __popc(m & below)] =
              static_cast<uint16_t>(r * W);
        len[k] += __popc(m);
      }
    }
    __syncwarp();

    // lane l counts column l and, for l < 9, column l + 32 (the others
    // read past column 40 and drop what they count), four list entries
    // (one 8-byte load, the next four loaded ahead) and eight code bytes
    // in flight at a time
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint16_t* lst = s_list + g * L.stride;
      unsigned a0 = 0, a1 = 0;
      int i = 0;
      if (len[g] >= 4) {
        uint2 e = *reinterpret_cast<const uint2*>(lst);
        for (; i + 4 <= len[g]; i += 4) {
          const uint2 next = i + 8 <= len[g]
              ? *reinterpret_cast<const uint2*>(lst + i + 4) : e;
          const uint8_t* d0 = sc.dst + (e.x & 0xffff);
          const uint8_t* d1 = sc.dst + (e.x >> 16);
          const uint8_t* d2 = sc.dst + (e.y & 0xffff);
          const uint8_t* d3 = sc.dst + (e.y >> 16);
          a0 += one_hot(d0[lane]) + one_hot(d1[lane]) + one_hot(d2[lane]) +
                one_hot(d3[lane]);
          a1 += one_hot(d0[32 + lane]) + one_hot(d1[32 + lane]) +
                one_hot(d2[32 + lane]) + one_hot(d3[32 + lane]);
          e = next;
        }
      }
      for (; i < len[g]; ++i) {
        const uint8_t* rd = sc.dst + lst[i];
        a0 += one_hot(rd[lane]);
        a1 += one_hot(rd[32 + lane]);
      }
      add_bytes(tot[0][g], a0);
      add_bytes(tot[1][g], a1);
    }
    __syncwarp();  // the tile's buffers are free
  }

  // the epilogue: the row of x in shared memory (over the codes), then
  // out in 16-byte stores; the ref one-hot from lanes 0-3
  float* dst = out + (size_t)b * OUT_ROW;
  float* s_x = reinterpret_cast<float*>(s_codes) +
               ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  write_column(s_x + 5 * lane, tot[0], cr0, cv0 != 0, cref, nm);
  if (two)
    write_column(s_x + 5 * (lane + 32), tot[1], cr1, cv1 != 0, cref, nm);
  if (lane < 4) ref_out[(size_t)b * 4 + lane] = cref == lane ? 1.f : 0.f;
  __syncwarp();
  const int head = (4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3;
  const int nb = (OUT_ROW - head) >> 2;
  for (int i = lane; i < nb; i += 32)
    reinterpret_cast<float4*>(dst + head)[i] =
        reinterpret_cast<const float4*>(s_x + head)[i];
  const int i = lane < 4 ? lane : head + 4 * nb + lane - 4;
  if (lane < 4 ? lane < head : (lane < 8 && i < OUT_ROW)) dst[i] = s_x[i];
}

}  // namespace

extern "C" int snp_dense_pileup_launch(const int8_t* codes,
                                       const uint8_t* mask,
                                       const int8_t* col_ref,
                                       const uint8_t* col_valid,
                                       const int8_t* center_ref,
                                       const float* norm, int B, int R,
                                       float* out, float* ref, void* stream) {
  const int tile = R < 1 ? 1 : (R < TILE_MAX ? R : TILE_MAX);
  snp_dense_pileup_kernel<<<(B + ROWS - 1) / ROWS, THREADS,
                            ROWS * Layout(tile).total,
                            (cudaStream_t)stream>>>(
      codes, mask, col_ref, col_valid, center_ref, norm, B, R, tile, out,
      ref);
  return (int)cudaGetLastError();
}
