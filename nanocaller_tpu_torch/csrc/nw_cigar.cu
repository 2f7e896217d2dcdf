// K4 nw_cigar: K2's op streams into packed cigars, on the card.
//
// Replaces: the host walk of the op stream in
// nanocaller_tpu/align/batch_nw.py::BatchAligner.align_many (:266-309,
// `_walk_to_cigar` then `refine_diag_ops` per pair and op). It is a port
// of host code, not of a TPU kernel. Its plain twin is
// nanocaller_tpu_torch/align/nw_kernels.py::nw_cigar_reference.
//
// Per pair b it reads K2's op row ops[b, :T] (0 none, 1 diag, 2 ins,
// 3 del, in end-to-start order, zero steps anywhere) backwards, so in
// start-to-end order, and the pair's raw bytes q[b, :Q] and r[b, :R]. A
// diagonal step is '=' (7) only when the two bytes are equal and one of
// "ACGT" (so a/a and N/N are 'X' (8), as refine_diag_ops decides, though
// K1's codes fold the case); an ins step is 'I' (1), a del step 'D' (2).
// It writes the maximal runs of those ops, packed (len << 4) | op in
// forward order, into runs[b, :n] (the rest of the row is left as it
// was) and n into counts[b]: the packed wire of JAX's
// align_pairs_host(packed=True). A row that would read past Q or R, or
// holds a code outside 0-3 (possible only for a stream K2 did not
// write), gets count -1, which the caller raises on.
//
// What bounds it on an H100: latency. By bytes (op stream and raw bytes
// in, runs out) B = 2230 pairs at (192,192) need ~1 us at 3.35 TB/s, far
// under one launch; a pair's run-length scan is a serial chain with a
// data-dependent output length. The main path's launches are small (B =
// 64 and 120 pairs) or at most a few thousand pairs, all resident at
// once, so a launch takes about one pair's chain: one global round trip
// for its inputs, then shared-memory steps, each waiting on the one
// before it (one warp issues at about one instruction a cycle with
// nothing to hide its latencies).
//
// The earlier design (0.0117 ms at (192,192) B = 1024, 0.0121 ms
// at B = 2230, 0.0120 ms on the B = 120 allele launch, 0.0084 ms at
// (64,192) B = 64; NVIDIA H100 80GB HBM3, 700 W) took a warp a pair and
// walked the row in global memory, 32 steps a chunk from T - 1 down with
// the run state carried from chunk to chunk: each chunk waited on its op
// bytes and then on a dependent load of the pair's bytes, 25 chunks at
// (192,192), ~15 of them in K2's zero tail; 4 pairs a CTA left most SMs
// idle at B = 64 and 120.
//
// This design removes the chunk chain. A pair is one CTA of 1, 2 or 4
// warps (NW, chosen at launch: as many as keep the launch within 4 warps
// an SM, so B = 64 and 120 take 4 warps a pair over 64 and 120 SMs, and
// B >= 264 on 132 SMs one warp a pair, where the other pairs' warps hide
// the latencies). Its threads:
// 1. stage the op row, the query and the reference bytes in shared
//    memory, each at its source's address mod 16 (an op row starts at
//    b*T with T = 2 mod 16): the 16-byte-aligned bodies by cp.async, all
//    in flight together, the under-16-byte heads and tails by byte loads
//    of warp 0, issued before any of their stores; one round trip;
// 2. find the last non-zero step h in one parallel pass: the op buffer's
//    bytes around the row are zeroed, each thread tests its run of words
//    (eight loads in flight) and a warp max (plus the barrier's exchange
//    for NW > 1) gives the highest, so K2's zero tail costs a test a word;
// 3. split the steps h .. 0 into one contiguous segment a thread and
//    count each segment's query, reference and non-zero steps and any
//    code outside 0-3; a scan over the threads gives each segment's first
//    byte indices and the totals, and a total past Q or R, or a bad code,
//    gives -1 for the whole pair at once;
// 4. write each segment's ops ('=' 7, 'X' 8, 'I' 1, 'D' 2), compacted,
//    into cop (the k-th non-zero step's at cop[k]);
// 5. count the run starts of each thread's segment of cop (k starts a run
//    where cop[k] != cop[k-1]), scan them into run indices, and write
//    each run's first step into sp (sp[n] = the number of steps);
// 6. write the runs, run j = ((sp[j+1] - sp[j]) << 4) | cop[sp[j]], four
//    a thread in 16-byte stores (the row's unaligned head and tail
//    alone), once the count is known.
// No step carries a state from one part of the row to the next: the
// scans replace the earlier chunk-to-chunk run state, so a pair's chain
// is a round trip, five short passes over a few steps a thread and two
// scans.
// Shared memory a pair: SCRATCH + rup16(T+18) + rup16(Q+15) + rup16(R+15)
// + rup16(2(Q+R+2)) + rup16(Q+R) bytes (2,448 at (192,192)); a launch
// past 48 KB asks for more, and one past the card's limit fails and the
// wrapper raises. T < 65536 (the scan packs two counts in 16-bit halves).
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): NW = 1 52 registers, NW = 2 38,
// NW = 4 40; no stack, no spills; shared memory dynamic (above).

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 4;       // warps a pair (a CTA)
constexpr int WARPS_PER_SM = 4;    // warps a launch may use an SM
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SCRATCH = 64;        // the barriers' exchange: 2 ints a warp

// A pair's shared bytes after the exchange: the op row (at its source's
// offset mod 16, with room to zero the bytes around it up to whole
// words), the query and reference rows (at theirs), the run starts sp
// (uint16) and the compacted ops cop (bytes).
struct Layout {
  int ops, q, r, sp, cop;
  __host__ __device__ Layout(int T, int Q, int R)
      : ops(rup16(T + 18)), q(rup16(Q + 15)), r(rup16(R + 15)),
        sp(rup16(2 * (Q + R + 2))), cop(rup16(Q + R)) {}
  __host__ __device__ int total() const {
    return SCRATCH + ops + q + r + sp + cop;
  }
};

__device__ __forceinline__ bool is_acgt(uint8_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// The CTA's barrier: a warp's alone when the CTA is one warp.
template <int NW>
__device__ __forceinline__ void barrier() {
  if (NW == 1)
    __syncwarp();
  else
    __syncthreads();
}

// The exclusive prefix sums over the CTA's threads of a and b, and their
// totals: a warp scan, then (for more than one warp) each warp's sums
// through s (two ints a warp) and one barrier. Returns whether any
// thread's `flag` is set; the barrier (or the warp vote) reads it.
template <int NW>
__device__ __forceinline__ bool scan2(int& a, int& b, int* s, bool flag,
                                      int& ta, int& tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = a, y = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, x, d);
    const int v = __shfl_up_sync(FULL, y, d);
    if (lane >= d) {
      x += u;
      y += v;
    }
  }
  if (NW == 1) {
    ta = __shfl_sync(FULL, x, 31);
    tb = __shfl_sync(FULL, y, 31);
    a = x - a;
    b = y - b;
    return __any_sync(FULL, flag);
  }
  if (lane == 31) {
    s[2 * warp] = x;
    s[2 * warp + 1] = y;
  }
  const bool any = __syncthreads_or(flag);
  int pa = 0, pb = 0;
  ta = tb = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int u = s[2 * w], v = s[2 * w + 1];
    if (w < warp) {
      pa += u;
      pb += v;
    }
    ta += u;
    tb += v;
  }
  a = pa + x - a;
  b = pb + y - b;
  return any;
}

template <int NW>  // warps a pair
__global__ void __launch_bounds__(32 * NW)
nw_cigar_kernel(const int8_t* __restrict__ ops, const uint8_t* __restrict__ q,
                const uint8_t* __restrict__ r, int32_t* __restrict__ runs,
                int32_t* __restrict__ counts, int T, int Q, int R) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x, nt = 32 * NW;
  const int lane = t & 31;
  const int b = blockIdx.x;
  const int C = Q + R;
  const Layout L(T, Q, R);
  int* xch = reinterpret_cast<int*>(smem);  // the barriers' exchange
  uint8_t* obuf = smem + SCRATCH;
  uint8_t* qbuf = obuf + L.ops;
  uint8_t* rbuf = qbuf + L.q;
  uint16_t* sp = reinterpret_cast<uint16_t*>(rbuf + L.r);  // run starts
  uint8_t* cop = rbuf + L.r + L.sp;                         // compacted ops
  int32_t* out = runs + (size_t)b * C;

  // 1. stage the three rows: every thread issues bodies, warp 0 copies
  // the edges (each lane's three loaded before any is stored) and zeroes
  // the op buffer's bytes around the row, up to whole words
  const Span so(ops + (size_t)b * T, T, obuf);
  const Span sq(q + (size_t)b * Q, Q, qbuf);
  const Span sr(r + (size_t)b * R, R, rbuf);
  so.body(t, nt);
  sq.body(t, nt);
  sr.body(t, nt);
  const int off = static_cast<int>(so.dst - obuf);
  const int end = off + T;
  const int nw = (end + 3) >> 2;
  if (t < 32) {
    const int eo = so.edge(lane), eq = sq.edge(lane), er = sr.edge(lane);
    const uint8_t vo = eo >= 0 ? so.src[eo] : 0;
    const uint8_t vq = eq >= 0 ? sq.src[eq] : 0;
    const uint8_t vr = er >= 0 ? sr.src[er] : 0;
    if (eo >= 0) so.dst[eo] = vo;
    if (eq >= 0) sq.dst[eq] = vq;
    if (er >= 0) sr.dst[er] = vr;
    if (lane < off) obuf[lane] = 0;
    if (lane < 4 * nw - end) obuf[end + lane] = 0;
  }
  cp_async_wait_all();
  barrier<NW>();

  // 2. the last non-zero step h: thread t takes the words [t*K, (t+1)*K),
  // eight loads at a time, and keeps its highest non-zero one; a warp
  // max and the barrier's exchange give the CTA's (none: an all-zero
  // row, count 0)
  const unsigned* words = reinterpret_cast<const unsigned*>(obuf);
  const int K = (nw + nt - 1) / nt;
  int top = -1;
  for (int g0 = 0; g0 < K; g0 += 8) {
    unsigned v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int w = t * K + g0 + k;
      v[k] = g0 + k < K && w < nw ? words[w] : 0u;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (v[k] != 0) top = t * K + g0 + k;
  }
  top = __reduce_max_sync(FULL, top);
  if (NW > 1) {
    if (lane == 0) xch[t >> 5] = top;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NW; ++w) top = max(top, xch[w]);
  }
  if (top < 0) {
    if (t == 0) counts[b] = 0;
    return;
  }
  const int h = 4 * top + ((31 - __clz(words[top])) >> 3) - off;

  // 3. each thread's segment of the walk: steps p0 .. p1-1 (S a thread),
  // the step p at row position h - p; its query, reference and non-zero
  // step counts and whether it holds a code outside 0-3
  const int8_t* o = reinterpret_cast<const int8_t*>(so.dst);
  const int S = (h + nt) / nt;
  const int p0 = min(t * S, h + 1), p1 = min(p0 + S, h + 1);
  int nq = 0, nr = 0, nz = 0;
  bool bad = false;
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const int c = o[h - p];
    nq += c == 1 || c == 2;
    nr += c == 1 || c == 3;
    nz += c != 0;
    bad |= c < 0 || c > 3;
  }
  // exclusive prefix sums over the threads (q and r packed in 16-bit
  // halves: T < 65536); the barrier also reads every thread's bad flag
  if (NW > 1) __syncthreads();  // the exchange's last readers are done
  int qr = nq | (nr << 16), z = nz, tqr, tz;
  if (scan2<NW>(qr, z, xch, bad, tqr, tz) || (tqr & 0xffff) > Q ||
      (tqr >> 16) > R) {
    if (t == 0) counts[b] = -1;
    return;
  }

  // 4. each step's op ('=' 7, 'X' 8, 'I' 1, 'D' 2), compacted: cop[k] is
  // the k-th non-zero step's
  {
    const uint8_t* qb = sq.dst;
    const uint8_t* rb = sr.dst;
    int qi = qr & 0xffff, ri = qr >> 16, k = z;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const int c = o[h - p];
      if (c == 1) {
        const uint8_t a = qb[qi];
        cop[k++] = (a == rb[ri] && is_acgt(a)) ? 7 : 8;
        ++qi;
        ++ri;
      } else if (c == 2) {
        cop[k++] = 1;
        ++qi;
      } else if (c == 3) {
        cop[k++] = 2;
        ++ri;
      }
    }
  }
  barrier<NW>();

  // 5. the run starts: step k starts a run where its op differs from step
  // k-1's; each thread counts those in its segment of cop, a prefix sum
  // gives their run indices, and sp[j] holds run j's first step
  const int S2 = (tz + nt - 1) / nt;
  const int k0 = min(t * S2, tz), k1 = min(k0 + S2, tz);
  int ns = 0;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) ns += k == 0 || cop[k] != cop[k - 1];
  int j = ns, unused = 0, n, tu;
  scan2<NW>(j, unused, xch, false, n, tu);
#pragma unroll 4
  for (int k = k0; k < k1; ++k)
    if (k == 0 || cop[k] != cop[k - 1]) sp[j++] = static_cast<uint16_t>(k);
  if (t == 0) sp[n] = static_cast<uint16_t>(tz);
  barrier<NW>();

  // 6. the runs out, packed (len << 4) | op: the 16-byte-aligned body in
  // int4 stores, four runs a thread
  const int ooff =
      static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  const int head = min((4 - ooff) & 3, n);
  const int nv = (n - head) >> 2;
  for (int v = t; v < nv; v += nt) {
    const int j0 = head + 4 * v;
    int4 x;
    x.x = ((sp[j0 + 1] - sp[j0]) << 4) | cop[sp[j0]];
    x.y = ((sp[j0 + 2] - sp[j0 + 1]) << 4) | cop[sp[j0 + 1]];
    x.z = ((sp[j0 + 3] - sp[j0 + 2]) << 4) | cop[sp[j0 + 2]];
    x.w = ((sp[j0 + 4] - sp[j0 + 3]) << 4) | cop[sp[j0 + 3]];
    reinterpret_cast<int4*>(out + head)[v] = x;
  }
  const int i = t < 4 ? t : head + 4 * nv + t - 4;
  if (t < 4 ? t < head : (t < 8 && i < n))
    out[i] = ((sp[i + 1] - sp[i]) << 4) | cop[sp[i]];
  if (t == 0) counts[b] = n;
}

}  // namespace

extern "C" int nw_cigar_launch(const int8_t* ops, const uint8_t* q,
                               const uint8_t* r, int32_t* runs,
                               int32_t* counts, int B, int T, int Q, int R,
                               void* stream) {
  if (T >= 65536) return (int)cudaErrorInvalidValue;  // 16-bit counts
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int warps = MAX_WARPS;
  while (warps > 1 && (long long)B * warps > (long long)WARPS_PER_SM * sms)
    warps >>= 1;
  void (*kernel)(const int8_t*, const uint8_t*, const uint8_t*, int32_t*,
                 int32_t*, int, int, int) =
      warps == 4 ? nw_cigar_kernel<4>
                 : warps == 2 ? nw_cigar_kernel<2> : nw_cigar_kernel<1>;
  const size_t smem = Layout(T, Q, R).total();
  if (smem > SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(ops, q, r, runs,
                                                        counts, T, Q, R);
  return (int)cudaGetLastError();
}
