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
// What bounds it on an H100: latency. The run-length scan of a pair is a
// serial chain with a data-dependent output length; by bytes (op stream
// and raw bytes in, runs out) B = 2230 pairs at (192,192) need ~1 us at
// 3.35 TB/s, far under one launch.
//
// Design: one warp per pair, 4 pairs a CTA. The warp takes the op row 32
// steps at a time in forward order (one coalesced 32-byte load, the next
// chunk's loaded ahead; the zero tail K2 leaves costs a ballot a chunk).
// Ballots of the steps that consume query and reference bytes give each
// lane its query and reference index by a popcount of the lanes below
// it; a diagonal lane reads its two bytes (neighbouring lanes, neighbouring
// bytes). A lane starts a run where its op differs from the previous
// non-zero lane's (or, for the chunk's first, from the run left open by
// the chunk before); each start but the chunk's last knows its length
// from the next start and is written at once, the last stays open. The
// run state (open op and length, runs written, bytes consumed) is
// uniform across the warp. (A thread a pair would leave one warp an SM
// at B = 1024, with nothing to hide the latency of its divergent serial
// steps.)
//
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): 32 registers, no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PAIRS = 4;  // warps (pairs) a CTA

__device__ __forceinline__ bool is_acgt(uint8_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

__global__ void __launch_bounds__(32 * PAIRS)
nw_cigar_kernel(const int8_t* __restrict__ ops, const uint8_t* __restrict__ q,
                const uint8_t* __restrict__ r, int32_t* __restrict__ runs,
                int32_t* __restrict__ counts, int B, int T, int Q, int R,
                int C) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * PAIRS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int8_t* o = ops + (size_t)b * T;
  const uint8_t* qb = q + (size_t)b * Q;
  const uint8_t* rb = r + (size_t)b * R;
  int32_t* out = runs + (size_t)b * C;
  const unsigned below = (1u << lane) - 1;  // the lanes below this one
  int qbase = 0, rbase = 0;  // bytes consumed by earlier chunks
  int n = 0;                 // runs written
  int cur = 0, len = 0;      // the open run
  bool bad = false;
  int c = (T - 1 - lane >= 0) ? o[T - 1 - lane] : 0;
  for (int t0 = T - 1; t0 >= 0; t0 -= 32) {
    const int tn = t0 - 32 - lane;
    const int cn = tn >= 0 ? o[tn] : 0;  // the next chunk, loaded ahead
    const unsigned vm = __ballot_sync(FULL, c != 0);
    if (vm != 0) {
      const bool uq = c == 1 || c == 2;
      const bool ur = c == 1 || c == 3;
      const unsigned qm = __ballot_sync(FULL, uq);
      const unsigned rm = __ballot_sync(FULL, ur);
      const int qi = qbase + __popc(qm & below);
      const int ri = rbase + __popc(rm & below);
      if (__any_sync(FULL, c < 0 || c > 3 || (uq && qi >= Q) ||
                               (ur && ri >= R))) {
        bad = true;
        break;
      }
      int op = 0;
      if (c == 1) {
        const uint8_t a = qb[qi];
        op = (a == rb[ri] && is_acgt(a)) ? 7 : 8;
      } else if (c == 2) {
        op = 1;
      } else if (c == 3) {
        op = 2;
      }
      // the op of the previous non-zero lane, or the open run's
      const unsigned vb = vm & below;
      const int pop = __shfl_sync(FULL, op, vb ? 31 - __clz(vb) : 0);
      const bool start = c != 0 && op != (vb ? pop : cur);
      const unsigned sm = __ballot_sync(FULL, start);
      if (sm == 0) {
        len += __popc(vm);
      } else {
        // the open run ends at the chunk's first start
        const int first = __ffs(sm) - 1;
        const int closed = len + __popc(vm & ((1u << first) - 1));
        if (closed > 0) {
          if (lane == 0) out[n] = (closed << 4) | cur;
          ++n;
        }
        const unsigned after = sm & ~(below | (1u << lane));
        if (start && after) {
          const int next = __ffs(after) - 1;
          const int l = __popc(vm & ((1u << next) - 1) & ~below);
          out[n + __popc(sm & below)] = (l << 4) | op;
        }
        const int last = 31 - __clz(sm);
        n += __popc(sm) - 1;
        cur = __shfl_sync(FULL, op, last);
        len = __popc(vm & ~((1u << last) - 1));
      }
      qbase += __popc(qm);
      rbase += __popc(rm);
    }
    c = cn;
  }
  if (!bad && len > 0) {
    if (lane == 0) out[n] = (len << 4) | cur;
    ++n;
  }
  if (lane == 0) counts[b] = bad ? -1 : n;
}

}  // namespace

extern "C" int nw_cigar_launch(const int8_t* ops, const uint8_t* q,
                               const uint8_t* r, int32_t* runs,
                               int32_t* counts, int B, int T, int Q, int R,
                               void* stream) {
  nw_cigar_kernel<<<(B + PAIRS - 1) / PAIRS, 32 * PAIRS, 0,
                    (cudaStream_t)stream>>>(ops, q, r, runs, counts, B, T, Q,
                                            R, Q + R);
  return (int)cudaGetLastError();
}
