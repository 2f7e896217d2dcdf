// K3 snp_pileup: the SNP group pileup, straight from the group payload.
//
// Replaces the XLA-jitted body of the JAX package's SNP group kernel
// between neighbour selection and the CNN (there was no Pallas kernel
// here): the covering-read list of nanocaller_tpu/snp_caller.py::
// _group_body (_rid_matrix over the interval and hole test, :568-585),
// the table-free cell codes of _group_cell_codes (:483-541), and the
// pileup assembly of _snp_forward_dense (:88-106): the centre-base
// groups, the one-hot einsum, the ref channel, the flip and the
// coverage scale. Its plain twin is nanocaller_tpu_torch/pileup/
// snp_pileup.py::snp_pileup_reference.
//
// Output: x (B, 5, 41, 5) float32, NHWC, the tensor the SNP CNN takes.
// Row 0 is the column's ref one-hot (channel 4 zero). Rows 1-4 are, for
// the reads whose centre code is g = 0-3, count[g][w][c] * flip[w][c]
// * norm for c < 4 (flip = -1 where c is the column's ref base) and
// (centre ref == g) * (column valid) for c = 4. Every entry is an
// integer count times +-1 times norm, one float32 rounding as in the
// einsum, so the kernel equals its twin exactly.
//
// Cell code of read q at union site s (the group wire):
//   covered = read_lo[q] <= s <= read_hi[q] and (s, q) not in the hole CSR
//   code    = exception CSR hit ? exc_code
//           : bit span_start[q] + s - read_lo[q] of minor_bits ?
//             site_minor[s] : site_major[s]
//   cell    = covered ? code : 4
// A padding column (soc < 0) reads the trash site S (code 4).
//
// What bounds it on an H100: neither bytes nor operations at the main
// path's sizes. One launch takes a cohort of a few hundred rows against a
// payload of a few thousand reads; the output (4,100 bytes a row) and
// the wire are a few MB, a microsecond of HBM time, and the cell codes
// and counts the pileup needs are tens of millions of int32 operations,
// another microsecond (chip_smoke.py lists the counts). What it costs is
// latency: the launch, and per row a chain of block barriers and
// dependent loads (the CSR binary searches), and the design's own read
// scan below, which tests B * N intervals where the pileup needs only
// the covering reads.
//
// Design (simple first): one CTA of 256 threads per candidate row. The
// threads stride over the row's candidate reads in rounds of 256: all N
// reads of the group for a normal row (interval test first, the hole
// search only inside the interval), the first n_valid explicit ids of a
// deep row. A read whose centre code is 0-3 is appended to a shared list
// with its group g. Then the threads take the list's (read, column)
// cells, 41 a read, compute each cell code and add one to the shared
// int counter [g][w][c] (shared-memory atomics; integer sums commute,
// so the order does not matter). Normal rows count every covering read:
// the JAX package's read axis R is at least every normal row's depth,
// so no R axis is needed (snp_caller.pileup_cohorts checks on the host
// that no normal row is deeper than maxcov). The epilogue writes the
// row's 1,025 floats coalesced. Bounding the read scan by the reads'
// start order is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 41;
constexpr int CENTER = 20;
constexpr int THREADS = 256;
constexpr int OUT_ROW = 5 * W * 5;

struct Wire {
  const int32_t* read_lo;
  const int32_t* read_hi;
  const int32_t* span_start;
  const int8_t* site_ref;    // S + 1 entries, trash row S = 4
  const int8_t* site_major;  // S + 1
  const int8_t* site_minor;  // S + 1
  const uint8_t* minor_bits; // T bytes
  const int32_t* exc_indptr; // S + 2
  const int32_t* exc_rid;
  const int8_t* exc_code;
  const int32_t* hole_indptr;  // S + 2
  const int32_t* hole_rid;
  int N, S, T;
};

// lower bound of q in rid[indptr[s], indptr[s+1]); true on a hit
__device__ __forceinline__ bool csr_find(const int32_t* __restrict__ indptr,
                                         const int32_t* __restrict__ rid,
                                         int s, int q, int* pos) {
  int lo = indptr[s];
  const int end = indptr[s + 1];
  int hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rid[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  *pos = lo;
  return lo < end && rid[lo] == q;
}

__device__ __forceinline__ int cell_code(const Wire& w, int q, int s) {
  const int lo = w.read_lo[q];
  if (s < lo || s > w.read_hi[q]) return 4;
  int pos;
  if (csr_find(w.hole_indptr, w.hole_rid, s, q, &pos)) return 4;
  if (csr_find(w.exc_indptr, w.exc_rid, s, q, &pos)) return w.exc_code[pos];
  if (w.T == 0) return w.site_major[s];
  const int bit = min(max(w.span_start[q] + s - lo, 0), 8 * w.T - 1);
  return ((w.minor_bits[bit >> 3] >> (bit & 7)) & 1) ? w.site_minor[s]
                                                      : w.site_major[s];
}

__global__ void __launch_bounds__(THREADS)
snp_pileup_kernel(Wire w, const int32_t* __restrict__ cand_site,
                  const int32_t* __restrict__ soc,
                  const float* __restrict__ norm,
                  const int32_t* __restrict__ deep_rids,
                  const int32_t* __restrict__ n_valid, int deep_w,
                  float* __restrict__ out) {
  __shared__ int cnt[4 * W * 4];  // [g][w][c], c < 4
  __shared__ int col_site[W];
  __shared__ int col_ref[W];
  __shared__ int col_valid[W];
  __shared__ int list_q[THREADS];
  __shared__ int list_g[THREADS];
  __shared__ int n_list;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < 4 * W * 4; i += THREADS) cnt[i] = 0;
  if (t < W) {
    const int s = soc[(size_t)b * W + t];
    col_valid[t] = s >= 0;
    col_site[t] = s >= 0 ? s : w.S;
    col_ref[t] = s >= 0 ? w.site_ref[min(s, w.S - 1)] : 4;
  }
  if (t == 0) n_list = 0;
  __syncthreads();

  const bool deep = deep_rids != nullptr;
  const int n_cand = deep ? min(n_valid[b], deep_w) : w.N;
  const int s_center = col_site[CENTER];
  for (int base = 0; base < n_cand; base += THREADS) {
    const int i = base + t;
    if (i < n_cand) {
      const int q = deep ? min(max(deep_rids[(size_t)b * deep_w + i], 0),
                               w.N - 1)
                         : i;
      const int g = cell_code(w, q, s_center);
      if (g < 4) {
        const int k = atomicAdd(&n_list, 1);
        list_q[k] = q;
        list_g[k] = g;
      }
    }
    __syncthreads();
    const int n = n_list;
    for (int e = t; e < n * W; e += THREADS) {
      const int k = e / W;
      const int col = e - k * W;
      const int c = cell_code(w, list_q[k], col_site[col]);
      if (c < 4) atomicAdd(&cnt[(list_g[k] * W + col) * 4 + c], 1);
    }
    __syncthreads();
    if (t == 0) n_list = 0;
    __syncthreads();
  }

  const float nm = norm[b];
  const int cref = w.site_ref[min(max(cand_site[b], 0), w.S - 1)];
  float* o = out + (size_t)b * OUT_ROW;
  for (int e = t; e < OUT_ROW; e += THREADS) {
    const int h = e / (W * 5);
    const int r = e - h * (W * 5);
    const int col = r / 5;
    const int c = r - col * 5;
    const int cr = col_ref[col];
    float v;
    if (h == 0) {
      v = (c < 4 && cr == c) ? 1.f : 0.f;
    } else if (c < 4) {
      const float f = cr == c ? -1.f : 1.f;
      v = __fmul_rn(__fmul_rn((float)cnt[((h - 1) * W + col) * 4 + c], f),
                    nm);
    } else {
      v = (cref == h - 1 && col_valid[col]) ? 1.f : 0.f;
    }
    o[e] = v;
  }
}

}  // namespace

extern "C" int snp_pileup_launch(
    const int32_t* read_lo, const int32_t* read_hi, const int32_t* span_start,
    const int8_t* site_ref, const int8_t* site_major, const int8_t* site_minor,
    const uint8_t* minor_bits, const int32_t* exc_indptr,
    const int32_t* exc_rid, const int8_t* exc_code,
    const int32_t* hole_indptr, const int32_t* hole_rid, int N, int S, int T,
    const int32_t* cand_site, const int32_t* soc, const float* norm,
    const int32_t* deep_rids, const int32_t* n_valid, int deep_w, int B,
    float* out, void* stream) {
  const Wire w{read_lo,    read_hi,    span_start, site_ref, site_major,
               site_minor, minor_bits, exc_indptr, exc_rid,  exc_code,
               hole_indptr, hole_rid,  N,          S,        T};
  snp_pileup_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      w, cand_site, soc, norm, deep_rids, n_valid, deep_w, out);
  return (int)cudaGetLastError();
}
