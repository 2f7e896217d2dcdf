// K3 snp_pileup: the SNP group kernel, from the group payload to the
// pileup the SNP CNN takes, in one launch per cohort of candidate rows.
//
// Replaces the XLA-jitted body of the JAX package's SNP group kernel up
// to the CNN (there was no Pallas kernel here), in nanocaller_tpu/
// snp_caller.py: the band-quota neighbour selection clamped to each
// member's window (_device_select_neighbors_clamped, :417-461), the
// covering-read list of _group_body (the interval and hole test and
// _rid_matrix, :568-585; deep rows take _group_deep_body's explicit ids,
// :597-623), the table-free cell codes of _group_cell_codes (:483-541,
// with _lower_bound_rows, :464), and the assembly of _group_forward_tail
// and _snp_forward_dense (:544, :79-111): the centre-base groups, the
// one-hot einsum, the ref channel, the flip and the coverage scale. Its
// plain twin is nanocaller_tpu_torch/pileup/snp_pileup.py::
// snp_pileup_reference.
//
// Outputs: x (B, 5, 41, 5) float32, NHWC. Row 0 is the column's ref
// one-hot (channel 4 zero). Rows 1-4 are, for the reads whose centre
// code is g = 0-3, count[g][w][c] * flip[w][c] * norm for c < 4 (flip =
// -1 where c is the column's ref base) and (centre ref == g) * (column
// valid) for c = 4. Every entry is an integer count times +-1 times
// norm, one float32 rounding as in the einsum, so the kernel equals its
// twin exactly. soc (B, 41) int32, the union site of each column (-1
// padding, centre = cand_site). ref (B, 4) float32, the one-hot of the
// candidate's ref base.
//
// Neighbour selection, per side: for each band (lo_off, hi_off, k,
// take) of the table, i0/i1 = the lower bounds of cand_pos + lo_off /
// + hi_off (64-bit) in nbr_pos, each clamped to [lo_c, hi_c); cnt =
// min(i1 - i0, k) entries from i0 ("first") or i1 - cnt ("last"). The
// valid entries of a side, in band order, go left-aligned from column
// 21 (right) or right-aligned to column 19 (left); a column holds
// nbr_union[index].
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
// path's sizes. A launch takes a cohort of about a thousand rows against
// a payload of a few thousand reads; the output (4,100 bytes a row) and
// the wire are a few MB, a microsecond and a half of HBM time, and the
// selection's searches, the cell codes and the counts are some tens of
// millions of int32 operations, about a microsecond (chip_smoke.py lists
// the counts). What it costs is latency: the launch, and per row chains
// of dependent loads (binary searches, CSR lookups, minor bits) between
// block barriers.
//
// Design: one CTA of 128 threads per candidate row, so that a cohort of
// up to ~1,500 rows is resident at once (12 CTAs an SM), and every
// chain of dependent device-memory loads is kept short:
// - phase A, independent work on different warps, then one barrier:
//   warp 0 selects the neighbours: it keeps 128 samples of nbr_pos in
//   shared memory (all of it up to M = 128), lane 2b + e finds band b's
//   end e there and then in the < M/128 entries between two samples,
//   a shuffle pairs the ends, a 5-step shuffle scan of the band counts
//   gives each band its first column, and a lane writes its band's
//   entries (512 samples, all of a main-path group's list, timed
//   slower: the loads cost more than the 2-3 search steps they save).
//   Warp 1 reads the row's read window (below) and loads the centre
//   column; warps 2-3 zero the counters.
// - phase B: the reads of the window (a deep row's first n_valid ids)
//   take their centre code; a read with code g < 4 is appended to a
//   shared list with its interval and bit offset, and counted at the
//   centre column. The last 41 threads meanwhile load the other columns.
//   One barrier.
// - phase C: the cells of the listed reads at the non-centre valid
//   columns that their intervals reach. The valid columns are one
//   contiguous range around the centre and their sites do not decrease,
//   so a read reaches one range of them, found by two searches in
//   shared memory; a block scan of the ranges' lengths (two barriers)
//   numbers the cells, and the threads take them one each: the cell's
//   code, and one added to the shared int counter [g][w][c]
//   (shared-memory atomics; integer sums commute). Only cells a read
//   covers cost work. One barrier, then the epilogue writes the row's
//   1,025 floats coalesced.
// A loaded column keeps its site's codes, CSR row bounds and the first
// four entries of its exception and hole rows in shared memory, so that
// a cell code needs one device-memory load (its minor-bit byte) unless a
// row is longer.
// The read window replaces a scan of all N reads: group_wire sorts the
// reads by (read_lo, id) and keeps the running max of read_hi in that
// order; every read covering s lies in [k0, k1) of that order, k1 the
// upper bound of s in the sorted read_lo, k0 the lower bound of s in the
// running max, and the host stores both for every site (win_lo, win_hi).
// That is exact whatever the reads' id order (empty reads carry lo = 1 >
// hi = 0 and fail the interval test); a long read only widens it. A
// window longer than the list (LIST reads) is taken in rounds with two
// more barriers each. Normal rows count every covering read: the JAX
// package's read axis R is at least every normal row's depth, so no R
// axis is needed (snp_caller.pileup_cohorts checks on the host that no
// normal row is deeper than maxcov).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 41;
constexpr int CENTER = 20;
constexpr int THREADS = 128;
constexpr int LIST = 256;
constexpr int MAX_BANDS = 7;
constexpr int SAMPLES = 128;  // nbr_pos samples of the selection
constexpr int ROW_CACHE = 4;  // CSR entries of a column kept in shared
static_assert(LIST == 2 * THREADS, "phase C takes two listed reads a thread");
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
  const int32_t* order;      // N, read ids by (read_lo, id)
  const int32_t* win_lo;     // S + 1, a site's read window in that order
  const int32_t* win_hi;     // S + 1
  const int32_t* nbr_pos;    // M, sorted
  const int32_t* nbr_union;  // M
  const int32_t* bands;      // (2, MAX_BANDS, 4)
  int N, S, T, M;
};

struct Rows {
  const int32_t* cand_site;
  const int32_t* cand_pos;
  const int32_t* lo_c;
  const int32_t* hi_c;
  const float* norm;
  const int32_t* deep_rids;  // null for normal rows
  const int32_t* n_valid;
  int deep_w;
};

// A column: its site, codes and CSR rows, with the rows' first entries.
struct Col {
  int s, e0, e1, h0, h1, major, minor;
  int erid[ROW_CACHE], ecode[ROW_CACHE], hrid[ROW_CACHE];
};
// A listed read: its id, centre code, interval and bit offset.
struct Read {
  int q, g, lo, hi, base;  // base = span_start - lo
};

// first i in [lo, hi) with a[i] >= v (compared as V), else hi
template <typename V>
__device__ __forceinline__ int lower_bound(const int32_t* a, int lo, int hi,
                                           V v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((V)a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// whether q is in rid[lo, hi) (sorted), with its index
__device__ __forceinline__ bool csr_find(const int32_t* rid, int lo, int hi,
                                         int q, int* pos) {
  *pos = lower_bound(rid, lo, hi, q);
  return *pos < hi && rid[*pos] == q;
}

__device__ __forceinline__ void load_col(const Wire& w, int s, Col* c) {
  const int e0 = w.exc_indptr[s], e1 = w.exc_indptr[s + 1];
  const int h0 = w.hole_indptr[s], h1 = w.hole_indptr[s + 1];
  c->s = s;
  c->e0 = e0;
  c->e1 = e1;
  c->h0 = h0;
  c->h1 = h1;
  c->major = w.site_major[s];
  c->minor = w.site_minor[s];
#pragma unroll
  for (int j = 0; j < ROW_CACHE; ++j) {
    c->erid[j] = e0 + j < e1 ? w.exc_rid[e0 + j] : -1;
    c->ecode[j] = e0 + j < e1 ? w.exc_code[e0 + j] : 4;
    c->hrid[j] = h0 + j < h1 ? w.hole_rid[h0 + j] : -1;
  }
}

// the bit of read q's minor mask at site s (base = span_start - lo)
__device__ __forceinline__ int minor_bit(const Wire& w, int base, int s) {
  return min(max(base + s, 0), 8 * w.T - 1);
}

// code of read q at column c, where lo <= s <= hi is known; byte is the
// minor_bits byte of bit (loaded ahead by the caller)
__device__ __forceinline__ int covered_code(const Wire& w, const Col& c,
                                            int q, int bit, int byte) {
  bool hole = false;
  int exc = -1, pos;
  if (c.h1 - c.h0 <= ROW_CACHE) {
#pragma unroll
    for (int j = 0; j < ROW_CACHE; ++j) hole |= c.hrid[j] == q;
  } else {
    hole = csr_find(w.hole_rid, c.h0, c.h1, q, &pos);
  }
  if (c.e1 - c.e0 <= ROW_CACHE) {
#pragma unroll
    for (int j = 0; j < ROW_CACHE; ++j)
      if (c.erid[j] == q) exc = c.ecode[j];
  } else if (csr_find(w.exc_rid, c.e0, c.e1, q, &pos)) {
    exc = w.exc_code[pos];
  }
  if (hole) return 4;
  if (exc >= 0) return exc;
  if (w.T == 0) return c.major;
  return ((byte >> (bit & 7)) & 1) ? c.minor : c.major;
}

// Warp 0: the row's neighbour columns into col_site (left of the centre
// right-aligned to CENTER - 1, right of it from CENTER + 1) and the
// counts of each side into n_side.
__device__ __forceinline__ void select_neighbours(
    const Wire& w, int cpos, int lo_c, int hi_c, int lane, int* smp,
    int* col_site, int* n_side) {
  const int band = lane >> 1;  // 0-6 left, 7-13 right
  int lo_off = 0, hi_off = 0, k = 0, take = 0;
  if (band < 2 * MAX_BANDS) {
    const int32_t* row = w.bands + band * 4;
    lo_off = row[0];
    hi_off = row[1];
    k = row[2];
    take = row[3];
  }
  // first level: every P-th position, P = ceil(M / SAMPLES)
  const int M = w.M;
  const int P = (M + SAMPLES - 1) / SAMPLES;
  const int n_s = P ? (M + P - 1) / P : 0;
  for (int j = lane; j < n_s; j += 32) smp[j] = w.nbr_pos[j * P];
  __syncwarp();
  int idx = 0;
  if (k > 0 && M > 0) {
    const long long v = (long long)cpos + ((lane & 1) ? hi_off : lo_off);
    // the answer lies after sample J - 1 and at or before sample J, the
    // first sample >= v
    const int J = lower_bound(smp, 0, n_s, v);
    idx = lower_bound(w.nbr_pos, J ? (J - 1) * P + 1 : 0,
                      J < n_s ? J * P : M, v);
  }
  idx = min(max(idx, lo_c), hi_c);
  const int i1 = __shfl_down_sync(0xffffffffu, idx, 1);
  int cnt = 0, start = 0;
  if (!(lane & 1) && k > 0) {
    cnt = max(min(i1 - idx, k), 0);
    start = take ? i1 - cnt : idx;
  }
  // inclusive scan of the band counts over the lanes
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int n_left = __shfl_sync(0xffffffffu, incl, 2 * MAX_BANDS - 1);
  const int n_all = __shfl_sync(0xffffffffu, incl, 31);
  const int excl = incl - cnt;
  const bool left = band < MAX_BANDS;
  const int col0 = left ? CENTER - n_left + excl : CENTER + 1 + excl - n_left;
  const int m_max = max(M - 1, 0);
  for (int r = 0; r < cnt; ++r) {
    const int col = col0 + r;
    if (col >= 0 && col < W && col != CENTER)
      col_site[col] = w.nbr_union[min(max(start + r, 0), m_max)];
  }
  if (lane == 0) {
    n_side[0] = n_left;
    n_side[1] = n_all - n_left;
  }
}

__global__ void __launch_bounds__(THREADS, 12)
snp_pileup_kernel(Wire w, Rows rows, float* __restrict__ out,
                  int32_t* __restrict__ soc_out, float* __restrict__ ref_out) {
  __shared__ int cnt[4 * W * 4];  // [g][w][c], c < 4
  __shared__ int col_site[W];     // union site, -1 padding
  __shared__ Col cols[W];
  __shared__ int col_ref[W];
  __shared__ Read list[LIST];
  __shared__ int csite[W];  // the non-centre valid columns' sites
  __shared__ int smp[SAMPLES];         // the selection's nbr_pos samples
  __shared__ int off[LIST], col_a[LIST];  // phase C's cells by read
  __shared__ int warp_sum[THREADS / 32];
  __shared__ int n_side[2];
  __shared__ int win[2];
  __shared__ int n_list;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const bool deep = rows.deep_rids != nullptr;
  const int cand = rows.cand_site[b];
  const float nm = rows.norm[b];
  // the centre's site: a candidate below 0 reads the trash site
  const int s_c = cand >= 0 ? cand : w.S;
  const int cref = w.site_ref[min(max(cand, 0), w.S - 1)];

  // phase A
  if (warp == 0) {
    for (int c = lane; c < W; c += 32) col_site[c] = c == CENTER ? cand : -1;
    __syncwarp();
    select_neighbours(w, rows.cand_pos[b], rows.lo_c[b], rows.hi_c[b], lane,
                      smp, col_site, n_side);
  } else if (warp == 1) {
    if (lane == 0) {
      if (deep) {
        win[1] = w.N > 0 ? min(rows.n_valid[b], rows.deep_w) : 0;
      } else {
        win[1] = w.win_hi[s_c];
      }
    } else if (lane == 1) {
      win[0] = deep ? 0 : w.win_lo[s_c];
    } else if (lane == 2) {
      load_col(w, s_c, &cols[CENTER]);
    } else if (lane == 3) {
      n_list = 0;
    }
  } else {
    for (int i = t - 64; i < 4 * W * 4; i += THREADS - 64) cnt[i] = 0;
  }
  __syncthreads();

  const int n_left = n_side[0];
  const int lo_col = CENTER - n_left;
  const int n_cols = n_left + 1 + n_side[1];  // the valid columns' range
  if (t >= THREADS - W) {
    const int col = t - (THREADS - W);
    const int s = col_site[col];
    soc_out[(size_t)b * W + col] = s;
    if (col != CENTER) load_col(w, s >= 0 ? s : w.S, &cols[col]);
    col_ref[col] = s >= 0 ? w.site_ref[min(s, w.S - 1)] : 4;
    if (col != CENTER && col >= lo_col && col < lo_col + n_cols)
      csite[col - lo_col - (col > CENTER)] = s;
  }
  const int k0 = win[0];
  const int k1 = win[1];
  for (int r0 = k0; r0 < k1; r0 += LIST) {
    // phase B: the centre codes of this round's reads
    const int r1 = min(r0 + LIST, k1);
    for (int i = r0 + t; i < r1; i += THREADS) {
      const int q = deep ? min(max(rows.deep_rids[(size_t)b * rows.deep_w + i],
                                   0), w.N - 1)
                         : w.order[i];
      const int lo = w.read_lo[q];
      const int hi = w.read_hi[q];
      const int base = w.span_start[q] - lo;
      if (s_c < lo || s_c > hi) continue;
      const int bit = minor_bit(w, base, s_c);
      const int byte = w.T ? w.minor_bits[bit >> 3] : 0;
      const int g = covered_code(w, cols[CENTER], q, bit, byte);
      if (g < 4) {
        const int k = atomicAdd(&n_list, 1);
        list[k] = Read{q, g, lo, hi, base};
        atomicAdd(&cnt[(g * W + CENTER) * 4 + g], 1);
      }
    }
    __syncthreads();
    // phase C: the listed reads' other valid columns. Their sites do
    // not decrease from left to right (the selected neighbour indices
    // ascend and group_wire checks that nbr_union does not decrease), so
    // the columns a read covers are one range [a, a + len) of them: a
    // block scan numbers the cells read by read from off[k], and the
    // threads take them one each.
    const int m = n_cols - 1;
    const int n = n_list;
    int a[2], len[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * t + u;
      a[u] = len[u] = 0;
      if (k < n) {
        const Read& rd = list[k];
        a[u] = lower_bound(csite, 0, m, rd.lo);
        len[u] = lower_bound(csite, 0, m, rd.hi + 1) - a[u];
      }
    }
    const int mine = len[0] + len[1];
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, n_cells = 0;
#pragma unroll
    for (int v = 0; v < THREADS / 32; ++v) {
      const int x = warp_sum[v];
      before += v < warp ? x : 0;
      n_cells += x;
    }
    const int excl = before + incl - mine;
    if (2 * t < n) {
      off[2 * t] = excl;
      col_a[2 * t] = a[0];
    }
    if (2 * t + 1 < n) {
      off[2 * t + 1] = excl + len[0];
      col_a[2 * t + 1] = a[1];
    }
    __syncthreads();
    for (int e = t; e < n_cells; e += THREADS) {
      const int k = lower_bound(off, 0, n, e + 1) - 1;  // last off <= e
      const int j = col_a[k] + e - off[k];
      const int col = lo_col + j + (lo_col + j >= CENTER);
      const Read& rd = list[k];
      const int bit = minor_bit(w, rd.base, cols[col].s);
      const int byte = w.T ? w.minor_bits[bit >> 3] : 0;
      const int c = covered_code(w, cols[col], rd.q, bit, byte);
      if (c < 4) atomicAdd(&cnt[(rd.g * W + col) * 4 + c], 1);
    }
    if (r1 < k1) {
      __syncthreads();
      if (t == 0) n_list = 0;
    }
    __syncthreads();
  }
  if (k0 >= k1) __syncthreads();  // cols and col_ref for the epilogue

  if (t < 4) ref_out[(size_t)b * 4 + t] = cref == t ? 1.f : 0.f;
  // one (column, channel) pair a thread, its five rows
  float* o = out + (size_t)b * OUT_ROW;
  for (int p = t; p < W * 5; p += THREADS) {
    const int col = p / 5;
    const int c = p - col * 5;
    const int cr = col_ref[col];
    o[p] = (c < 4 && cr == c) ? 1.f : 0.f;
    if (c < 4) {
      const float f = cr == c ? -1.f : 1.f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        o[(g + 1) * W * 5 + p] =
            __fmul_rn(__fmul_rn((float)cnt[(g * W + col) * 4 + c], f), nm);
    } else {
      const bool valid = col_site[col] >= 0;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        o[(g + 1) * W * 5 + p] = (cref == g && valid) ? 1.f : 0.f;
    }
  }
}

}  // namespace

extern "C" int snp_pileup_launch(
    const int32_t* read_lo, const int32_t* read_hi, const int32_t* span_start,
    const int8_t* site_ref, const int8_t* site_major, const int8_t* site_minor,
    const uint8_t* minor_bits, const int32_t* exc_indptr,
    const int32_t* exc_rid, const int8_t* exc_code,
    const int32_t* hole_indptr, const int32_t* hole_rid, const int32_t* order,
    const int32_t* win_lo, const int32_t* win_hi, const int32_t* nbr_pos,
    const int32_t* nbr_union, const int32_t* bands, int N, int S, int T,
    int M, const int32_t* cand_site, const int32_t* cand_pos,
    const int32_t* lo_c, const int32_t* hi_c, const float* norm,
    const int32_t* deep_rids, const int32_t* n_valid, int deep_w, int B,
    float* out, int32_t* soc, float* ref, void* stream) {
  const Wire w{read_lo,     read_hi,  span_start, site_ref,  site_major,
               site_minor,  minor_bits, exc_indptr, exc_rid, exc_code,
               hole_indptr, hole_rid, order,      win_lo,    win_hi,
               nbr_pos,     nbr_union, bands,     N,         S,
               T,           M};
  const Rows rows{cand_site, cand_pos, lo_c, hi_c, norm, deep_rids, n_valid,
                  deep_w};
  snp_pileup_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(w, rows, out,
                                                             soc, ref);
  return (int)cudaGetLastError();
}
