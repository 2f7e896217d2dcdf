// Staging a row of bytes from global into shared memory, for K4
// (nw_cigar.cu) and K5 (snp_dense_pileup.cu): the row keeps its address
// mod 16 in shared memory, so that its 16-byte-aligned body goes by
// cp.async (asynchronous 16-byte copies, all in flight together and
// completed by cp_async_wait_all) and only the under-16-byte head and
// tail need byte loads. Rows start at b * (row length), which is not
// 16-byte aligned in general.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__host__ __device__ constexpr int rup16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n bytes of src staged at buf + (src mod 16), buf 16-byte aligned: the
// 16-byte-aligned body by cp.async (body(), thread t of nt), the head
// before it and the tail after it (each under 16 bytes) by byte copies
// (edge(): lanes 0-15 the head, 16-31 the tail; the caller loads every
// edge byte it copies before it stores any, so that the loads overlap).
struct Span {
  const uint8_t* src;
  uint8_t* dst;
  int n, head, nb;
  __device__ Span(const void* s, int n_, uint8_t* buf)
      : src(static_cast<const uint8_t*>(s)), n(n_) {
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
    dst = buf + off;
    head = min((16 - off) & 15, n);
    nb = (n - head) >> 4;
  }
  __device__ void body(int t, int nt) const {
    for (int i = t; i < nb; i += nt)
      cp_async16(dst + head + 16 * i, src + head + 16 * i);
  }
  // the edge byte lane l copies, or -1
  __device__ int edge(int l) const {
    const int i = l < 16 ? l : head + 16 * nb + l - 16;
    return (l < 16 ? l < head : i < n) ? i : -1;
  }
};
