// Pieces shared by the cut kernels (cut_kernels.cu) and the fused
// level-2 round (inner_round.cu): operand loads that accumulate in f32
// whatever the input type, row sums reduced in a fixed order, the ticket
// that elects the block which finishes a cross-block sum, and the bulk
// copies (cp.async.bulk on an mbarrier) that bring slices of rows into
// shared memory.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // cut rows held in registers per sweep

__device__ __forceinline__ float ld(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// Up to kRows row sums of the block, one value per thread each, reduced
// by warp shuffles and then over the warps in order; thread r < nr
// returns row r's total.  Every block that sums the same values gets the
// same bits.
__device__ __forceinline__ float rows_sum(const float* acc, int nr,
                                          float (*red)[kRows]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0) red[warp][r] = s;
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < nr) {
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
  }
  __syncthreads();
  return s;
}

// Totals of rows p0 .. p0 + nr - 1 of a (P, n_blocks) partial buffer
// written by other blocks of this launch (read through L2): thread r < nr
// returns row p0 + r's, summed in one fixed order.  Partials i and i +
// kThreads of every row are loaded at once.
__device__ __forceinline__ float partial_totals(const float* partial,
                                                int p0, int nr, int n_blocks,
                                                float (*red)[kRows]) {
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += 2 * kThreads) {
    float x[2][kRows];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ih = i + h * kThreads;
        x[h][r] = r < nr && ih < n_blocks
                      ? __ldcg(partial + static_cast<long long>(p0 + r)
                                             * n_blocks + ih)
                      : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = acc[r] + x[0][r] + x[1][r];
  }
  return rows_sum(acc, nr, red);
}

// One acq_rel add to a counter in device memory; returns the value
// before.  After a __syncthreads, thread 0's add publishes the block's
// earlier writes (cumulatively) and orders its later reads after those of
// every block that added before it.
__device__ __forceinline__ int ticket_add(int* counter) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(before) : "l"(counter) : "memory");
  return before;
}

// A slice src[0 : len] of T, V = 16 / sizeof(T) entries to 16 bytes: it
// starts `mis` entries past a 16-byte boundary, then has a head of h < V
// entries, a 16-byte-aligned body of nb and a tail of fewer than V.
struct Span {
  int mis, h, nb;
};

template <typename T>
__device__ __forceinline__ Span span_of(const T* src, int len) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(
      reinterpret_cast<uintptr_t>(src) % 16 / sizeof(T));
  const int h = min(len, (V - mis) % V);
  return {mis, h, (len - h) / V * V};
}

template <typename T>
__device__ __forceinline__ uint32_t body_bytes(const T* src, int len) {
  return static_cast<uint32_t>(span_of(src, len).nb * sizeof(T));
}

// The body of src[0 : len] to dst + mis + h (dst 16-byte aligned, so the
// body lands 16-byte aligned) in one bulk copy completing on `bar`.
template <typename T>
__device__ __forceinline__ void bulk_body(T* dst, const T* src, int len,
                                          uint32_t bar) {
  const Span sp = span_of(src, len);
  if (sp.nb > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst + sp.mis + sp.h)), "l"(src + sp.h),
           "r"(static_cast<uint32_t>(sp.nb * sizeof(T))), "r"(bar)
        : "memory");
  }
}

// Index in src[0 : len] of entry e < 2V of its head (e < V) or its tail
// (e >= V), or -1 where the slice has no such entry.
template <typename T>
__device__ __forceinline__ int end_index(const T* src, int len, int e) {
  constexpr int V = 16 / sizeof(T);
  const Span sp = span_of(src, len);
  const int j = e < V ? e : sp.h + sp.nb + (e - V);
  return (e < V ? e < sp.h : j < len) ? j : -1;
}

// Entry e < 2V of the head or the tail of src[0 : len] to dst + mis,
// where the slice has one.
template <typename T>
__device__ __forceinline__ void copy_end(T* dst, const T* src, int len,
                                         int e) {
  const int j = end_index(src, len, e);
  if (j >= 0) dst[span_of(src, len).mis + j] = src[j];
}

// Spin until the counter reaches `target` (acquire); trap after
// kHangCycles rather than hang.
__device__ __forceinline__ void wait_count(const int* counter, int target) {
  const long long start = clock64();
  int x;
  do {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(x) : "l"(counter) : "memory");
    if (clock64() - start > kHangCycles) __trap();
  } while (x < target);
}

}  // namespace
