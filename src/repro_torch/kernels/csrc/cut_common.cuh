// Pieces shared by the cut kernels (cut_kernels.cu) and the fused
// level-2 round (inner_round.cu): operand loads that accumulate in f32
// whatever the input type, warp and block sums in a fixed order, and the
// first pass of the deterministic two-pass mat-vec.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // cut rows held in registers per pass
constexpr int kChunkCols = 1024;  // columns of D per pass-1 block

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

// Sum of one value per thread of the block: warps by shuffles, then the
// warps' sums in order.  Every thread returns the same bits.  `red`
// holds kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Row r of a (P, n_chunks) partial buffer summed in a fixed order: the
// second pass of the two-pass mat-vec.
__device__ __forceinline__ float row_total(const float* partial, int r,
                                           int n_chunks, float* red) {
  const float* row = partial + static_cast<long long>(r) * n_chunks;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_chunks; i += kThreads) s += row[i];
  return block_sum(s, red);
}

// The first pass of A @ x for this block's chunk of D: up to kRows row
// sums in registers per sweep, reduced by warp shuffles and a fixed-order
// pass over the warps into partial[(row, blockIdx.x)].  `x(col)` gives
// the vector's entry at a column of the chunk.
template <typename TA, typename X>
__device__ __forceinline__ void chunk_matvec(const TA* __restrict__ a, X x,
                                             float* __restrict__ partial,
                                             int p, long long d,
                                             int n_chunks) {
  __shared__ float red[kWarps][kRows];
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunkCols;
  const long long c1 = min(c0 + kChunkCols, d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < p; p0 += kRows) {
    const int nr = min(kRows, p - p0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (long long col = c0 + threadIdx.x; col < c1; col += kThreads) {
      const float xc = x(col);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) acc[r] += ld(a, (p0 + r) * d + col) * xc;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) red[warp][r] = s;
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      partial[static_cast<long long>(p0 + threadIdx.x) * n_chunks
              + blockIdx.x] = s;
    }
    __syncthreads();
  }
}

int n_chunks_of(long long d) {
  return static_cast<int>((d + kChunkCols - 1) / kChunkCols);
}

}  // namespace
