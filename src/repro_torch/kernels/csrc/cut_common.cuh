// Pieces shared by the cut kernels (cut_kernels.cu) and the fused
// level-2 round (inner_round.cu): operand loads that accumulate in f32
// whatever the input type, row sums reduced in a fixed order, and the
// ticket that elects the block which finishes a cross-block sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace
