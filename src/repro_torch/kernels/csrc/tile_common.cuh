// Pieces shared by the LLM kernels (flash_attention.cu, mlstm_chunk.cu,
// mlstm_chunk_sm90.cu): loads that widen f32 or bf16 to f32, stores that
// narrow back to the operand type, reductions over a group of
// neighbouring lanes of a warp (the lanes that together hold one row of
// a register tile), and the mLSTM chunk's gate scan.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float to_f32(const __nv_bfloat16* p,
                                        long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, long long i, float x) {
  p[i] = x;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float x) {
  p[i] = __float2bfloat16(x);
}

// Max / sum over the `Width` neighbouring lanes that share a row (Width a
// power of two dividing 32); every lane of the group gets the result.
template <int Width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < Width; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

template <int Width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < Width; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Inclusive cumulative sum of lf[0, L) into bcum, and li copied beside
// it, in a fixed order: the gates are staged in shared memory by the
// whole block, then each lane of warp 0 sums a contiguous segment and a
// shuffle scan of the segment totals offsets the segments.  Ends with a
// barrier.  Run by all `Threads` threads of the block.
template <int Threads>
__device__ __forceinline__ void log_gates(const float* __restrict__ li,
                                          const float* __restrict__ lf,
                                          float* bcum, float* lis, int L) {
  for (int s = threadIdx.x; s < L; s += Threads) {
    lis[s] = __ldg(li + s);
    bcum[s] = __ldg(lf + s);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int seg = (L + 31) / 32;
    const int lo = min(L, lane * seg);
    const int hi = min(L, lo + seg);
    float acc = 0.f;
    for (int s = lo; s < hi; ++s) {
      acc += bcum[s];
      bcum[s] = acc;
    }
    float incl = acc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float offset = incl - acc;
    for (int s = lo; s < hi; ++s) bcum[s] += offset;
  }
  __syncthreads();
}

// Ask for `bytes` of dynamic shared memory for `kernel`; above 48 KB the
// launch is refused without this.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
