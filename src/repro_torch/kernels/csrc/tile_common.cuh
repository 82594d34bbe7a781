// Pieces shared by the LLM kernels (flash_attention.cu, mlstm_chunk.cu):
// loads that widen f32 or bf16 to f32, stores that narrow back to the
// operand type, and reductions over a group of neighbouring lanes of a
// warp (the lanes that together hold one row of a register tile).
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

// Ask for `bytes` of dynamic shared memory for `kernel`; above 48 KB the
// launch is refused without this.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
