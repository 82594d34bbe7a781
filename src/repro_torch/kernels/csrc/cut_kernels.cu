// Hand-written Hopper kernels for the hyper-polyhedral cut contraction.
//
// They replace the three Pallas TPU kernels of the JAX package
// (src/repro/kernels/cut_eval.py):
//
//   cut_matvec  (P,)   = A @ v     replaces _matvec_kernel (cut_eval.py:60)
//   cut_vecmat  (D,)   = g^T A     replaces _vecmat_kernel (cut_eval.py:96)
//   cut_rank1   (P, D) = x y^T     replaces _rank1_kernel  (cut_eval.py:129)
//
// All three are bound by device-memory bytes: P is tiny (8 cuts on the
// paper's runs) and D wide (242,628 columns at the white-wine width), so
// each element of A is used for 2 flops.  The designs therefore read A
// once, coalesced along D, and accumulate in f32 whatever the input type.
//
// matvec: the TPU kernel carries its sum across a sequential grid axis,
// which Hopper's concurrently scheduled blocks cannot do.  Pass 1 gives
// each block one chunk of D; the block keeps up to 8 row sums in
// registers, reduces them with warp shuffles and a fixed-order pass over
// the warps, and writes one (P, n_chunks) f32 partial.  Pass 2 reduces
// each row's partials in a fixed order.  No atomics: results are bitwise
// identical run to run, which replay and resume contracts rely on.
//
// Each launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.  Kernels allocate nothing; the caller passes outputs
// and scratch.  Built for sm_90a with the other sources of this
// directory into one library by repro_torch/kernels/build.py.

#include "cut_common.cuh"

namespace {

template <typename TA, typename TV>
__global__ void __launch_bounds__(kThreads)
matvec_partial(const TA* __restrict__ a, const TV* __restrict__ v,
               float* __restrict__ partial, int p, long long d,
               int n_chunks) {
  chunk_matvec(a, [v](long long col) { return ld(v, col); }, partial, p, d,
               n_chunks);
}

// One block per cut row: the row's partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
matvec_finish(const float* __restrict__ partial, float* __restrict__ out,
              int n_chunks) {
  __shared__ float red[kWarps];
  const float t = row_total(partial, blockIdx.x, n_chunks, red);
  if (threadIdx.x == 0) out[blockIdx.x] = t;
}

// One thread per column, the P rows summed in order; loads of A are
// coalesced along D.
template <typename TG, typename TA>
__global__ void __launch_bounds__(kThreads)
vecmat_kernel(const TG* __restrict__ g, const TA* __restrict__ a,
              float* __restrict__ out, int p, long long d) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = static_cast<long long>(blockIdx.x) * kThreads
                       + threadIdx.x;
       col < d; col += stride) {
    float s = 0.f;
    for (int r = 0; r < p; ++r) s += ld(g, r) * ld(a, r * d + col);
    out[col] = s;
  }
}

// Elementwise, grid-stride along D (x) and the cut rows (y).
template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
             float* __restrict__ out, int p, long long d) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = blockIdx.y; r < p; r += gridDim.y) {
    const float xr = ld(x, r);
    float* row = out + static_cast<long long>(r) * d;
    for (long long col = static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x;
         col < d; col += stride) {
      row[col] = xr * ld(y, col);
    }
  }
}

unsigned grid_cols(long long d) {
  const long long blocks = (d + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
}

template <typename TA, typename TV>
cudaError_t launch_matvec(const void* a, const void* v, float* partial,
                          float* out, int p, long long d,
                          cudaStream_t stream) {
  const int n_chunks = n_chunks_of(d);
  matvec_partial<TA, TV><<<n_chunks, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TV*>(v), partial, p, d,
      n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  matvec_finish<<<p, kThreads, 0, stream>>>(partial, out, n_chunks);
  return cudaGetLastError();
}

template <typename TG, typename TA>
cudaError_t launch_vecmat(const void* g, const void* a, float* out, int p,
                          long long d, cudaStream_t stream) {
  vecmat_kernel<TG, TA><<<grid_cols(d), kThreads, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const TA*>(a), out, p, d);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_rank1(const void* x, const void* y, float* out, int p,
                         long long d, cudaStream_t stream) {
  const dim3 grid(grid_cols(d), static_cast<unsigned>(p < 65535 ? p : 65535));
  rank1_kernel<TX, TY><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), out, p, d);
  return cudaGetLastError();
}

// Instantiate F<T0, T1> for the two operand types (f32 = 0, bf16 = 1).
#define CUT_DISPATCH(F, bf0, bf1, ...)                                  \
  ((bf0) ? ((bf1) ? F<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__)        \
                  : F<__nv_bfloat16, float>(__VA_ARGS__))               \
         : ((bf1) ? F<float, __nv_bfloat16>(__VA_ARGS__)                \
                  : F<float, float>(__VA_ARGS__)))

}  // namespace

extern "C" {

// Columns of D each pass-1 block reduces: the wrapper sizes the
// (P, ceil(D / chunk)) f32 partial buffer from it.
int cut_matvec_chunk_cols() { return kChunkCols; }

int cut_matvec(const void* a, int a_bf16, const void* v, int v_bf16,
               float* partial, float* out, int p, long long d,
               void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_matvec, a_bf16, v_bf16, a, v,
                                       partial, out, p, d,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_vecmat(const void* g, int g_bf16, const void* a, int a_bf16,
               float* out, int p, long long d, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_vecmat, g_bf16, a_bf16, g, a,
                                       out, p, d,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_rank1(const void* x, int x_bf16, const void* y, int y_bf16,
              float* out, int p, long long d, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_rank1, x_bf16, y_bf16, x, y,
                                       out, p, d,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
