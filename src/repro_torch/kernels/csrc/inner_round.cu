// Hand-written Hopper kernel for one fused level-2 inner-ADMM cut round.
//
// It replaces the Pallas TPU kernel _round_kernel
// (src/repro/kernels/inner_round.py:53) and computes, for the cut matrix
// A (P, D) and the flattened point v (D,):
//
//   cv0     = (A v - c) * active
//   viol    = (cv0 + s) * active
//   w       = (gamma + rho2 viol) * active
//   v_new   = v - eta_z (g_other + (w^T A) * mask)          (D,)
//   cv1     = (A v_new - c) * active
//   s'      = max(0, s - eta_s (gamma + rho2 (cv1 + s)) * active) * active
//   gamma'  = max(0, gamma + eta_dual (cv1 + s')) * active
//
// Bound by device-memory bytes: P is tiny (8 cut slots at the white-wine
// width, 2 for domain adaptation) and D wide (242,628 and 925,590), so A
// and the four D-vectors (v, g_other, mask in; v_new out) dominate.  The
// round needs A twice: the second mat-vec reads v_new, which depends on
// the first's result through every column.
//
// The TPU kernel keeps the phase-0 sum and the weights in VMEM across a
// grid that runs in order on one core.  Hopper's blocks run concurrently,
// so the phase boundary is a launch boundary, three launches on one
// stream:
//
//   1. round_mv:     per 1,024-column chunk, the partial sums of A v
//                    (the first pass of cut_matvec, shared code).
//   2. round_update: every block first sums the partials of each row in
//                    one fixed order (the same bits in every block) and
//                    forms w; then, for its chunk, g_cut = w^T A column
//                    by column (rows in order), writes v_new, keeps it in
//                    shared memory and writes the partial sums of A v_new.
//   3. round_finish: one block sums those partials per row in a fixed
//                    order and applies the cv1 / s' / gamma' epilogue.
//
// No atomics anywhere: the result is bitwise identical run to run, which
// the replay and resume contracts rely on.  The step scalars are kernel
// arguments.  A is f32 or bf16, the vectors and rows f32, and every sum
// is taken in f32.  The launcher returns cudaGetLastError() after each
// launch so the caller raises on a refused launch; outputs and the
// (2, P, n_chunks) scratch come from the caller.

#include "cut_common.cuh"

namespace {

// Cut rows the update pass keeps weights for in shared memory.
constexpr int kMaxRows = 4096;

struct Steps {
  float eta_z, eta_s, eta_dual, rho2;
};

// max(0, x) as torch.maximum / jnp.maximum give it: NaN propagates.
__device__ __forceinline__ float relu_nan(float x) {
  return (x != x) ? x : fmaxf(0.f, x);
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
round_mv(const TA* __restrict__ a, const float* __restrict__ v,
         float* __restrict__ partial, int p, long long d, int n_chunks) {
  chunk_matvec(a, [v](long long col) { return ld(v, col); }, partial, p, d,
               n_chunks);
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
round_update(const TA* __restrict__ a, const float* __restrict__ v,
             const float* __restrict__ g_other,
             const float* __restrict__ mask, const float* __restrict__ c,
             const float* __restrict__ active, const float* __restrict__ s,
             const float* __restrict__ gamma,
             const float* __restrict__ partial0, float* __restrict__ v_new,
             float* __restrict__ partial1, int p, long long d, int n_chunks,
             Steps k) {
  extern __shared__ float smem[];
  float* w = smem;              // (p,) weights
  float* vn = smem + p;         // (kChunkCols,) this chunk's v_new
  __shared__ float red[kWarps];

  for (int r = 0; r < p; ++r) {
    const float mv = row_total(partial0, r, n_chunks, red);
    if (threadIdx.x == 0) {
      const float act = active[r];
      const float cv0 = (mv - c[r]) * act;
      const float viol = (cv0 + s[r]) * act;
      w[r] = (gamma[r] + k.rho2 * viol) * act;
    }
  }
  __syncthreads();

  const long long c0 = static_cast<long long>(blockIdx.x) * kChunkCols;
  const long long c1 = min(c0 + kChunkCols, d);
  for (long long col = c0 + threadIdx.x; col < c1; col += kThreads) {
    float g_cut = 0.f;
    for (int r = 0; r < p; ++r) g_cut += w[r] * ld(a, r * d + col);
    const float x = ld(v, col)
        - k.eta_z * (ld(g_other, col) + g_cut * ld(mask, col));
    v_new[col] = x;
    vn[col - c0] = x;
  }
  __syncthreads();
  // v_new is read back from shared memory, never through the read-only
  // cache path that `ld` uses for inputs
  chunk_matvec(a, [vn, c0](long long col) { return vn[col - c0]; },
               partial1, p, d, n_chunks);
}

__global__ void __launch_bounds__(kThreads)
round_finish(const float* __restrict__ partial1, const float* __restrict__ c,
             const float* __restrict__ active, const float* __restrict__ s,
             const float* __restrict__ gamma, float* __restrict__ cv1,
             float* __restrict__ s_new, float* __restrict__ gamma_new,
             int p, int n_chunks, Steps k) {
  __shared__ float red[kWarps];
  for (int r = 0; r < p; ++r) {
    const float mv = row_total(partial1, r, n_chunks, red);
    if (threadIdx.x == 0) {
      const float act = active[r];
      const float sr = s[r];
      const float gr = gamma[r];
      const float cv = (mv - c[r]) * act;
      const float g_s = (gr + k.rho2 * (cv + sr)) * act;
      const float sn = relu_nan(sr - k.eta_s * g_s) * act;
      cv1[r] = cv;
      s_new[r] = sn;
      gamma_new[r] = relu_nan(gr + k.eta_dual * (cv + sn)) * act;
    }
  }
}

template <typename TA>
cudaError_t launch_round(const void* a_, const float* v,
                         const float* g_other, const float* mask,
                         const float* c, const float* active, const float* s,
                         const float* gamma, float* scratch, float* v_new,
                         float* cv1, float* s_new, float* gamma_new, int p,
                         long long d, Steps k, cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(a_);
  const int n_chunks = n_chunks_of(d);
  float* partial0 = scratch;
  float* partial1 = scratch + static_cast<long long>(p) * n_chunks;
  round_mv<TA><<<n_chunks, kThreads, 0, stream>>>(a, v, partial0, p, d,
                                                  n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(p + kChunkCols) * sizeof(float);
  round_update<TA><<<n_chunks, kThreads, smem, stream>>>(
      a, v, g_other, mask, c, active, s, gamma, partial0, v_new, partial1, p,
      d, n_chunks, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  round_finish<<<1, kThreads, 0, stream>>>(partial1, c, active, s, gamma,
                                           cv1, s_new, gamma_new, p,
                                           n_chunks, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most cut rows one call takes; the wrapper checks P against it.
int fused_cut_round_max_rows() { return kMaxRows; }

// Floats of scratch one call needs: two (P, n_chunks) partial buffers.
long long fused_cut_round_scratch(int p, long long d) {
  return 2LL * p * n_chunks_of(d);
}

int fused_cut_round(const void* a, int a_bf16, const float* v,
                    const float* g_other, const float* mask, const float* c,
                    const float* active, const float* s, const float* gamma,
                    float* scratch, float* v_new, float* cv1, float* s_new,
                    float* gamma_new, int p, long long d, float eta_z,
                    float eta_s, float eta_dual, float rho2, void* stream) {
  if (p < 1 || p > kMaxRows || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Steps k{eta_z, eta_s, eta_dual, rho2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      a_bf16 ? launch_round<__nv_bfloat16>(a, v, g_other, mask, c, active,
                                           s, gamma, scratch, v_new, cv1,
                                           s_new, gamma_new, p, d, k, st)
             : launch_round<float>(a, v, g_other, mask, c, active, s, gamma,
                                   scratch, v_new, cv1, s_new, gamma_new, p,
                                   d, k, st);
  return static_cast<int>(err);
}

}  // extern "C"
