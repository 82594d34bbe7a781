// Hand-written Hopper kernel for blockwise (flash) GQA attention, forward.
//
// It replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:26) and computes, for q (B,S,H,hd)
// and k/v (B,T,Hkv,hd) in that public layout (no transposed copies):
//
//   out[b,s,h] = softmax_t( q[b,s,h] . k[b,t,kv] / sqrt(hd) + mask ) v[b,t,kv]
//
// with kv = h / (H / Hkv) (GQA: no KV replication) and the online-softmax
// running max m, denominator l and accumulator acc of the TPU kernel.
// Causal inputs are masked on absolute positions: key t <= query s, and
// s - t < window when window > 0; a masked score is the finite -2^20 of
// the reference, so masked rows behave as there.  Non-causal inputs are
// not masked (the window applies only with causal, as in the reference
// oracle flash_attention_ref).  The output is divided by max(l, 1e-30) and
// written in q's type.
//
// The TPU grid (B, H, q_blocks, k_blocks) carries m / l / acc across a
// sequential k axis in VMEM.  Hopper's blocks run in parallel, so one
// block owns one (b, h, 64-row q tile) and loops over 32-key tiles
// itself; m and l live in registers (each thread owns 4 query rows, and
// the 8 lanes that share a row reduce by shuffles), acc in registers
// (4 rows x hd/8 columns per thread).  The scaled q tile, the k tile
// (transposed) and the v tile sit in shared memory in f32; the tile of
// probabilities p passes through shared memory from the score layout to
// the p @ v layout (within one warp, so no block barrier).  Key tiles
// wholly above the diagonal or below the window are skipped: a row whose
// earlier tiles were all masked is erased by alpha = exp(-2^20 - m) = 0,
// as in the TPU kernel.  Keys past T (ragged T) are excluded outright
// and query rows past S (ragged S) are computed but never written:
// bounds checks, no padded copies.
//
// Bound on this card: by operations.  At Llama-3 8B's prefill (B 4,
// S = T = 1024, H 32, Hkv 8, hd 128, bf16) the causal half of q k^T and
// p v is 34 GFLOP (35 us on the tensor cores) against 84 MB of operands
// (25 us).  This first kernel does its products with f32 FMAs on the
// CUDA cores from shared memory (about 2.5 FMAs per shared load), so it
// sits far above that bound; wgmma on bf16 tiles is the redesign.
//
// Inputs f32 or bf16 (q, k, v of one type), f32 arithmetic throughout.
// The launcher returns cudaGetLastError() so the caller raises on a
// refused launch; the output comes from the caller.

#include "tile_common.cuh"

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column lanes
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // keys per tile
constexpr int kTX = 8;          // lanes that share a row
constexpr int kRowsPer = kBQ / (kThreads / kTX);   // 4 rows per thread
constexpr int kKeysPer = kBK / kTX;                // 4 keys per thread
constexpr float kMasked = -1048576.f;              // -2^20, as the reference

size_t flash_smem_floats(int hd) {
  return static_cast<size_t>(kBQ) * (hd + 1)       // scaled q tile
         + static_cast<size_t>(hd) * (kBK + 1)     // k tile, transposed
         + static_cast<size_t>(kBK) * hd           // v tile
         + static_cast<size_t>(kBQ) * (kBK + 1);   // probabilities
}

template <typename T, int HDM>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
          int H, int Hkv, int hd, int causal, int window, float scale) {
  constexpr int kCols = HDM / kTX;   // acc columns per thread
  extern __shared__ float smem[];
  const int qstride = hd + 1;
  float* qs = smem;
  float* kt = qs + kBQ * qstride;
  float* vs = kt + hd * (kBK + 1);
  float* ps = vs + kBK * hd;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int s = q0 + r;
    qs[r * qstride + d] =
        s < S ? to_f32(q, (static_cast<long long>(b) * S + s) * H * hd
                              + static_cast<long long>(h) * hd + d) * scale
              : 0.f;
  }

  float m_run[kRowsPer], l_run[kRowsPer], acc[kRowsPer][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // the key tiles this q tile needs
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_end = Tk;
  int k_begin = 0;
  if (causal) {
    k_end = min(Tk, q_last + 1);
    // with S > T some rows may have no key in the window; they keep
    // every key, as the reference does, so nothing is skipped below
    if (window > 0 && S <= Tk) k_begin = max(0, q0 - window + 1);
  }
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  const long long kv_base = static_cast<long long>(b) * Tk * kv_row
                            + static_cast<long long>(kh) * hd;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the q tile is in; the last tile's reads are done
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      const int t = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const long long off = kv_base + t * kv_row + d;
        kx = to_f32(k, off);
        vx = to_f32(v, off);
      }
      kt[d * (kBK + 1) + c] = kx;
      vs[c * hd + d] = vx;
    }
    __syncthreads();

    float sc[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) sc[i][j] = 0.f;
    }
    for (int d = 0; d < hd; ++d) {
      float qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        qv[i] = qs[(ty * kRowsPer + i) * qstride + d];
      }
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        kv[j] = kt[d * (kBK + 1) + tx + kTX * j];
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) sc[i][j] += qv[i] * kv[j];
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = ty * kRowsPer + i;
      const int s = q0 + row;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int t = k0 + tx + kTX * j;
        if (t >= Tk) {
          sc[i][j] = -INFINITY;     // no such key: weight exactly 0
        } else if (causal && (t > s || (window > 0 && t <= s - window))) {
          sc[i][j] = kMasked;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group_max<kTX>(mx);
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[row * (kBK + 1) + tx + kTX * j] = p;
        psum += p;
      }
      psum = group_sum<kTX>(psum);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    // a row's probabilities were written by the lanes of this warp only
    __syncwarp();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        pv[i] = ps[(ty * kRowsPer + i) * (kBK + 1) + kk];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + kTX * c;
        if (d < hd) {
          const float vx = vs[kk * hd + d];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][c] += pv[i] * vx;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int s = q0 + ty * kRowsPer + i;
    if (s >= S) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    const long long base = (static_cast<long long>(b) * S + s) * H * hd
                           + static_cast<long long>(h) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + kTX * c;
      if (d < hd) store(out, base + d, acc[i][c] / den);
    }
  }
}

template <typename T, int HDM>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int Tk, int H, int Hkv,
                         int hd, int causal, int window, float scale,
                         cudaStream_t stream) {
  const size_t smem = flash_smem_floats(hd) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd<T, HDM>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HDM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, Hkv, hd,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Tk, int H, int Hkv,
                           int hd, int causal, int window, float scale,
                           cudaStream_t stream) {
  if (hd <= 64) {
    return launch_flash<T, 64>(q, k, v, out, B, S, Tk, H, Hkv, hd, causal,
                               window, scale, stream);
  }
  if (hd <= 128) {
    return launch_flash<T, 128>(q, k, v, out, B, S, Tk, H, Hkv, hd, causal,
                                window, scale, stream);
  }
  return launch_flash<T, 256>(q, k, v, out, B, S, Tk, H, Hkv, hd, causal,
                              window, scale, stream);
}

}  // namespace

extern "C" {

// The largest head dimension the kernel takes.
int flash_attention_max_head_dim() { return 256; }

int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int bf16, int B, int S, int Tk, int H, int Hkv, int hd,
                    int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Tk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
      || hd < 1 || hd > 256 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_flash<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, Hkv,
                                           hd, causal, window, scale, st)
           : dispatch_flash<float>(q, k, v, out, B, S, Tk, H, Hkv, hd,
                                   causal, window, scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
