// Hand-written Hopper kernel for one chunk of chunkwise-parallel mLSTM
// (xLSTM's matrix-memory mixer), on the CUDA cores: the route of f32 and
// of head dims the tensor-core kernel (mlstm_chunk_sm90.cu) does not
// take (the "SIMT kernel").
//
// It replaces the Pallas TPU kernel _mlstm_chunk_kernel
// (src/repro/kernels/mlstm_chunk.py:25).  Per (batch, head), for a chunk
// of L tokens with q/k/v (L, hd), log input / forget gates li/lf (L,) and
// the carried state C (hd, hd), n (hd,), m:
//
//   bcum_t  = lf_0 + ... + lf_t                     (inclusive)
//   D_ts    = bcum_t - bcum_s + li_s  for s <= t    (else -inf)
//   m_t     = max(bcum_t + m, max_s D_ts)
//   w_t     = e^(bcum_t + m - m_t)
//   y_t     = [ sum_s (q_t.k_s) e^(D_ts - m_t) v_s + w_t q_t C ]
//             / max(|sum_s (q_t.k_s) e^(D_ts - m_t) + w_t q_t.n|, e^-m_t)
//   m'      = max(btot + m, max_s (btot - bcum_s + li_s)),  btot = bcum_L-1
//   w_s     = e^(btot - bcum_s + li_s - m')
//   C'      = C e^(btot + m - m') + sum_s w_s k_s v_s^T
//   n'      = n e^(btot + m - m') + sum_s w_s k_s
//
// with q scaled by 1/sqrt(hd).  The TPU kernel runs one program per
// (b, h) with C resident in VMEM and the (L, L) decay matrix as one MXU
// tile.  At xLSTM-125M (hd = 192, L = 256) C alone is 144 KB in f32 and
// the decay matrix 256 KB, and B*H is 16 pairs for 132 SMs, so the work
// is split into two launches on one stream instead:
//
//   1. mlstm_y:     one block per (b, h, 32-row tile of the chunk, 64-column
//                   slab of y).  It forms bcum (a fixed-order scan), each
//                   row's m_t, then q C on its slab (C streamed through
//                   shared memory in 32-row tiles) and the decayed
//                   intra-chunk product over the key tiles up to the
//                   diagonal (scores over the whole head dim, recomputed
//                   by each slab: three times the blocks, enough warps
//                   per SM to hide latency), and writes its slab of y.
//                   The decay matrix is never stored: each weight is
//                   formed where it is used.
//   2. mlstm_state: one block per (b, h, 32 x 64 tile of C'): the decay
//                   weights of the chunk, then (k w_k)^T v over the chunk
//                   streamed in 32-key tiles; the blocks of the first
//                   column tile also sum n' from the same tiles, the
//                   first block writes m'.
//
// Both accumulate in f32 from f32 or bf16 q/k/v with f32 FMAs on the CUDA
// cores; y is written in q's type, the state in f32.  No atomics: the
// result is the same bits run to run.  Bound on this card: by operations.
// At xLSTM-125M's chunk (B 4, H 4, L 256, hd 192, bf16) the products are
// 1.0 GFLOP: the f32 q C (0.30 GFLOP, 4.5 us at the f32 rate) and the
// bf16 q k^T, p v and k^T v (0.71 GFLOP, 0.7 us on the tensor cores),
// against 11 MB of operands and results (3.3 us).  The launcher returns
// cudaGetLastError() after each launch; outputs come from the caller.

#include "tile_common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kTX = 16;         // lanes that share a row
constexpr int kTR = 32;         // chunk rows (launch 1) / C rows (launch 2)
constexpr int kTS = 32;         // keys per streamed tile
constexpr int kTE = 64;         // C columns per launch-2 block
constexpr int kRowsPer = kTR / (kThreads / kTX);   // 4 rows per thread
constexpr int kKeysPer = kTS / kTX;                // 2 keys per thread
constexpr int kWarps = kThreads / 32;

size_t y_smem_floats(int L, int hd) {
  return 2 * static_cast<size_t>(L)                 // bcum, li
         + static_cast<size_t>(kTR) * (hd + 1)      // scaled q rows
         + static_cast<size_t>(hd) * (kTS + 1)      // k tile, transposed
         + static_cast<size_t>(kTS) * kTE           // v tile / C rows, slab
         + static_cast<size_t>(kTR) * (kTS + 1);    // decayed scores
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_y(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ li,
        const float* __restrict__ lf, const float* __restrict__ c,
        const float* __restrict__ n, const float* __restrict__ m,
        T* __restrict__ y, int L, int hd, float scale) {
  constexpr int kCols = kTE / kTX;   // y columns per thread
  extern __shared__ float smem[];
  const int qstride = hd + 1;
  float* bcum = smem;
  float* lis = bcum + L;
  float* qs = lis + L;
  float* kt = qs + kTR * qstride;
  float* vs = kt + hd * (kTS + 1);
  float* ps = vs + kTS * kTE;

  const int r0 = blockIdx.x * kTR;
  const int bh = blockIdx.y;
  const int e0 = blockIdx.z * kTE;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const long long seq = static_cast<long long>(bh) * L * hd;
  const float m_prev = m[bh];

  for (int i = tid; i < kTR * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    qs[r * qstride + d] =
        r0 + r < L ? to_f32(q, seq + static_cast<long long>(r0 + r) * hd + d)
                         * scale
                   : 0.f;
  }
  log_gates<kThreads>(li + static_cast<long long>(bh) * L,
                      lf + static_cast<long long>(bh) * L, bcum, lis, L);

  // each row's stabilizer m_t and inter-chunk weight
  float m_t[kRowsPer], w_inter[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int t = min(r0 + ty * kRowsPer + i, L - 1);
    float mx = -INFINITY;
    for (int s = tx; s <= t; s += kTX) {
      mx = fmaxf(mx, (bcum[t] - bcum[s]) + lis[s]);
    }
    mx = group_max<kTX>(mx);
    const float m_inter = bcum[t] + m_prev;
    m_t[i] = fmaxf(m_inter, mx);
    w_inter[i] = expf(m_inter - m_t[i]);
  }

  float acc[kRowsPer][kCols];
  float den[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  // inter-chunk term: q C on this slab's columns and q . n, scaled by
  // w_inter
  const float* cb = c + static_cast<long long>(bh) * hd * hd;
  const float* nb = n + static_cast<long long>(bh) * hd;
  for (int d0 = 0; d0 < hd; d0 += kTS) {
    __syncthreads();
    for (int i = tid; i < kTS * kTE; i += kThreads) {
      const int dd = i / kTE;
      const int ee = i - dd * kTE;
      vs[i] = d0 + dd < hd && e0 + ee < hd
                  ? __ldg(cb + static_cast<long long>(d0 + dd) * hd + e0 + ee)
                  : 0.f;
    }
    __syncthreads();
    const int nd = min(kTS, hd - d0);
    for (int dd = 0; dd < nd; ++dd) {
      float qv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        qv[i] = qs[(ty * kRowsPer + i) * qstride + d0 + dd];
      }
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const float cx = vs[dd * kTE + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) acc[i][e] += qv[i] * cx;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    float qn = 0.f;
    for (int d = tx; d < hd; d += kTX) {
      qn += qs[(ty * kRowsPer + i) * qstride + d] * __ldg(nb + d);
    }
    den[i] = group_sum<kTX>(qn) * w_inter[i];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] *= w_inter[i];
  }

  // intra-chunk term over the key tiles up to this tile's last row: the
  // scores over the whole head dim, v on this slab's columns
  float den_intra[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) den_intra[i] = 0.f;
  const int s_end = min(r0 + kTR, L);
  for (int s0 = 0; s0 < s_end; s0 += kTS) {
    __syncthreads();
    for (int i = tid; i < kTS * hd; i += kThreads) {
      const int cc = i / hd;
      const int d = i - cc * hd;
      const int s = s0 + cc;
      kt[d * (kTS + 1) + cc] =
          s < L ? to_f32(k, seq + static_cast<long long>(s) * hd + d) : 0.f;
    }
    for (int i = tid; i < kTS * kTE; i += kThreads) {
      const int cc = i / kTE;
      const int ee = i - cc * kTE;
      const int s = s0 + cc;
      vs[i] = s < L && e0 + ee < hd
                  ? to_f32(v, seq + static_cast<long long>(s) * hd + e0 + ee)
                  : 0.f;
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
        kv[j] = kt[d * (kTS + 1) + tx + kTX * j];
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
      const int t = r0 + row;
#pragma unroll
      for (int j = 0; j < kKeysPer; ++j) {
        const int s = s0 + tx + kTX * j;
        float p = 0.f;
        if (t < L && s <= t) {
          p = sc[i][j] * expf((bcum[t] - bcum[s]) + lis[s] - m_t[i]);
        }
        ps[row * (kTS + 1) + tx + kTX * j] = p;
        den_intra[i] += p;
      }
    }
    // a row's weights were written by the lanes of this warp only
    __syncwarp();
    for (int ss = 0; ss < kTS; ++ss) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        pv[i] = ps[(ty * kRowsPer + i) * (kTS + 1) + ss];
      }
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const float vx = vs[ss * kTE + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) acc[i][e] += pv[i] * vx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int t = r0 + ty * kRowsPer + i;
    const float dsum = group_sum<kTX>(den_intra[i]) + den[i];
    const float dn = fmaxf(fabsf(dsum), expf(-m_t[i]));
    if (t >= L) continue;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = e0 + tx + kTX * e;
      if (col < hd) store(y, seq + static_cast<long long>(t) * hd + col,
                          acc[i][e] / dn);
    }
  }
}

size_t state_smem_floats(int L) {
  return 2 * static_cast<size_t>(L)              // bcum, li (then w_k)
         + static_cast<size_t>(kTS) * (kTR + 1)  // k w_k tile
         + static_cast<size_t>(kTS) * kTE        // v tile
         + kWarps;                               // block max
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_state(const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ li, const float* __restrict__ lf,
            const float* __restrict__ c, const float* __restrict__ n,
            const float* __restrict__ m, float* __restrict__ c_out,
            float* __restrict__ n_out, float* __restrict__ m_out, int L,
            int hd) {
  extern __shared__ float smem[];
  float* bcum = smem;
  float* wk = bcum + L;           // li, then the decay weights w_k
  float* kw = wk + L;
  float* vs = kw + kTS * (kTR + 1);
  float* red = vs + kTS * kTE;

  const int d0 = blockIdx.x * kTR;
  const int e0 = blockIdx.y * kTE;
  const int bh = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const long long seq = static_cast<long long>(bh) * L * hd;
  const float m_prev = m[bh];

  log_gates<kThreads>(li + static_cast<long long>(bh) * L,
                      lf + static_cast<long long>(bh) * L, bcum, wk, L);
  const float btot = bcum[L - 1];
  float mx = -INFINITY;
  for (int s = tid; s < L; s += kThreads) {
    const float a = (btot - bcum[s]) + wk[s];
    wk[s] = a;
    mx = fmaxf(mx, a);
  }
  mx = group_max<32>(mx);
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  const float m_new = fmaxf(btot + m_prev, mx);
  const float w_c = expf(btot + m_prev - m_new);
  for (int s = tid; s < L; s += kThreads) wk[s] = expf(wk[s] - m_new);

  float acc[kRowsPer][kTE / kTX];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
    for (int e = 0; e < kTE / kTX; ++e) acc[i][e] = 0.f;
  }
  // n' for row d0 + tid, summed in key order by the first column tile
  const bool n_row = blockIdx.y == 0 && tid < kTR;
  float n_acc = 0.f;
  for (int s0 = 0; s0 < L; s0 += kTS) {
    __syncthreads();   // w_k is complete; the last tile's reads are done
    for (int i = tid; i < kTS * kTR; i += kThreads) {
      const int ss = i / kTR;
      const int dd = i - ss * kTR;
      const int s = s0 + ss;
      kw[ss * (kTR + 1) + dd] =
          s < L && d0 + dd < hd
              ? to_f32(k, seq + static_cast<long long>(s) * hd + d0 + dd)
                    * wk[s]
              : 0.f;
    }
    for (int i = tid; i < kTS * kTE; i += kThreads) {
      const int ss = i / kTE;
      const int ee = i - ss * kTE;
      const int s = s0 + ss;
      vs[ss * kTE + ee] =
          s < L && e0 + ee < hd
              ? to_f32(v, seq + static_cast<long long>(s) * hd + e0 + ee)
              : 0.f;
    }
    __syncthreads();
    const int ns = min(kTS, L - s0);
    if (n_row) {
      for (int ss = 0; ss < ns; ++ss) n_acc += kw[ss * (kTR + 1) + tid];
    }
    for (int ss = 0; ss < ns; ++ss) {
      float kv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        kv[i] = kw[ss * (kTR + 1) + ty * kRowsPer + i];
      }
#pragma unroll
      for (int e = 0; e < kTE / kTX; ++e) {
        const float vx = vs[ss * kTE + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) acc[i][e] += kv[i] * vx;
      }
    }
  }

  const long long cbase = static_cast<long long>(bh) * hd * hd;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int d = d0 + ty * kRowsPer + i;
    if (d >= hd) continue;
#pragma unroll
    for (int e = 0; e < kTE / kTX; ++e) {
      const int col = e0 + tx + kTX * e;
      if (col < hd) {
        const long long off = cbase + static_cast<long long>(d) * hd + col;
        c_out[off] = __ldg(c + off) * w_c + acc[i][e];
      }
    }
  }
  if (n_row && d0 + tid < hd) {
    const long long off = static_cast<long long>(bh) * hd + d0 + tid;
    n_out[off] = __ldg(n + off) * w_c + n_acc;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) m_out[bh] = m_new;
}

template <typename T>
cudaError_t launch_mlstm(const void* q, const void* k, const void* v,
                         const float* li, const float* lf, const float* c,
                         const float* n, const float* m, void* y,
                         float* c_out, float* n_out, float* m_out, int BH,
                         int L, int hd, float scale, cudaStream_t stream) {
  const size_t smem_y = y_smem_floats(L, hd) * sizeof(float);
  cudaError_t err = allow_smem(mlstm_y<T>, smem_y);
  if (err != cudaSuccess) return err;
  const dim3 grid_y((L + kTR - 1) / kTR, BH, (hd + kTE - 1) / kTE);
  mlstm_y<T><<<grid_y, kThreads, smem_y, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), li, lf, c, n, m, static_cast<T*>(y), L, hd,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_s = state_smem_floats(L) * sizeof(float);
  err = allow_smem(mlstm_state<T>, smem_s);
  if (err != cudaSuccess) return err;
  const dim3 grid_s((hd + kTR - 1) / kTR, (hd + kTE - 1) / kTE, BH);
  mlstm_state<T><<<grid_s, kThreads, smem_s, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), li, lf, c, n, m,
      c_out, n_out, m_out, L, hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest head dimension and chunk length the kernel takes (the
// chunk is bounded by launch 1's shared memory).
int mlstm_chunk_simt_max_head_dim() { return 256; }

int mlstm_chunk_simt_max_len() { return 4096; }

int mlstm_chunk_simt(const void* q, const void* k, const void* v,
                     const float* li, const float* lf, const float* c,
                     const float* n, const float* m, void* y, float* c_out,
                     float* n_out, float* m_out, int bf16, int BH, int L,
                     int hd, float scale, void* stream) {
  if (BH < 1 || L < 1 || L > 4096 || hd < 1 || hd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_mlstm<__nv_bfloat16>(q, k, v, li, lf, c, n, m, y, c_out,
                                         n_out, m_out, BH, L, hd, scale, st)
           : launch_mlstm<float>(q, k, v, li, lf, c, n, m, y, c_out, n_out,
                                 m_out, BH, L, hd, scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
