// Hand-written Hopper kernel for one chunk of chunkwise-parallel mLSTM
// (xLSTM's matrix-memory mixer) on the tensor cores: bf16 q, k, v at head
// dims 64, 128 and 192, f32 gates and state.
//
// It replaces the Pallas TPU kernel _mlstm_chunk_kernel
// (src/repro/kernels/mlstm_chunk.py:25) on the bf16 route; f32 and other
// head dims stay on the CUDA-core kernel of mlstm_chunk.cu (the "SIMT
// kernel"), whose header states the function computed: y in bf16, C', n'
// and m' in f32, ragged L without padding.
//
// Bound on this card: at xLSTM-125M's chunk (B 4, H 4, L 256, hd 192) the
// products are 1.0 GFLOP against 11 MB of operands and results (3.3 us).
// Counting q C at the f32 rate gives 5.2 us; on the tensor cores, as
// here, every product fits under the bytes.  One launch of two kinds of
// block (one warpgroup of 128 threads each), all in one wave at that
// shape, longest first:
//
// - "y" blocks, one per (b, h, 64-row q tile): 64 at xLSTM-125M.
//   acc = q C on wgmma m64nHDk16: q (bf16, K-major, by TMA) times C, read
//   in 64-row slabs as f32 and split in shared memory into two bf16
//   halves hi = bf16(C), lo = bf16(C - hi) (two products into one f32
//   accumulator keep about 16 bits of C), MN-major with the transpose
//   bit; the next slab is split while the current one multiplies.  acc
//   is scaled row-wise by w_inter / sqrt(hd).  Then for each 64-key tile
//   up to the diagonal (K and V by TMA through a two-stage mbarrier
//   ring): S = q k^T on wgmma m64n64k16, P = S e^(bcum_t - bcum_s + li_s -
//   m_t) / sqrt(hd) in registers (keys past the row, and rows and keys
//   past L, weigh exactly 0), P's f32 row sums into den_intra, P rounded
//   to bf16 in registers (the accumulator layout of S is the A-operand
//   layout of the next wgmma), acc += P V.  The stabiliser m_t depends on
//   the gates only, so no rescaling is needed between tiles.  Epilogue:
//   den = den_intra + (q . n) w_inter / sqrt(hd) (an f32 dot product),
//   y = acc / max(|den|, e^-m_t) in bf16 through shared memory and one
//   TMA store a box, which drops rows past L.
// - "state" blocks, one per (b, h, 64-row tile of C'): 48 at xLSTM-125M.
//   C' = C w_c + (k w_k)^T v on wgmma m64nHDk16 with both operands
//   MN-major: A = (k w_k)^T, staged by the threads from k with the
//   weights applied and split into bf16 hi and lo as C is (the next tile
//   while the current one multiplies), B = v by TMA.
//   n' = n w_c + sum_s w_s k_s sums f32 products in a fixed order from
//   the same staging; the first state block of each (b, h) writes m'.
// - Gates: bcum is the same fixed-order scan as the SIMT kernel's
//   (tile_common.cuh log_gates), and m_t, m', w_c and w_k are computed as
//   there.  No split over keys and no atomics: the result is the same
//   bits run to run.
//
// The launcher returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take, or a tensor map that cannot be
// encoded) so the caller raises; the outputs come from the caller.

#include "sm90_common.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kThreads = 128;            // one warpgroup
constexpr int kTileRows = 64;            // wgmma's M; q rows, keys, C rows
constexpr int kBox = kTileRows * kRowBytes;   // a 64-row box: 8 KB
// the longest chunk (gates in smem); mlstm_chunk.py SM90_MAX_LEN routes
// longer ones to the SIMT kernel
constexpr int kMaxLen = 512;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in the block's shared memory (from a 1024-byte-aligned
// base, as the 128-byte swizzle needs).  A y block uses: q (then y), two
// C slabs of hi and lo, the K and V rings, the gates and three floats a
// row.  A state block puts its two stages of (k w_k) hi and lo where the
// C slabs are, its n' partial sums where the K ring is, and uses the V
// ring and the gates.  At hd 192: 216 KB of tiles.
template <int HD>
struct Layout {
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kTile = kBoxes * kBox;   // 64 rows x hd
  static constexpr int kQ = 0;
  static constexpr int kC = kQ + kTile;         // 2 slabs x (hi, lo)
  static constexpr int kK = kC + 4 * kTile;
  static constexpr int kV = kK + 2 * kTile;
  static constexpr int kGates = kV + 2 * kTile;  // bcum, li: 2 x kMaxLen
  static constexpr int kRowF = kGates + 2 * kMaxLen * 4;  // 3 x 64 floats
  static constexpr int kBars = kRowF + 3 * kTileRows * 4;  // q, full[2]
  static constexpr int kAlloc = kBars + 8 * 3 + 1024;
  static_assert(kAlloc <= 232448, "shared memory of one block");
  static_assert(4 * kTile >= 4 * kBox, "state A stages fit the C slabs");
  static_assert(2 * kTile >= 16 * kTileRows * 4, "n' partials fit");
};

// Split 8 f32 values into bf16 hi = bf16(x) and lo = bf16(x - hi), each
// packed as 16 bytes (the first value at the lowest address).
__device__ __forceinline__ void split8(const float* x, uint4& hi,
                                      uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    h[i] = *reinterpret_cast<const uint32_t*>(&hb);
    l[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Byte offset of 16-byte chunk `ch` (0..7) of row r in a 128-byte-swizzled
// box.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * kRowBytes + ((ch ^ (r % 8)) << 4);
}

// Rows r0 .. r0 + 63 of this (b, h)'s C (f32, hd x hd), split into bf16 hi
// and lo boxes at `hi` and `lo`: row d of the slab, columns in hd / 64
// boxes of 64 (the MN-major B operand of q C).
template <int HD>
__device__ __forceinline__ void stage_c(const float* __restrict__ c, int r0,
                                        uint32_t hi, uint32_t lo) {
  constexpr int kChunks = HD / 8;   // 16-byte bf16 chunks a row
#pragma unroll 6
  for (int idx = threadIdx.x; idx < kTileRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int col = (idx % kChunks) * 8;
    const float4* src = reinterpret_cast<const float4*>(
        c + static_cast<long long>(r0 + r) * HD + col);
    const float4 a = __ldg(src);
    const float4 b = __ldg(src + 1);
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint4 h, l;
    split8(x, h, l);
    const uint32_t off = (col / kBoxCols) * kBox + swz(r, col % kBoxCols / 8);
    st_shared16(hi + off, h);
    st_shared16(lo + off, l);
  }
}

// Keys 64 j .. 64 j + 63 of k (bf16, L x hd), columns d0 .. d0 + 63,
// times their weights w (zero past L), split into bf16 hi and lo boxes
// (key s a row: the MN-major A operand (k w_k)^T); each thread adds its
// f32 products to nacc, the n' sums of its 8 columns.  Thread t always
// takes column chunk t % 8, keys t / 8 + 16 u.
template <int HD>
__device__ __forceinline__ void stage_kw(const __nv_bfloat16* __restrict__ k,
                                         const float* w, int L, int j,
                                         int d0, uint32_t hi, uint32_t lo,
                                         float* nacc) {
  const int ch = threadIdx.x % 8;
  uint4 raw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int s = 64 * j + threadIdx.x / 8 + 16 * u;
    raw[u] = s < L ? __ldg(reinterpret_cast<const uint4*>(
                         k + static_cast<long long>(s) * HD + d0 + 8 * ch))
                   : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = threadIdx.x / 8 + 16 * u;
    const float ws = w[64 * j + r];
    const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
    float x[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(kv[i]);
      x[2 * i] = f.x * ws;
      x[2 * i + 1] = f.y * ws;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) nacc[e] += x[e];
    uint4 h, l;
    split8(x, h, l);
    st_shared16(hi + swz(r, ch), h);
    st_shared16(lo + swz(r, ch), l);
  }
}

// Issue K and V (or V only) of key tile j into ring stage j % 2.
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        uint32_t k_ring, uint32_t v_ring,
                                        uint32_t full0, int j, int bh) {
  using Lt = Layout<HD>;
  const int s = j % 2;
  mbar_expect_tx(full0 + 8 * s, (tm_k != nullptr ? 2 : 1) * Lt::kTile);
  for (int x = 0; x < Lt::kBoxes; ++x) {
    if (tm_k != nullptr) {
      tma_load(k_ring + s * Lt::kTile + x * kBox, tm_k, full0 + 8 * s,
               x * kBoxCols, 0, 64 * j, bh);
    }
    tma_load(v_ring + s * Lt::kTile + x * kBox, tm_v, full0 + 8 * s,
             x * kBoxCols, 0, 64 * j, bh);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_y,
                        const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const float* __restrict__ li,
                        const float* __restrict__ lf,
                        const float* __restrict__ c,
                        const float* __restrict__ n,
                        const float* __restrict__ m,
                        float* __restrict__ c_out,
                        float* __restrict__ n_out,
                        float* __restrict__ m_out, int BH, int L,
                        float scale) {
  using Lt = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // generic view
  float* const bcum = reinterpret_cast<float*>(gbase + Lt::kGates);
  float* const gate = bcum + kMaxLen;   // li, then (state) the weights w_k
  float* const rowf = reinterpret_cast<float*>(gbase + Lt::kRowF);
  const uint32_t qbar = base + Lt::kBars;
  const uint32_t full0 = qbar + 8;
  const uint32_t k_ring = base + Lt::kK;
  const uint32_t v_ring = base + Lt::kV;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int r_a = warp * 16 + lane / 4;   // rows r_a and r_a + 8 of a tile
  const int n_qt = (L + kTileRows - 1) / kTileRows;
  const int n_y = n_qt * BH;
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) mbar_init(qbar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_y) {
    // ---- a y block: rows q0 .. q0 + 63 of (b, h), longest first ----
    const int bh = blockIdx.x % BH;
    const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kTileRows;
    const int n_kt = q0 / kTileRows + 1;   // key tiles up to the diagonal
    const long long seq = static_cast<long long>(bh) * L;
    if (tid == 0) {
      mbar_expect_tx(qbar, Lt::kTile);
      for (int x = 0; x < Lt::kBoxes; ++x) {
        tma_load(base + Lt::kQ + x * kBox, &tm_q, qbar, x * kBoxCols, 0, q0,
                 bh);
      }
      for (int j = 0; j < min(2, n_kt); ++j) {
        load_kv<HD>(&tm_k, &tm_v, k_ring, v_ring, full0, j, bh);
      }
    }
    log_gates<kThreads>(li + seq, lf + seq, bcum, gate, L);

    // each row's m_t and w_inter (two threads a row, as the SIMT kernel)
    // and its q . n, unscaled
    {
      const int row = tid / 2;
      const int half = tid % 2;
      const int t = min(q0 + row, L - 1);
      float mx = -INFINITY;
      for (int s = half; s <= t; s += 2) {
        mx = fmaxf(mx, (bcum[t] - bcum[s]) + gate[s]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_inter = bcum[t] + m[bh];
      const float m_t = fmaxf(m_inter, mx);
      float qn = 0.f;
      if (q0 + row < L) {
        const uint4* qr = reinterpret_cast<const uint4*>(
            q + (seq + q0 + row) * HD + half * (HD / 2));
        const float* nr = n + static_cast<long long>(bh) * HD + half * (HD / 2);
#pragma unroll 4
        for (int x = 0; x < HD / 16; ++x) {
          const uint4 raw8 = __ldg(qr + x);
          const __nv_bfloat162* p2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(p2[i]);
            qn += f.x * __ldg(nr + 8 * x + 2 * i)
                  + f.y * __ldg(nr + 8 * x + 2 * i + 1);
          }
        }
      }
      qn += __shfl_xor_sync(0xffffffffu, qn, 1);
      if (half == 0) {
        rowf[row] = m_t;
        rowf[kTileRows + row] = expf(m_inter - m_t);
        rowf[2 * kTileRows + row] = qn;
      }
    }

    // acc = q C over hd / 64 slabs of 64 rows of C, each split into bf16
    // hi and lo while the previous slab multiplies
    const float* cb = c + static_cast<long long>(bh) * HD * HD;
    stage_c<HD>(cb, 0, base + Lt::kC, base + Lt::kC + Lt::kTile);
    fence_proxy_async();
    __syncthreads();
    mbar_wait(qbar, 0);
    for (int i = 0; i < Lt::kBoxes; ++i) {
      const uint32_t hi = base + Lt::kC + (i % 2) * 2 * Lt::kTile;
      const uint32_t lo = hi + Lt::kTile;
      pin<HD / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = sw128_desc(base + Lt::kQ + i * kBox + kk * 32, 16,
                                      1024);
        wgmma_ss<HD, 0, 1>(acc, a,
                           sw128_desc(hi + kk * 16 * kRowBytes, kBox, 1024),
                           1);
        wgmma_ss<HD, 0, 1>(acc, a,
                           sw128_desc(lo + kk * 16 * kRowBytes, kBox, 1024),
                           1);
      }
      wgmma_commit();
      if (i + 1 < Lt::kBoxes) {
        const uint32_t nhi = base + Lt::kC + ((i + 1) % 2) * 2 * Lt::kTile;
        stage_c<HD>(cb, 64 * (i + 1), nhi, nhi + Lt::kTile);
        fence_proxy_async();
      }
      wgmma_wait_all();
      pin<HD / 2>(acc);
      __syncthreads();
    }

    // this thread's rows: scale q C by w_inter / sqrt(hd)
    float bt[2], mt[2], den[2] = {0.f, 0.f};
    int t_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r_a + 8 * i;
      t_row[i] = q0 + rr;
      bt[i] = bcum[min(t_row[i], L - 1)];
      mt[i] = rowf[rr];
      const float w = rowf[kTileRows + rr] * scale;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        acc[4 * jj + 2 * i] *= w;
        acc[4 * jj + 2 * i + 1] *= w;
      }
    }

    // the decayed intra-chunk product, key tile by key tile
    float sacc[32];
    uint32_t pa[16];
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % 2;
      const uint32_t k_tile = k_ring + s * Lt::kTile;
      const uint32_t v_tile = v_ring + s * Lt::kTile;
      mbar_wait(full0 + 8 * s, (j / 2) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss<64, 0, 0>(sacc, sw128_desc(base + Lt::kQ + off, 16, 1024),
                           sw128_desc(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<32>(sacc);
      // branch-free: every key of the tile lies inside the gate arrays,
      // and the select drops what a masked key computed
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 64 * j + 8 * jj + 2 * tq + e;
          const float b_s = bcum[key];
          const float li_s = gate[key];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = sacc[4 * jj + 2 * i + e];
            const float w = exp2_fast(((bt[i] - b_s) + li_s - mt[i]) * kLog2e);
            const float p = key <= t_row[i] && t_row[i] < L ? x * scale * w
                                                            : 0.f;
            x = p;
            den[i] += p;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        pa[x] = pack_bf16(sacc[2 * x], sacc[2 * x + 1]);
      }
      pin<HD / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<HD>(acc, pa + 4 * kk,
                     sw128_desc(v_tile + kk * 16 * kRowBytes, kBox, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<HD / 2>(acc);
      __syncthreads();   // every product has read stage s
      if (tid == 0 && j + 2 < n_kt) {
        load_kv<HD>(&tm_k, &tm_v, k_ring, v_ring, full0, j + 2, bh);
      }
    }

    // y = acc / max(|den|, e^-m_t) in bf16, through q's boxes (swizzled
    // as the TMA store reads them), rows past L dropped by the store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r_a + 8 * i;
      float dsum = den[i];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      dsum += rowf[2 * kTileRows + rr] * scale * rowf[kTileRows + rr];
      const float inv = 1.f / fmaxf(fabsf(dsum), expf(-mt[i]));
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const uint32_t dst = base + Lt::kQ + (jj / 8) * kBox + swz(rr, jj % 8)
                             + 4 * tq;
        const uint32_t v = pack_bf16(acc[4 * jj + 2 * i] * inv,
                                     acc[4 * jj + 2 * i + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst), "r"(v)
                     : "memory");
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int x = 0; x < Lt::kBoxes; ++x) {
        tma_store(&tm_y, base + Lt::kQ + x * kBox, x * kBoxCols, 0, q0, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    return;
  }

  // ---- a state block: rows d0 .. d0 + 63 of C' for (b, h) ----
  const int w_idx = blockIdx.x - n_y;
  const int bh = w_idx % BH;
  const int dt = w_idx / BH;
  const int d0 = dt * kTileRows;
  const int n_kt = n_qt;
  const long long seq = static_cast<long long>(bh) * L;
  if (tid == 0) {
    for (int j = 0; j < min(2, n_kt); ++j) {
      load_kv<HD>(nullptr, &tm_v, k_ring, v_ring, full0, j, bh);
    }
  }
  log_gates<kThreads>(li + seq, lf + seq, bcum, gate, L);
  const float m_prev = m[bh];
  const float btot = bcum[L - 1];
  float mx = -INFINITY;
  for (int s = tid; s < L; s += kThreads) {
    const float a = (btot - bcum[s]) + gate[s];
    gate[s] = a;
    mx = fmaxf(mx, a);
  }
  mx = group_max<32>(mx);
  if (lane == 0) rowf[warp] = mx;
  __syncthreads();
  mx = rowf[0];
  for (int x = 1; x < kThreads / 32; ++x) mx = fmaxf(mx, rowf[x]);
  const float m_new = fmaxf(btot + m_prev, mx);
  const float w_c = expf(btot + m_prev - m_new);
  for (int s = tid; s < n_kt * kTileRows; s += kThreads) {
    gate[s] = s < L ? expf(gate[s] - m_new) : 0.f;
  }
  __syncthreads();

  // key tile j's weighted keys are staged into A stage j % 2 while the
  // product of tile j - 1 runs
  const __nv_bfloat16* kb = k + seq * HD;
  float nacc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) nacc[e] = 0.f;
  stage_kw<HD>(kb, gate, L, 0, d0, base + Lt::kC, base + Lt::kC + kBox,
               nacc);
  fence_proxy_async();
  __syncthreads();
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % 2;
    const uint32_t hi = base + Lt::kC + s * 2 * kBox;
    const uint32_t lo = hi + kBox;
    const uint32_t v_tile = v_ring + s * Lt::kTile;
    mbar_wait(full0 + 8 * s, (j / 2) & 1);
    pin<HD / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = sw128_desc(v_tile + kk * 16 * kRowBytes, kBox, 1024);
      wgmma_ss<HD, 1, 1>(acc, sw128_desc(hi + kk * 16 * kRowBytes, kBox,
                                         1024), b, 1);
      wgmma_ss<HD, 1, 1>(acc, sw128_desc(lo + kk * 16 * kRowBytes, kBox,
                                         1024), b, 1);
    }
    wgmma_commit();
    if (j + 1 < n_kt) {
      const uint32_t nhi = base + Lt::kC + ((j + 1) % 2) * 2 * kBox;
      stage_kw<HD>(kb, gate, L, j + 1, d0, nhi, nhi + kBox, nacc);
      fence_proxy_async();
    }
    wgmma_wait_all();
    pin<HD / 2>(acc);
    __syncthreads();   // every product has read stage s and A stage s
    if (tid == 0 && j + 2 < n_kt) {
      load_kv<HD>(nullptr, &tm_v, k_ring, v_ring, full0, j + 2, bh);
    }
  }

  // C' = C w_c + acc on this thread's rows d0 + r_a, d0 + r_a + 8
  const long long cbase = static_cast<long long>(bh) * HD * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = cbase + static_cast<long long>(d0 + r_a + 8 * i) * HD;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const long long off = row + 8 * jj + 2 * tq;
      const float2 cv = __ldg(reinterpret_cast<const float2*>(c + off));
      float2 out;
      out.x = cv.x * w_c + acc[4 * jj + 2 * i];
      out.y = cv.y * w_c + acc[4 * jj + 2 * i + 1];
      *reinterpret_cast<float2*>(c_out + off) = out;
    }
  }
  // n': the 16 threads of each column chunk, in order (the K ring is free)
  float* const part = reinterpret_cast<float*>(gbase + Lt::kK);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    part[(tid / 8) * kTileRows + (tid % 8) * 8 + e] = nacc[e];
  }
  __syncthreads();
  if (tid < kTileRows) {
    float sum = 0.f;
    for (int g = 0; g < kThreads / 8; ++g) sum += part[g * kTileRows + tid];
    const long long off = static_cast<long long>(bh) * HD + d0 + tid;
    n_out[off] = __ldg(n + off) * w_c + sum;
  }
  if (dt == 0 && tid == 0) m_out[bh] = m_new;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, const float* c,
                   const float* n, const float* m, void* y, float* c_out,
                   float* n_out, float* m_out, int BH, int L, float scale,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_y;
  // (b, h) as the batch of the 4-D map (hd, 1, L, B*H): rows past L read
  // as zeros and are not written
  if (!encode(&tm_q, q, BH, L, 1, HD, kTileRows)
      || !encode(&tm_k, k, BH, L, 1, HD, kTileRows)
      || !encode(&tm_v, v, BH, L, 1, HD, kTileRows)
      || !encode(&tm_y, y, BH, L, 1, HD, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<HD>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_sm90_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (L + kTileRows - 1) / kTileRows;
  const int grid = (n_qt + HD / kTileRows) * BH;
  mlstm_chunk_sm90_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_y, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), li, lf, c, n, m, c_out, n_out,
      m_out, BH, L, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v and y, f32 gates and state, all contiguous; q, k, v, y, c
// and c_out 16-byte aligned; hd 64, 128 or 192.
int mlstm_chunk_sm90(const void* q, const void* k, const void* v,
                     const float* li, const float* lf, const float* c,
                     const float* n, const float* m, void* y, float* c_out,
                     float* n_out, float* m_out, int BH, int L, int hd,
                     float scale, void* stream) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q)
                          | reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v)
                          | reinterpret_cast<uintptr_t>(y)
                          | reinterpret_cast<uintptr_t>(c)
                          | reinterpret_cast<uintptr_t>(c_out);
  if (BH < 1 || L < 1 || L > kMaxLen
      || (hd != 64 && hd != 128 && hd != 192)
      || static_cast<long long>(BH) * ((L + 63) / 64 + hd / 64) > INT32_MAX
      || addrs % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 64) {
    err = launch<64>(q, k, v, li, lf, c, n, m, y, c_out, n_out, m_out, BH, L,
                     scale, st);
  } else if (hd == 128) {
    err = launch<128>(q, k, v, li, lf, c, n, m, y, c_out, n_out, m_out, BH,
                      L, scale, st);
  } else {
    err = launch<192>(q, k, v, li, lf, c, n, m, y, c_out, n_out, m_out, BH,
                      L, scale, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
