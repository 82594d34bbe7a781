// Hand-written Hopper kernel for one chunk of chunkwise-parallel mLSTM
// (xLSTM's matrix-memory mixer) on the tensor cores in f32: f32 q, k, v at
// head dims 64, 128 and 192 in chunks of at most 512, f32 gates and state,
// every product as three TF32 products (3xTF32, sm90_tf32.cuh), so the
// result keeps f32's accuracy.
//
// It replaces the Pallas TPU kernel _mlstm_chunk_kernel
// (src/repro/kernels/mlstm_chunk.py:25) on the f32 route at those head
// dims and lengths; f32 elsewhere stays on the CUDA-core kernel of
// mlstm_chunk.cu (the "SIMT kernel", whose header states the function:
// y, C', n' and m' by the same equations), bf16 on mlstm_chunk_sm90.cu.
// y is written in f32; ragged L needs no padding.
//
// Bound on this card: at xLSTM-125M's chunk (B 4, H 4, L 256, hd 192)
// the products q k^T and p v over the causal pairs, q C and (k w_k)^T v
// are 1.01 GFLOP against 17.3 MB of f32 operands and results (5.2 us at
// 3.35 TB/s); as three TF32 products 3.04 GFLOP at 495 TFLOP/s, 6.1 us
// (at the f32 rate of the CUDA cores, 15.1 us).  One launch of two kinds
// of block (one warpgroup of 128 threads each), all in one wave at that
// shape, longest first, as the bf16 kernel; what changes is what TF32
// demands of the operands:
//
// - Both operands of a TF32 wgmma are K-major.  q (q C, q k^T) and k
//   (q k^T) are K-major as stored: TMA brings them and one elementwise
//   pass splits them in place into hi and lo.  C (q C), v (P V, and
//   (k w_k)^T v) and k (as (k w_k)^T) are MN-major: TMA brings them raw
//   and the pass that splits them transposes them (4 x 4 blocks in
//   registers) into K-major hi and lo tiles, with the weights w_k applied
//   to k on the way.  P is written K-major from registers.
// - Accumulation (sm90_tf32.cuh): the tensor cores round each sum toward
//   zero, so q C, P V and (k w_k)^T v go 64 columns at a time into a
//   fresh accumulator per slab or key tile, added to acc in f32, and the
//   scores' hi x hi products of each half of hd and their cross terms
//   into accumulators of their own.
// - Shared memory.  q hi and lo are 96 KiB at hd 192; the rest of the
//   227 KiB holds one phase at a time: C as 32-row slabs (raw, then C^T
//   hi and lo in two slots: 120 KiB), then 16-key tiles of K and V (two
//   stages raw, K lo, V^T and P hi and lo: 92 KiB).
//
// - "y" blocks, one per (b, h, 64-row q tile): 64 at xLSTM-125M.  acc =
//   q C slab by slab (the next slab transposed and split while the
//   current one multiplies), scaled row-wise by w_inter / sqrt(hd).  Then
//   for each 16-key tile up to the diagonal: S = q k^T (m64n16k8), P = S
//   e^(bcum_t - bcum_s + li_s - m_t) / sqrt(hd) in registers (keys past
//   the row, and rows and keys past L, weigh exactly 0), P's row sums
//   into den_intra, P split into hi and lo in shared memory, acc += P V
//   (m64n64k8), the first chunk in flight while the next tile's K is
//   split.  The
//   stabiliser m_t depends on the gates only, so no rescaling is needed
//   between tiles.  Epilogue: den = den_intra + (q . n) w_inter / sqrt(hd)
//   (f32 products from the raw q tile), y = acc / max(|den|, e^-m_t).
// - "state" blocks, one per (b, h, 64-row tile of C'): 48 at xLSTM-125M.
//   C' = C w_c + (k w_k)^T v over 16-key tiles (m64n64k8), the next
//   tile's operands staged while the current product runs; n' = n w_c +
//   sum_s w_s k_s sums f32 products in key order from the raw k tiles;
//   the first state block of each (b, h) writes m'.
// - Gates: bcum is the same fixed-order scan as the SIMT kernel's
//   (tile_common.cuh log_gates), and m_t, m', w_c and w_k are computed as
//   there, with expf.  No split over keys and no atomics: the result is
//   the same bits run to run.
//
// The launcher returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take, or a tensor map that cannot be
// encoded) so the caller raises; the outputs come from the caller.

#include "sm90_tf32.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kThreads = 128;        // one warpgroup
constexpr int kRows = 64;            // wgmma's M: q rows, C' rows
constexpr int kKT = 16;              // keys a tile
constexpr int kSlab = 32;            // rows of C a slab (one K box)
// the longest chunk (gates in shared memory); mlstm_chunk.py
// SM90_MAX_LEN routes longer ones to the SIMT kernel
constexpr int kMaxLen = 512;

template <int HD>
struct Layout {
  static constexpr int kQTile = kRows * HD * 4;
  static constexpr int kKV = kKT * HD * 4;       // a 16-key tile of K or V
  static constexpr int kCt = HD * kSlab * 4;     // C^T half of one slab
  static constexpr int kP = kRows * kKT * 4;     // P or (k w_k)^T, one half
  static constexpr int kQHi = 0;
  static constexpr int kQLo = kQTile;
  static constexpr int kR = 2 * kQTile;          // one phase at a time:
  // q C: two slots of C^T (hi, lo), then the raw slab
  static constexpr int kCRaw = kR + 4 * kCt;
  static constexpr int kQcEnd = kCRaw + kCt;
  // y blocks' key tiles: K (raw, then hi) and V in two stages, K lo,
  // V^T and P hi and lo
  static constexpr int kK = kR;
  static constexpr int kKLo = kK + 2 * kKV;
  static constexpr int kV = kKLo + kKV;
  static constexpr int kVtHi = kV + 2 * kKV;
  static constexpr int kVtLo = kVtHi + kKV;
  static constexpr int kPHi = kVtLo + kKV;
  static constexpr int kPLo = kPHi + kP;
  static constexpr int kKeyEnd = kPLo + kP;
  // state blocks: k (64 columns) and v in two stages, then two slots of
  // (A hi, A lo, V^T hi, V^T lo)
  static constexpr int kSk = kR;
  static constexpr int kSv = kSk + 2 * kP;
  static constexpr int kSab = kSv + 2 * kKV;
  static constexpr int kSlot = 2 * kP + 2 * kKV;
  static constexpr int kStateEnd = kSab + 2 * kSlot;
  static constexpr int kGates = kQcEnd > kKeyEnd
                                    ? (kQcEnd > kStateEnd ? kQcEnd : kStateEnd)
                                    : (kKeyEnd > kStateEnd ? kKeyEnd
                                                           : kStateEnd);
  static constexpr int kRowF = kGates + 2 * kMaxLen * 4;  // bcum, li
  static constexpr int kBars = kRowF + 3 * kRows * 4;    // 3 floats a row
  // q, C slab, K full[2], V full[2]
  static constexpr int kAlloc = kBars + 8 * 6 + 1024;
  static_assert(kAlloc <= 232448, "shared memory of one block");
  static_assert(kKV % 1024 == 0 && kCt % 1024 == 0 && kP % 1024 == 0,
                "alignment");
};

// Issue columns d0 .. d0 + COLS - 1 of the raw 16-key tile j of the
// tensor behind `tm` (k or v) into dst, completing on bar.
template <int COLS>
__device__ __forceinline__ void load_tile(const CUtensorMap* tm, uint32_t dst,
                                          uint32_t bar, int d0, int j,
                                          int bh) {
  mbar_expect_tx(bar, kKT * COLS * 4);
  for (int x = 0; x < COLS / kF32BoxCols; ++x) {
    tma_load(dst + x * kKT * kRowBytes, tm, bar, d0 + x * kF32BoxCols, 0,
             kKT * j, bh);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_sm90_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_c,
                            const float* __restrict__ li,
                            const float* __restrict__ lf,
                            const float* __restrict__ c,
                            const float* __restrict__ n,
                            const float* __restrict__ m,
                            float* __restrict__ y, float* __restrict__ c_out,
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
  const uint32_t cbar = qbar + 8;
  const uint32_t kfull0 = cbar + 8;
  const uint32_t vfull0 = kfull0 + 16;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int r_a = warp * 16 + lane / 4;   // rows r_a and r_a + 8 of a tile
  const int n_qt = (L + kRows - 1) / kRows;
  const int n_y = n_qt * BH;
  if (tid == 0) {
    for (int x = 0; x < 6; ++x) mbar_init(qbar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_y) {
    // ---- a y block: rows q0 .. q0 + 63 of (b, h), longest first ----
    const int bh = blockIdx.x % BH;
    const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kRows;
    const int n_kt = (min(q0 + kRows, L) + kKT - 1) / kKT;
    const long long seq = static_cast<long long>(bh) * L;
    constexpr int kSlabs = HD / kSlab;
    if (tid == 0) {
      // q, and C slab 0: rows 0 .. 31 of this (b, h)'s C
      mbar_expect_tx(qbar, Lt::kQTile);
      mbar_expect_tx(cbar, kSlab * HD * 4);
      for (int x = 0; x < HD / kF32BoxCols; ++x) {
        tma_load(base + Lt::kQHi + x * kRows * kRowBytes, &tm_q, qbar,
                 x * kF32BoxCols, 0, q0, bh);
        tma_load(base + Lt::kCRaw + x * kSlab * kRowBytes, &tm_c, cbar,
                 x * kF32BoxCols, 0, 0, bh);
      }
    }
    log_gates<kThreads>(li + seq, lf + seq, bcum, gate, L);

    // each row's m_t and w_inter (two threads a row, as the SIMT kernel)
    // and its q . n, unscaled, from the raw q tile
    mbar_wait(qbar, 0);
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
      const float* nr = n + static_cast<long long>(bh) * HD;
      float qn = 0.f;
#pragma unroll 4
      for (int ch = half * HD / 8; ch < (half + 1) * HD / 8; ++ch) {
        const float4 x = lds128(base + Lt::kQHi + kmo<HD>(row, ch, kRows));
        const float4 nv = __ldg(reinterpret_cast<const float4*>(nr) + ch);
        qn += x.x * nv.x + x.y * nv.y + x.z * nv.z + x.w * nv.w;
      }
      qn += __shfl_xor_sync(0xffffffffu, qn, 1);
      if (half == 0) {
        rowf[row] = m_t;
        rowf[kRows + row] = expf(m_inter - m_t);
        rowf[2 * kRows + row] = qn;
      }
    }
    __syncthreads();   // the raw q tile's reads are done
    split_in_place<kThreads>(base + Lt::kQHi, base + Lt::kQLo, Lt::kQTile);

    // acc = q C over HD / 32 slabs of 32 rows of C, each slab's products
    // flushed into acc in f32; slab i + 1 is transposed and split into
    // C^T hi and lo (slot (i + 1) % 2) while slab i multiplies
    mbar_wait(cbar, 0);
    transpose_split<kSlab, HD, kThreads>(base + Lt::kCRaw, base + Lt::kR,
                                         base + Lt::kR + Lt::kCt, nullptr);
    fence_proxy_async();
    for (int i = 0; i < kSlabs; ++i) {
      const uint32_t ct = base + Lt::kR + (i % 2) * 2 * Lt::kCt;
      __syncthreads();   // slab i split, the raw slab free, i - 1 done
      if (tid == 0 && i + 1 < kSlabs) {
        mbar_expect_tx(cbar, kSlab * HD * 4);
        for (int x = 0; x < HD / kF32BoxCols; ++x) {
          tma_load(base + Lt::kCRaw + x * kSlab * kRowBytes, &tm_c, cbar,
                   x * kF32BoxCols, 0, kSlab * (i + 1), bh);
        }
      }
      const uint32_t qa = i * kRows * kRowBytes;   // q's columns 32 i ..
      mma_3x_flushed<HD, kSlab, HD>(
          acc, base + Lt::kQHi + qa, base + Lt::kQLo + qa, ct, ct + Lt::kCt,
          [&] {
            if (i + 1 < kSlabs) {
              const uint32_t nct = base + Lt::kR + ((i + 1) % 2) * 2 * Lt::kCt;
              mbar_wait(cbar, (i + 1) & 1);
              transpose_split<kSlab, HD, kThreads>(base + Lt::kCRaw, nct,
                                                   nct + Lt::kCt, nullptr);
              fence_proxy_async();
            }
          });
    }
    __syncthreads();   // every q C product done: region R is free
    if (tid == 0) {
      for (int j = 0; j < min(2, n_kt); ++j) {
        load_tile<HD>(&tm_k, base + Lt::kK + j * Lt::kKV, kfull0 + 8 * j, 0,
                      j, bh);
        load_tile<HD>(&tm_v, base + Lt::kV + j * Lt::kKV, vfull0 + 8 * j, 0,
                      j, bh);
      }
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
      const float w = rowf[kRows + rr] * scale;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        acc[4 * jj + 2 * i] *= w;
        acc[4 * jj + 2 * i + 1] *= w;
      }
    }

    // the decayed intra-chunk product, key tile by key tile; K of tile
    // j + 1 is split while P V of tile j runs
    float sacc[kKT / 2];
    mbar_wait(kfull0, 0);
    split_in_place<kThreads>(base + Lt::kK, base + Lt::kKLo, Lt::kKV);
    fence_proxy_async();
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % 2;
      const uint32_t par = (j / 2) & 1;
      const uint32_t k_tile = base + Lt::kK + s * Lt::kKV;
      const uint32_t v_raw = base + Lt::kV + s * Lt::kKV;
      __syncthreads();   // K of tile j split; P V of tile j - 1 done
      // V^T hi and lo, then S = q k^T (the V pass inside the S products'
      // flight, as in the flash kernel, makes ptxas 12.9 crash at hd 128)
      mbar_wait(vfull0 + 8 * s, par);
      transpose_split<kKT, HD, kThreads>(v_raw, base + Lt::kVtHi,
                                         base + Lt::kVtLo, nullptr);
      fence_proxy_async();
      scores_3x<kKT, HD>(sacc, base + Lt::kQHi, base + Lt::kQLo, k_tile,
                         base + Lt::kKLo, [] {});
      __syncthreads();   // S done: K and V of stage s are free
      if (tid == 0 && j + 2 < n_kt) {
        load_tile<HD>(&tm_k, k_tile, kfull0 + 8 * s, 0, j + 2, bh);
        load_tile<HD>(&tm_v, v_raw, vfull0 + 8 * s, 0, j + 2, bh);
      }
      // P, branch-free: every key of the tile lies inside the gate
      // arrays, and the select drops what a masked key computed
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = r_a + 8 * i;
#pragma unroll
        for (int jj = 0; jj < kKT / 8; ++jj) {
          float hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kKT * j + 8 * jj + 2 * tq + e;
            const float w = expf((bt[i] - bcum[key]) + gate[key] - mt[i]);
            const float x = sacc[4 * jj + 2 * i + e];
            const float p = key <= t_row[i] && t_row[i] < L ? x * scale * w
                                                            : 0.f;
            den[i] += p;
            split_tf32(p, hi[e], lo[e]);
          }
          const uint32_t off = kmo<kKT>(rr, 2 * jj + tq / 2, kRows)
                               + (tq % 2) * 8;
          sts64(base + Lt::kPHi + off, hi[0], hi[1]);
          sts64(base + Lt::kPLo + off, lo[0], lo[1]);
        }
      }
      fence_proxy_async();
      __syncthreads();   // P and V^T complete
      // acc += P V, flushed into acc in f32; the next tile's K is split
      // while the products are in flight
      mma_3x_flushed<HD, kKT, HD>(
          acc, base + Lt::kPHi, base + Lt::kPLo, base + Lt::kVtHi,
          base + Lt::kVtLo, [&] {
            if (j + 1 < n_kt) {
              mbar_wait(kfull0 + 8 * (1 - s), ((j + 1) / 2) & 1);
              split_in_place<kThreads>(base + Lt::kK + (1 - s) * Lt::kKV,
                                       base + Lt::kKLo, Lt::kKV);
              fence_proxy_async();
            }
          });
    }

    // y = acc / max(|den|, e^-m_t) in f32, rows past L not written
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = r_a + 8 * i;
      float dsum = den[i];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      dsum += rowf[2 * kRows + rr] * scale * rowf[kRows + rr];
      const float inv = 1.f / fmaxf(fabsf(dsum), expf(-mt[i]));
      if (t_row[i] >= L) continue;
      float* dst = y + (seq + t_row[i]) * HD + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        *reinterpret_cast<float2*>(dst + 8 * jj) =
            make_float2(acc[4 * jj + 2 * i] * inv,
                        acc[4 * jj + 2 * i + 1] * inv);
      }
    }
    return;
  }

  // ---- a state block: rows d0 .. d0 + 63 of C' for (b, h) ----
  const int w_idx = blockIdx.x - n_y;
  const int bh = w_idx % BH;
  const int dt = w_idx / BH;
  const int d0 = dt * kRows;
  const int n_kt = (L + kKT - 1) / kKT;
  const long long seq = static_cast<long long>(bh) * L;
  if (tid == 0) {
    for (int j = 0; j < min(2, n_kt); ++j) {
      load_tile<kRows>(&tm_k, base + Lt::kSk + j * Lt::kP, kfull0 + 8 * j, d0,
                       j, bh);
      load_tile<HD>(&tm_v, base + Lt::kSv + j * Lt::kKV, vfull0 + 8 * j, 0, j,
                    bh);
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
  for (int s = tid; s < n_kt * kKT; s += kThreads) {
    gate[s] = s < L ? expf(gate[s] - m_new) : 0.f;
  }
  __syncthreads();

  // tile j + 1's (k w_k)^T and v^T, split, go to slot (j + 1) % 2 while
  // the product of tile j runs; n' sums column d0 + tid in key order
  float nacc = 0.f;
  auto stage = [&](int j) {
    const int s = j % 2;
    const uint32_t k_raw = base + Lt::kSk + s * Lt::kP;
    const uint32_t a_hi = base + Lt::kSab + s * Lt::kSlot;
    mbar_wait(kfull0 + 8 * s, (j / 2) & 1);
    mbar_wait(vfull0 + 8 * s, (j / 2) & 1);
    if (tid < kRows) {
      const uint32_t col = k_raw + (tid % 4) * 4;
      for (int r = 0; r < kKT; ++r) {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];\n"
                     : "=f"(x) : "r"(col + kmo<kRows>(r, tid / 4, kKT))
                     : "memory");
        nacc += x * gate[kKT * j + r];
      }
    }
    transpose_split<kKT, kRows, kThreads>(k_raw, a_hi, a_hi + Lt::kP,
                                          gate + kKT * j);
    transpose_split<kKT, HD, kThreads>(base + Lt::kSv + s * Lt::kKV,
                                       a_hi + 2 * Lt::kP,
                                       a_hi + 2 * Lt::kP + Lt::kKV, nullptr);
    fence_proxy_async();
  };
  stage(0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % 2;
    const uint32_t a_hi = base + Lt::kSab + s * Lt::kSlot;
    __syncthreads();   // slot s complete, stage s read, product j - 1 done
    if (tid == 0 && j + 2 < n_kt) {
      load_tile<kRows>(&tm_k, base + Lt::kSk + s * Lt::kP, kfull0 + 8 * s,
                       d0, j + 2, bh);
      load_tile<HD>(&tm_v, base + Lt::kSv + s * Lt::kKV, vfull0 + 8 * s, 0,
                    j + 2, bh);
    }
    mma_3x_flushed<HD, kKT, HD>(acc, a_hi, a_hi + Lt::kP, a_hi + 2 * Lt::kP,
                                a_hi + 2 * Lt::kP + Lt::kKV, [&] {
                                  if (j + 1 < n_kt) stage(j + 1);
                                });
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
      *reinterpret_cast<float2*>(c_out + off) =
          make_float2(cv.x * w_c + acc[4 * jj + 2 * i],
                      cv.y * w_c + acc[4 * jj + 2 * i + 1]);
    }
  }
  if (tid < kRows) {
    const long long off = static_cast<long long>(bh) * HD + d0 + tid;
    n_out[off] = __ldg(n + off) * w_c + nacc;
  }
  if (dt == 0 && tid == 0) m_out[bh] = m_new;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, const float* c,
                   const float* n, const float* m, void* y, float* c_out,
                   float* n_out, float* m_out, int BH, int L, float scale,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_c;
  // (b, h) as the batch of the 4-D map (hd, 1, L, B*H): rows past L read
  // as zeros; C as (hd, 1, hd, B*H) in 32-row slabs
  if (!encode_f32(&tm_q, q, BH, L, 1, HD, kRows)
      || !encode_f32(&tm_k, k, BH, L, 1, HD, kKT)
      || !encode_f32(&tm_v, v, BH, L, 1, HD, kKT)
      || !encode_f32(&tm_c, c, BH, HD, 1, HD, kSlab)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<HD>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_sm90_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (L + kRows - 1) / kRows;
  const int grid = (n_qt + HD / kRows) * BH;
  mlstm_chunk_sm90_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_c, li, lf, c, n, m, static_cast<float*>(y), c_out,
      n_out, m_out, BH, L, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 q, k, v, y, gates and state, all contiguous; q, k, v, y, c, c_out
// and n 16-byte aligned; hd 64, 128 or 192; L at most 512.
int mlstm_chunk_sm90_f32(const void* q, const void* k, const void* v,
                         const float* li, const float* lf, const float* c,
                         const float* n, const float* m, void* y,
                         float* c_out, float* n_out, float* m_out, int BH,
                         int L, int hd, float scale, void* stream) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q)
                          | reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v)
                          | reinterpret_cast<uintptr_t>(y)
                          | reinterpret_cast<uintptr_t>(c)
                          | reinterpret_cast<uintptr_t>(c_out)
                          | reinterpret_cast<uintptr_t>(n);
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
