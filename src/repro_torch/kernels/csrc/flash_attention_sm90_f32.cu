// Hand-written Hopper kernel for blockwise (flash) GQA attention, forward,
// on the tensor cores in f32: f32 q, k, v at head dims 64, 128 and 256,
// every product as three TF32 products (3xTF32, sm90_tf32.cuh), so the
// result keeps f32's accuracy.
//
// It replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:26) on the f32 route at those
// head dims; f32 at other head dims stays on the CUDA-core kernel of
// flash_attention.cu (the "SIMT kernel"), bf16 on flash_attention_sm90.cu
// and flash_attention_sm90_hd256.cu.  The function is the SIMT kernel's:
// for q (B,S,H,hd) and k/v (B,T,Hkv,hd) in that public layout,
//
//   out[b,s,h] = softmax_t( q[b,s,h] . k[b,t,kv] / sqrt(hd) + mask ) v[b,t,kv]
//
// with kv = h / (H / Hkv), causal and window masks on absolute positions
// (key t <= query s, and s - t < window when window > 0), a masked score
// the reference's finite -2^20 (a row whose window holds no key averages
// every key), keys past T excluded outright, no mask at all when not
// causal, and the output divided by max(l, 1e-30), in f32.
//
// Bound on this card: by operations.  At Llama-3 8B's f32 copy (B 4,
// S = T = 1024, H 32, Hkv 8, hd 128) q k^T and p v over the causal pairs
// are 34.4 GFLOP against 168 MB of operands (50 us at 3.35 TB/s); as
// three TF32 products, 103 GFLOP at 495 TFLOP/s: 208 us (at the f32 rate
// of the CUDA cores, 513 us).  At Gemma 3 12B's windowed and global
// layers (B 2, S = T = 2048, H 16, Hkv 8, hd 256): 312 and 417 us.
//
// Shared memory decides the design.  f32 operands with their lo halves
// are four times the bf16 kernels' bytes:
//
//   hd   q hi + lo   keys a tile   K raw/hi   K lo   V raw   V^T hi+lo   P hi+lo   total
//   64      32 KiB        64       2 x 16 KiB   16   2 x 16      32         32      176 KiB
//   128     64 KiB        32       2 x 16 KiB   16   2 x 16      32         16      192 KiB
//   256    128 KiB        16       1 x 16 KiB   16   1 x 16      32          8      216 KiB
//
// of the 227 KiB a block may use.  So one warpgroup of 128 threads owns
// one 64-row q tile (wgmma's M), one block to an SM, and key tiles hold
// 4,096 / hd keys; at hd 256 the K and V rings have one stage.  The 128-
// and 64-key tiles of the bf16 kernels do not fit.
//
// Per key tile:
// - K and V arrive by TMA (4-D tensor maps on the public layout, so the
//   GQA head is a coordinate and rows past T arrive as zeros) through a
//   ring of mbarriers, K and V on barriers of their own.
// - K is K-major for S = q k^T as stored: it is split in place into hi
//   and lo (one elementwise pass), as q once per block.
// - V is MN-major for O += P V.  The pass that splits it also transposes
//   it (4 x 4 blocks in registers) into V^T hi and lo, K-major, and runs
//   while the S products are in flight.
// - S = q k^T as 3xTF32 wgmma (m64nBNk8, all from shared memory, the
//   hi x hi products of each half of hd and the cross terms in
//   accumulators of their own: sm90_tf32.cuh "Accumulation"); masks
//   only on tiles that straddle the diagonal, the window edge or T; the
//   online softmax in base 2 with the scale folded into the exponent's
//   FMA, as the bf16 kernels.  P (f32) is split into hi and lo and
//   written K-major (64 rows x BN keys) to shared memory: the A operand
//   of P V.  (A from registers would need the keys of each k-step
//   permuted to the TF32 fragment's order; the store is 2 x BN / 2
//   eight-byte stores a thread.)
// - O += P V as 3xTF32 wgmma (m64n64k8), 64 columns at a time into a
//   fresh accumulator that is added to O in f32, the first chunk in
//   flight while the next tile's K is split.
// Only the tiles a q tile needs are loaded (above the diagonal and below
// the window when S <= T, none); fully masked tiles are never read.
// Every output is one fixed sequence of tiles and k-steps: no atomics, no
// split over keys, so the kernel is bitwise repeatable.
//
// The launcher returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take, or a tensor map that cannot be
// encoded) so the caller raises; the output comes from the caller.

#include "sm90_tf32.cuh"

namespace {

constexpr int kThreads = 128;         // one warpgroup
constexpr int kBM = 64;               // query rows a block
constexpr float kMasked = -1048576.f; // -2^20, as the reference
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kBN = 4096 / HD;           // keys a tile
  static constexpr int kStages = HD == 256 ? 1 : 2;
  static constexpr int kQTile = kBM * HD * 4;     // 64 rows of f32
  static constexpr int kKVTile = kBN * HD * 4;
  static constexpr int kPTile = kBM * kBN * 4;
  // byte offsets from a 1024-byte-aligned base
  static constexpr int kQHi = 0;
  static constexpr int kQLo = kQHi + kQTile;
  static constexpr int kK = kQLo + kQTile;                // raw, then hi
  static constexpr int kKLo = kK + kStages * kKVTile;
  static constexpr int kV = kKLo + kKVTile;               // raw
  static constexpr int kVtHi = kV + kStages * kKVTile;
  static constexpr int kVtLo = kVtHi + kKVTile;
  static constexpr int kPHi = kVtLo + kKVTile;
  static constexpr int kPLo = kPHi + kPTile;
  static constexpr int kBars = kPLo + kPTile;   // q, K full[], V full[]
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kAlloc <= 232448, "shared memory of one block");
  static_assert(kPTile % 1024 == 0 && kKVTile % 1024 == 0, "alignment");
};

// The key tiles the q tile at q0 needs, [kt0, kt0 + n): the same rule as
// the SIMT kernel (with S > T a row may have no key in its window and
// then keeps every key, so the window skips nothing there).
template <int BN>
__device__ __forceinline__ void key_tiles(int q0, int S, int Tk, int causal,
                                          int window, int& kt0, int& n) {
  const int q_last = min(q0 + kBM, S) - 1;
  int k_end = Tk;
  int k_begin = 0;
  if (causal) {
    k_end = min(Tk, q_last + 1);
    if (window > 0 && S <= Tk) k_begin = max(0, q0 - window + 1);
  }
  kt0 = k_begin / BN;
  n = (k_end + BN - 1) / BN - kt0;
}

template <int HD>
__device__ __forceinline__ void load_k(const CUtensorMap* tm, uint32_t dst,
                                       uint32_t bar, int kh, int k0, int b) {
  using C = Cfg<HD>;
  mbar_expect_tx(bar, C::kKVTile);
  for (int x = 0; x < HD / kF32BoxCols; ++x) {
    tma_load(dst + x * C::kBN * kRowBytes, tm, bar, x * kF32BoxCols, kh, k0,
             b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_f32(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   float* __restrict__ out, int B, int S, int Tk, int H,
                   int Hkv, int causal, int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbar = base + C::kBars;
  const uint32_t kfull0 = qbar + 8;
  const uint32_t vfull0 = kfull0 + 8 * C::kStages;

  // the block's q tile, longest (diagonal-most) first
  const int n_qt = (S + kBM - 1) / kBM;
  const int bh = B * H;
  const int w = blockIdx.x;
  const int q0 = (n_qt - 1 - w / bh) * kBM;
  const int h = (w % bh) % H;
  const int b = (w % bh) / H;
  const int kh = h / (H / Hkv);
  int kt0, n_tiles;
  key_tiles<kBN>(q0, S, Tk, causal, window, kt0, n_tiles);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  // in the accumulator layout this thread holds rows r_a and r_a + 8 of
  // the tile and, of each 8 columns jj, columns 8 jj + 2 tq and + 1
  const int r_a = warp * 16 + lane / 4;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, C::kQTile);
    for (int x = 0; x < HD / kF32BoxCols; ++x) {
      tma_load(base + C::kQHi + x * kBM * kRowBytes, &tm_q, qbar,
               x * kF32BoxCols, h, q0, b);
    }
    for (int j = 0; j < min(C::kStages, n_tiles); ++j) {
      const int k0 = (kt0 + j) * kBN;
      load_k<HD>(&tm_k, base + C::kK + j * C::kKVTile, kfull0 + 8 * j, kh, k0,
                 b);
      load_k<HD>(&tm_v, base + C::kV + j * C::kKVTile, vfull0 + 8 * j, kh, k0,
                 b);
    }
  }
  __syncthreads();
  mbar_wait(qbar, 0);
  split_in_place<kThreads>(base + C::kQHi, base + C::kQLo, C::kQTile);
  // K hi in place, K lo beside it: tile 0 here, tile j + 1 while the
  // products of tile j run
  mbar_wait(kfull0, 0);
  split_in_place<kThreads>(base + C::kK, base + C::kKLo, C::kKVTile);
  fence_proxy_async();

  // scores stay unscaled until the exponent: a masked score is the
  // reference's -2^20 after scaling, so -2^20 / scale before
  const float masked = kMasked / scale_log2;
  float m_run[2] = {masked, masked};
  float l_run[2] = {0.f, 0.f};
  float sacc[kBN / 2];
  float oacc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) oacc[x] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::kStages;
    const uint32_t par = (j / C::kStages) & 1;
    const int k0 = (kt0 + j) * kBN;
    const uint32_t k_tile = base + C::kK + s * C::kKVTile;
    const uint32_t v_raw = base + C::kV + s * C::kKVTile;
    __syncthreads();   // K of tile j split; P V of tile j - 1 done

    // S = q k^T; V^T hi and lo while the products are in flight
    scores_3x<kBN, HD>(sacc, base + C::kQHi, base + C::kQLo, k_tile,
                       base + C::kKLo, [&] {
      mbar_wait(vfull0 + 8 * s, par);
      transpose_split<kBN, HD, kThreads>(v_raw, base + C::kVtHi,
                                         base + C::kVtLo, nullptr);
      fence_proxy_async();
    });
    __syncthreads();   // S done: K and V of stage s are free
    if (tid == 0 && j + C::kStages < n_tiles) {
      const int k1 = (kt0 + j + C::kStages) * kBN;
      load_k<HD>(&tm_k, k_tile, kfull0 + 8 * s, kh, k1, b);
      load_k<HD>(&tm_v, v_raw, vfull0 + 8 * s, kh, k1, b);
    }

    // masks only where the tile straddles an edge
    const int q_last = q0 + kBM - 1;
    const bool edge =
        k0 + kBN > Tk
        || (causal && (k0 + kBN - 1 > q0
                       || (window > 0 && k0 <= q_last - window)));
    if (edge) {
      // in column offsets c = 8 jj + e from this thread's first key
      // k0 + 2 tq: keys from `end` on do not exist; causal row r masks
      // keys above hi[i] and, with a window, at or below lo[i]
      const int first = k0 + 2 * tq;
      const int end = Tk - first;
      int hi[2], lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + r_a + 8 * i;
        hi[i] = causal ? r - first : kBN;
        lo[i] = causal && window > 0 ? r - window - first : -1;
      }
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jj + e;
            float& x = sacc[4 * jj + 2 * i + e];
            if (c > hi[i] || c <= lo[i]) x = masked;
            if (c >= end) x = -INFINITY;   // no such key: weight exactly 0
          }
        }
      }
    }

    // online softmax in base 2, the scale folded into the exponent's FMA:
    // running max m, per-thread partial denominator l; P split into hi
    // and lo, K-major (row r, key c) in shared memory
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        mx = fmaxf(mx, fmaxf(sacc[4 * jj + 2 * i], sacc[4 * jj + 2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2_fast((m_run[i] - mx) * scale_log2);
      m_run[i] = mx;
      const float mx_scaled = mx * scale_log2;
      const int r = r_a + 8 * i;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        float p[2], hi[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = exp2_fast(fmaf(sacc[4 * jj + 2 * i + e], scale_log2,
                                -mx_scaled));
          sum += p[e];
          split_tf32(p[e], hi[e], lo[e]);
        }
        // keys 8 jj + 2 tq, + 1: chunk 2 jj + tq / 2, second half if tq odd
        const uint32_t off = kmo<kBN>(r, 2 * jj + tq / 2, kBM) + (tq % 2) * 8;
        sts64(base + C::kPHi + off, hi[0], hi[1]);
        sts64(base + C::kPLo + off, lo[0], lo[1]);
      }
      l_run[i] = l_run[i] * alpha[i] + sum;
    }
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[4 * jj + 2 * i] *= alpha[i];
        oacc[4 * jj + 2 * i + 1] *= alpha[i];
      }
    }
    fence_proxy_async();
    __syncthreads();   // P and V^T complete

    // O += P V, flushed into O in f32; the next tile's K is split while
    // the products are in flight
    mma_3x_flushed<HD, kBN, HD>(
        oacc, base + C::kPHi, base + C::kPLo, base + C::kVtHi,
        base + C::kVtLo, [&] {
          if (j + 1 < n_tiles) {
            const int s1 = (j + 1) % C::kStages;
            mbar_wait(kfull0 + 8 * s1, ((j + 1) / C::kStages) & 1);
            split_in_place<kThreads>(base + C::kK + s1 * C::kKVTile,
                                     base + C::kKLo, C::kKVTile);
            fence_proxy_async();
          }
        });
  }

  // out = O / l in f32, rows past S not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + r_a + 8 * i;
    if (row >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * HD
                 + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<float2*>(dst + 8 * jj) =
          make_float2(oacc[4 * jj + 2 * i] * inv,
                      oacc[4 * jj + 2 * i + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_f32(&tm_q, q, B, S, H, HD, kBM)
      || !encode_f32(&tm_k, k, B, Tk, Hkv, HD, C::kBN)
      || !encode_f32(&tm_v, v, B, Tk, Hkv, HD, C::kBN)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kAlloc);
  if (err != cudaSuccess) return err;
  const int grid = (S + kBM - 1) / kBM * H * B;
  flash_fwd_sm90_f32<HD><<<grid, kThreads, C::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<float*>(out), B, S, Tk, H, Hkv, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 q, k, v and out, contiguous and 16-byte aligned, hd 64, 128 or 256;
// the same arguments as flash_attention_sm90.
int flash_attention_sm90_f32(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int Tk, int H, int Hkv,
                             int hd, int causal, int window, float scale,
                             void* stream) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q)
                          | reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v)
                          | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || S < 1 || Tk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
      || (hd != 64 && hd != 128 && hd != 256) || window < 0
      || static_cast<long long>((S + kBM - 1) / kBM) * H * B > INT32_MAX
      || addrs % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 64) {
    err = launch<64>(q, k, v, out, B, S, Tk, H, Hkv, causal, window, scale,
                     st);
  } else if (hd == 128) {
    err = launch<128>(q, k, v, out, B, S, Tk, H, Hkv, causal, window, scale,
                      st);
  } else {
    err = launch<256>(q, k, v, out, B, S, Tk, H, Hkv, causal, window, scale,
                      st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
