// Pieces shared by the f32 tensor-core kernels
// (flash_attention_sm90_f32.cu, mlstm_chunk_sm90_f32.cu): TF32 rounding
// and the hi/lo split, K-major f32 tiles in shared memory and their wgmma
// descriptors, the TF32 wgmma instructions, 4-D tensor maps of f32
// tensors, and the passes that split a tile into its hi and lo halves,
// in place or transposed.  The bf16 helpers of sm90_common.cuh
// (mbarriers, TMA copies, fences, the wgmma fence / commit / wait) are
// used as they are.
//
// 3xTF32.  A TF32 wgmma rounds its operands to 10 mantissa bits (about
// three decimal digits).  Each f32 operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), both by cvt.rna (round to nearest, ties away),
// and a product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi into
// one f32 accumulator: hi + lo carries x to about 2^-21 of its size and
// the dropped a_lo b_lo is below 2^-22 of a b, so the sum keeps f32's
// accuracy at three times one product's tensor-core time.
//
// Accumulation.  The tensor cores round each wgmma's sum toward zero, so
// a long chain of products into one accumulator drifts: O over 2,048 keys
// (768 products) drifts by about 3e-5 of its size, where f32 FMAs stay
// near 4e-6.  So no accumulator here takes a long chain: a score's hi x
// hi products go to two accumulators, one a half of K each, and the cross
// terms to a third (scores_3x); a product summed over many tiles goes to
// a fresh accumulator a tile, 64 columns at a time, which is then added
// to the running sum in f32, rounded to nearest (mma_3x_flushed).
//
// K-major tiles.  A TF32 wgmma reads both operands K-major (the transpose
// bits exist for 16-bit types only), so every tile is stored with its K
// dimension along the row.  A tile of R rows and K f32 columns is, for
// K >= 32, K / 32 boxes of R rows x 128 bytes in the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r % 8); the layout a TMA box of
// 32 f32 columns lands in), and for K = 16 one region of R rows x 64
// bytes in the 64-byte swizzle (chunk c of row r at chunk c ^ ((r / 2) %
// 4)).  Every box starts 1024-byte aligned.
#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int kF32BoxCols = 32;    // f32 columns of a 128-byte TMA box

// x rounded to TF32 (round to nearest, ties away from zero), as an f32
// whose low 13 mantissa bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// hi = tf32(x), lo = tf32(x - hi): hi + lo is x to about 2^-21 of |x|.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  float4 hi;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  return hi;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts64(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// Byte offset of 16-byte chunk ch (f32 columns 4 ch .. 4 ch + 3) of row r
// in a K-major tile of `rows` rows and K columns.
template <int K>
__device__ __forceinline__ uint32_t kmo(int r, int ch, int rows) {
  static_assert(K == 16 || K % kF32BoxCols == 0, "kmo: K");
  if constexpr (K == 16) {
    return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4);
  } else {
    return (ch / 8) * rows * kRowBytes + r * kRowBytes
           + (((ch % 8) ^ (r % 8)) << 4);
  }
}

// wgmma descriptor of k-step kk (8 TF32 columns, 32 bytes) of a K-major
// tile at `tile` with `rows` rows: 128-byte swizzle (layout type 1,
// 8-row groups 1024 bytes apart) for K >= 32, 64-byte swizzle (type 2,
// 512 bytes apart) for K = 16.  A k-step inside a swizzle row is a
// 32-byte step of the start address.
template <int K>
__device__ __forceinline__ uint64_t kmaj_desc(uint32_t tile, int kk,
                                              int rows) {
  if constexpr (K == 16) {
    const uint32_t addr = tile + kk * 32;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | static_cast<uint64_t>(1) << 16
           | static_cast<uint64_t>(512 >> 4) << 32
           | 2ull << 62;
  } else {
    return sw128_desc(tile + (kk / 4) * rows * kRowBytes + (kk % 4) * 32,
                      16, 1024);
  }
}

// D (64 x N, f32) = A (64 x 8) B (8 x N) when scale_d is 0, D += A B when
// it is 1: A and B TF32 in shared memory, both K-major (descriptors a and
// b).  N is 16, 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32: N");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

constexpr int kChunk = 64;   // accumulator columns a flush

// acc (64 x N, in the accumulator layout) += A B over K columns, three
// TF32 products a k-step (a_lo b_hi, a_hi b_lo, a_hi b_hi): A a K-major
// tile of 64 rows (hi at a_hi, lo at a_lo), B one of BRows rows, of which
// the first N are used.  64 columns at a time into a fresh accumulator,
// waited for and added to acc in f32; `during()` runs while the first
// chunk's products are in flight.
template <int N, int K, int BRows, typename F>
__device__ __forceinline__ void mma_3x_flushed(float* acc, uint32_t a_hi,
                                               uint32_t a_lo, uint32_t b_hi,
                                               uint32_t b_lo, F during) {
  static_assert(N % kChunk == 0, "mma_3x_flushed: N");
  constexpr int kRowB = K == 16 ? 64 : kRowBytes;
  float tmp[kChunk / 2];
#pragma unroll
  for (int x = 0; x < kChunk / 2; ++x) tmp[x] = 0.f;
#pragma unroll
  for (int c = 0; c < N / kChunk; ++c) {
    const uint32_t off = c * kChunk * kRowB;
    pin<kChunk / 2>(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      const uint64_t ah = kmaj_desc<K>(a_hi, kk, 64);
      const uint64_t bh = kmaj_desc<K>(b_hi + off, kk, BRows);
      wgmma_tf32<kChunk>(tmp, kmaj_desc<K>(a_lo, kk, 64), bh, kk > 0);
      wgmma_tf32<kChunk>(tmp, ah, kmaj_desc<K>(b_lo + off, kk, BRows), 1);
      wgmma_tf32<kChunk>(tmp, ah, bh, 1);
    }
    wgmma_commit();
    if (c == 0) during();
    wgmma_wait_all();
    pin<kChunk / 2>(tmp);
#pragma unroll
    for (int x = 0; x < kChunk / 2; ++x) acc[c * kChunk / 2 + x] += tmp[x];
  }
}

// s (64 x N, in the accumulator layout) = A B over K columns, both
// K-major (A 64 rows, B N rows): a_hi b_hi over each half of K into an
// accumulator of its own, a_lo b_hi + a_hi b_lo into a third, summed in
// f32 after the wait; `during()` runs while the products are in flight.
template <int N, int K, typename F>
__device__ __forceinline__ void scores_3x(float* s, uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b_hi,
                                          uint32_t b_lo, F during) {
  static_assert(K % 16 == 0, "scores_3x: K");
  float p0[N / 2], p1[N / 2], p2[N / 2];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) p0[x] = p1[x] = p2[x] = 0.f;
  pin<N / 2>(p0);
  pin<N / 2>(p1);
  pin<N / 2>(p2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t ah = kmaj_desc<K>(a_hi, kk, 64);
    const uint64_t bh = kmaj_desc<K>(b_hi, kk, N);
    if (kk < K / 16) {
      wgmma_tf32<N>(p0, ah, bh, kk > 0);
    } else {
      wgmma_tf32<N>(p1, ah, bh, kk > K / 16);
    }
    wgmma_tf32<N>(p2, kmaj_desc<K>(a_lo, kk, 64), bh, kk > 0);
    wgmma_tf32<N>(p2, ah, kmaj_desc<K>(b_lo, kk, N), 1);
  }
  wgmma_commit();
  during();
  wgmma_wait_all();
  pin<N / 2>(p0);
  pin<N / 2>(p1);
  pin<N / 2>(p2);
#pragma unroll
  for (int x = 0; x < N / 2; ++x) s[x] = (p2[x] + p0[x]) + p1[x];
}

// Split the `bytes` bytes of f32 at `tile` into hi, in place, and lo, at
// the same offsets from `lo`: an elementwise pass, so any layout.  Run by
// `Threads` threads of the block.
template <int Threads>
__device__ __forceinline__ void split_in_place(uint32_t tile, uint32_t lo,
                                               int bytes) {
  for (int i = threadIdx.x % Threads * 16; i < bytes; i += Threads * 16) {
    float4 l;
    const float4 h = split4(lds128(tile + i), l);
    sts128(tile + i, h);
    sts128(lo + i, l);
  }
}

// The K-major tile `raw` of KEYS rows and COLS columns (as TMA lands it),
// each row times w[row] when w is given, transposed into the K-major tile
// of COLS rows and KEYS columns and split into hi (at `hi`) and lo (at
// `lo`).  Each item takes 4 rows x 4 columns: four 16-byte loads, a 4 x 4
// transpose in registers, four 16-byte stores to each half.  Lane l of a
// warp takes row quad l % (KEYS / 4), so a warp's loads and stores spread
// over the swizzle's chunks.  Run by `Threads` threads of the block.
template <int KEYS, int COLS, int Threads>
__device__ __forceinline__ void transpose_split(uint32_t raw, uint32_t hi,
                                                uint32_t lo, const float* w) {
  constexpr int kQuads = KEYS / 4;
  for (int idx = threadIdx.x % Threads; idx < kQuads * (COLS / 4);
       idx += Threads) {
    const int kq = idx % kQuads;
    const int nc = idx / kQuads;
    float4 x[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      x[ii] = lds128(raw + kmo<COLS>(4 * kq + ii, nc, KEYS));
      if (w != nullptr) {
        const float s = w[4 * kq + ii];
        x[ii].x *= s;
        x[ii].y *= s;
        x[ii].z *= s;
        x[ii].w *= s;
      }
    }
    const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                            make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                            make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                            make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 l;
      const float4 h = split4(cols[jj], l);
      const uint32_t off = kmo<KEYS>(4 * nc + jj, kq, COLS);
      sts128(hi + off, h);
      sts128(lo + off, l);
    }
  }
}

// The 4-D map (hd, heads, seq, batch) of a contiguous f32 tensor (batch,
// seq, heads, hd), box (32, 1, rows, 1), 128-byte swizzle: the K-major
// tile layout above, one box per 32 columns; rows past seq read as zeros.
bool encode_f32(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, int hd, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 4;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kF32BoxCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
