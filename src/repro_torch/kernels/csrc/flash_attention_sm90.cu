// Hand-written Hopper kernel for blockwise (flash) GQA attention, forward,
// on the tensor cores: bf16 q, k, v at head dims 64 and 128.
//
// It replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:26) on the bf16 route; f32 and
// other head dims stay on the CUDA-core kernel of flash_attention.cu (the
// "SIMT kernel"), which documents the function computed.  The semantics
// are the same: for q (B,S,H,hd) and k/v (B,T,Hkv,hd) in that public
// layout,
//
//   out[b,s,h] = softmax_t( q[b,s,h] . k[b,t,kv] / sqrt(hd) + mask ) v[b,t,kv]
//
// with kv = h / (H / Hkv) (no KV replication), causal and window masks on
// absolute positions (key t <= query s, and s - t < window when window >
// 0), a masked score the reference's finite -2^20 (a row whose window
// holds no key averages every key, as the oracle does), keys past T
// excluded outright, no mask at all when not causal, and the output
// divided by max(l, 1e-30) and written in bf16.
//
// Bound on this card: by operations.  At Llama-3 8B's prefill (B 4,
// S = T = 1024, H 32, Hkv 8, hd 128) q k^T and p v over the causal pairs
// are 34 GFLOP (35 us at 989 TFLOP/s bf16) against 84 MB of operands
// (25 us at 3.35 TB/s).  So both products run on the tensor cores:
//
// - The work is a list of items, one per (b, h, 128-row q tile), the
//   longest (diagonal-most) q tiles first.  A persistent grid of one
//   block per SM walks the list (block c takes items c, c + grid, ...),
//   so the next item's loads overlap this item's last tiles and its
//   epilogue, and the short tiles fill the tail.
// - Two consumer warpgroups own 64 rows each (wgmma's M).  One lane of a
//   third, producer warpgroup issues every copy; the producer hands its
//   registers to the consumers (setmaxnreg 24 / 240).  Within a
//   warpgroup the two products and the softmax run in turn; the other
//   warpgroup's work fills the gaps.
// - TMA loads q into one of two slots (the next item's q arrives while
//   this one runs) and streams 128-key K and V tiles through a
//   kStages-deep ring in shared memory that runs on across items.  Each
//   slot and stage has a "full" mbarrier (transaction bytes) and an
//   "empty" one (the 256 consumer threads).  The maps are 4-D (hd,
//   heads, seq, batch) on the public layout, so the GQA head is a
//   coordinate and rows past S or T arrive as zeros.  A tile is hd / 64
//   boxes of 128 rows x 128 B, with the 128-byte swizzle that the wgmma
//   descriptors name.
// - S = Q K^T is wgmma m64n128k16 from shared memory (K is K-major), f32
//   accumulators in registers.  Masks (only on tiles that straddle the
//   diagonal, the window edge or T) and the online softmax run in
//   registers, in base 2 with the scale folded into the exponent's FMA
//   (one ex2.approx a score); a row's 32 entries per thread sit in 4
//   lanes, so its max takes 2 shuffles, and the denominator l is summed
//   per thread and across the 4 lanes once, at the end.
// - O += P V: P is rounded to bf16 in registers, where the accumulator
//   layout of S is the A-operand layout of the next wgmma, so P never
//   touches shared memory; V (MN-major) is B with the transpose bit.  O
//   is rescaled by alpha in registers.
// - Epilogue: O times one reciprocal of max(l, 1e-30) a row goes in bf16
//   into the warpgroup's rows of the q slot, and one TMA store a box
//   writes it, dropping rows past S.
// - Every output is one fixed sequence of tiles and k-steps: no atomics,
//   no split over keys, so the kernel is bitwise repeatable.
//
// The launcher returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments the kernel does not take, or a tensor map that cannot be
// encoded) so the caller raises; the output comes from the caller.
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so the library links without -lcuda.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;           // query rows per block (2 x 64)
constexpr int kBN = 128;           // keys per tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;  // = 64,512 of the SM's 65,536
constexpr int kBoxCols = 64;       // bf16 columns of a 128-byte TMA box
constexpr int kRowBytes = 128;     // a box row; one swizzle span
constexpr int kBoxBytes = 128 * kRowBytes;  // a box of 128 rows
constexpr float kMasked = -1048576.f;       // -2^20, as the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1ll << 34;  // ~8 s at the H100's clock

// Byte offsets in the block's shared memory (from a 1024-byte-aligned
// base, as the 128-byte swizzle needs): two q slots, the K and V rings,
// then the mbarriers.  At hd 128: 64 + 128 KB.
template <int HD>
struct Layout {
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kTile = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kAlloc = kBars + 8 * (4 + 2 * kStages) + 1024;
};

static_assert(kBM == 128 && kBN == 128,
              "one TMA box shape (128 rows) serves Q, K and V");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A phase that never
// completes (a lost copy) traps after kHangCycles instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > kHangCycles) __trap();
  }
}

// One TMA box (kBoxCols, 1, 128, 1) at coordinates (c0, c1, c2, c3) of a
// 4-D map into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA box (kBoxCols, 1, 64, 1) from shared memory at `src` to
// coordinates (c0, c1, c2, c3) of a 4-D map; rows past the map's extent
// are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// Barrier `id` (1 or 2) over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, 128-byte swizzle (layout type 1 in bits 62-63).  Every swizzle
// atom (8 rows x 128 B) is 1024-byte aligned, so the base offset is 0 and
// a k-step inside an atom is a 32-byte step of the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x in one MUFU instruction (flush-to-zero; the inputs are scores
// relative to their row's max, so 2^x lies in [0, 1])
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 128, f32) = A (64 x 16) B (16 x 128) (the _init form) or
// D += A B: A and B bf16 in shared memory, both K-major (descriptors a and
// b).  The _init form writes D without reading it, so the registers of the
// last tile's scores are free while P V runs.
__device__ __forceinline__ void wgmma_ss_n128_init(float* d, uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x N, f32) += A (64 x 16) B (16 x N): A bf16 in registers (four
// packed pairs per thread, the accumulator layout of a 16-bit wgmma), B
// bf16 in shared memory, MN-major (the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n64(d, a, b);
  }
}

// One unit of work: the 128-row q tile q0 of head h in batch b (kv head
// kh), against key tiles kt0 .. kt0 + n_tiles - 1.
struct Item {
  int b, h, kh, q0, kt0, n_tiles;
};

// Item w of the grid's list, longest q tiles (the diagonal-most) first.
__device__ __forceinline__ Item item_at(int w, int B, int S, int Tk, int H,
                                        int Hkv, int causal, int window) {
  Item it;
  const int n_qt = (S + kBM - 1) / kBM;
  const int bh = B * H;
  it.q0 = (n_qt - 1 - w / bh) * kBM;
  it.h = (w % bh) % H;
  it.b = (w % bh) / H;
  it.kh = it.h / (H / Hkv);
  // the key tiles this q tile needs (as the SIMT kernel: with S > T a row
  // may have no key in its window and then keeps every key, so the window
  // skips nothing there)
  const int q_last = min(it.q0 + kBM, S) - 1;
  int k_end = Tk;
  int k_begin = 0;
  if (causal) {
    k_end = min(Tk, q_last + 1);
    if (window > 0 && S <= Tk) k_begin = max(0, it.q0 - window + 1);
  }
  it.kt0 = k_begin / kBN;
  it.n_tiles = (k_end + kBN - 1) / kBN - it.kt0;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o, int B, int S,
               int Tk, int H, int Hkv, int causal, int window,
               float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: q slot full / empty (2 each), then K/V stage full / empty
  const uint32_t qfull0 = base + L::kBars;
  const uint32_t qempty0 = qfull0 + 16;
  const uint32_t full0 = qempty0 + 16;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int n_items = (S + kBM - 1) / kBM * H * B;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(qfull0 + 8 * x, 1);
      mbar_init(qempty0 + 8 * x, kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform in the compiler's eyes (a shuffle),
  // so that each branch keeps its own register budget
  const int wg_idx = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg_idx == kConsumers / 128) {
    // the producer warpgroup: one lane issues every copy.  Items take the
    // q slots in turn; their K/V tiles run through one ring, tile g into
    // stage g % kStages once the consumers have released tile g - kStages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int g = 0;
      int n = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item it = item_at(w, B, S, Tk, H, Hkv, causal, window);
        const int slot = n % 2;
        if (n >= 2) mbar_wait(qempty0 + 8 * slot, (n / 2 - 1) & 1);
        mbar_expect_tx(qfull0 + 8 * slot, L::kTile);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(base + L::kQ + slot * L::kTile + x * kBoxBytes, &tm_q,
                   qfull0 + 8 * slot, x * kBoxCols, it.h, it.q0, it.b);
        }
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty0 + 8 * s, (g / kStages - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, 2 * L::kTile);
          const int k0 = (it.kt0 + j) * kBN;
          for (int x = 0; x < L::kBoxes; ++x) {
            tma_load(base + L::kK + s * L::kTile + x * kBoxBytes, &tm_k,
                     full0 + 8 * s, x * kBoxCols, it.kh, k0, it.b);
            tma_load(base + L::kV + s * L::kTile + x * kBoxBytes, &tm_v,
                     full0 + 8 * s, x * kBoxCols, it.kh, k0, it.b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  // a consumer: warpgroup wg owns rows wg*64 .. wg*64+63 of each q tile;
  // in the accumulator layout this thread holds rows r0 and r0 + 8 and,
  // of each 8 columns jj, columns 8 jj + 2 tq and 8 jj + 2 tq + 1
  const int wg = wg_idx;
  const int tq = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  // scores stay unscaled until the exponent: a masked score is the
  // reference's -2^20 after scaling, so -2^20 / scale before
  const float masked = kMasked / scale_log2;

  float sacc[kBN / 2];
  float oacc[HD / 2];
  uint32_t pa[kBN / 4];
  int g = 0;
  int n = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
    const Item it = item_at(w, B, S, Tk, H, Hkv, causal, window);
    const int slot = n % 2;
    const int r0 = it.q0 + row;
    const int wg_first = it.q0 + wg * 64;
    const int wg_last = wg_first + 63;
    const int kt0 = it.kt0;
    const uint32_t q_tile =
        base + L::kQ + slot * L::kTile + wg * 64 * kRowBytes;
    float m_run[2] = {masked, masked};
    float l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) oacc[x] = 0.f;

    mbar_wait(qfull0 + 8 * slot, (n / 2) & 1);
    for (int j = 0; j < it.n_tiles; ++j, ++g) {
      const int s = g % kStages;
      const int k0 = (kt0 + j) * kBN;
      const uint32_t k_tile = base + L::kK + s * L::kTile;
      const uint32_t v_tile = base + L::kV + s * L::kTile;
      mbar_wait(full0 + 8 * s, (g / kStages) & 1);

      // S = Q K^T: hd / 16 k-steps, 4 per 64-column box
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        const uint64_t a = sw128_desc(q_tile + off, 16, 1024);
        const uint64_t b = sw128_desc(k_tile + off, 16, 1024);
        if (kk == 0) {
          wgmma_ss_n128_init(sacc, a, b);
        } else {
          wgmma_ss_n128(sacc, a, b);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<kBN / 2>(sacc);

      // masks only where the tile straddles an edge
      const bool edge =
          k0 + kBN > Tk
          || (causal && (k0 + kBN - 1 > wg_first
                         || (window > 0 && k0 <= wg_last - window)));
      if (edge) {
        // in column offsets c = 8 jj + e from this thread's first key
        // k0 + 2 tq (compile-time constants below): keys from `end` on do
        // not exist; causal row r masks keys above hi[i] and, with a
        // window, at or below lo[i]
        const int first = k0 + 2 * tq;
        const int end = Tk - first;
        int hi[2], lo[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          hi[i] = causal ? r0 + 8 * i - first : kBN;
          lo[i] = causal && window > 0 ? r0 + 8 * i - window - first : -1;
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
              if (c >= end) x = -INFINITY;  // no such key: weight exactly 0
            }
          }
        }
      }

      // online softmax in base 2, the scale folded into the exponent's FMA:
      // running max m, per-thread partial denominator l
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_run[i];
#pragma unroll
        for (int jj = 0; jj < kBN / 8; ++jj) {
          mx = fmaxf(mx,
                     fmaxf(sacc[4 * jj + 2 * i], sacc[4 * jj + 2 * i + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = exp2_fast((m_run[i] - mx) * scale_log2);
        m_run[i] = mx;
        const float mx_scaled = mx * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sacc[4 * jj + 2 * i + c];
            x = exp2_fast(fmaf(x, scale_log2, -mx_scaled));
            sum += x;
          }
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
      // P in bf16: keys 16 kk .. 16 kk + 15 are accumulator columns of
      // blocks 2 kk and 2 kk + 1, i.e. A-operand registers of k-step kk
#pragma unroll
      for (int x = 0; x < kBN / 4; ++x) {
        pa[x] = pack_bf16(sacc[2 * x], sacc[2 * x + 1]);
      }

      // O += P V: kBN / 16 k-steps of 16 keys (16 rows of 128 B)
      pin<HD / 2>(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wgmma_pv<HD>(oacc, pa + 4 * kk,
                     sw128_desc(v_tile + kk * 16 * kRowBytes, kBoxBytes,
                                1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<HD / 2>(oacc);
      mbar_arrive(empty0 + 8 * s);
    }
    // the output tile, through this warpgroup's rows of the q slot (read
    // for the last time by the last S = Q K^T): bf16 in the 128-byte
    // swizzle (16-byte chunk c of row r at chunk c ^ (r % 8), conflict-free
    // for a warp's 8 rows), then one TMA store per box, which drops rows
    // past S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      // one division a row, then products: within an f32 ulp of dividing
      // each entry, far below the bf16 rounding of the output
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int rr = row - wg * 64 + 8 * i;    // row in the warpgroup's 64
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const uint32_t dst = q_tile + (jj / 8) * kBoxBytes + rr * kRowBytes
                             + ((jj % 8) ^ (rr % 8)) * 16 + 4 * tq;
        const uint32_t v = pack_bf16(oacc[4 * jj + 2 * i] * inv,
                                     oacc[4 * jj + 2 * i + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst), "r"(v)
                     : "memory");
      }
    }
    // make the writes visible to the TMA (async proxy), then store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(1 + wg);
    if (threadIdx.x % 128 == 0) {
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_store(&tm_o, q_tile + x * kBoxBytes, x * kBoxCols, it.h,
                  it.q0 + wg * 64, it.b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the slot may be refilled once the store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    warpgroup_sync(1 + wg);
    mbar_arrive(qempty0 + 8 * slot);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (hd, heads, seq, batch) of a contiguous bf16 tensor
// (batch, seq, heads, hd), box (64, 1, rows, 1), 128-byte swizzle; rows
// past seq read as zeros and are not written.
bool encode(CUtensorMap* map, const void* ptr, int batch, int seq,
            int heads, int hd, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode(&tm_q, q, B, S, H, HD, kBM)
      || !encode(&tm_k, k, B, Tk, Hkv, HD, kBN)
      || !encode(&tm_v, v, B, Tk, Hkv, HD, kBN)
      || !encode(&tm_o, out, B, S, H, HD, 64)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<HD>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a persistent grid: one block per SM walks the item list
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                device) != cudaSuccess) {
    return cudaGetLastError();
  }
  const int n_items = (S + kBM - 1) / kBM * H * B;
  const int grid = n_items < sms ? n_items : sms;
  flash_fwd_sm90<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, B, S, Tk, H, Hkv, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v and out, contiguous and 16-byte aligned, hd 64 or 128.
int flash_attention_sm90(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int Tk, int H, int Hkv,
                         int hd, int causal, int window, float scale,
                         void* stream) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(q)
                          | reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v)
                          | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || S < 1 || Tk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0
      || (hd != 64 && hd != 128) || window < 0
      || static_cast<long long>((S + kBM - 1) / kBM) * H * B > INT32_MAX
      || addrs % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hd == 128 ? launch<128>(q, k, v, out, B, S, Tk, H, Hkv, causal,
                              window, scale, st)
                : launch<64>(q, k, v, out, B, S, Tk, H, Hkv, causal,
                             window, scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
