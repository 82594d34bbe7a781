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
// Bound by device-memory bytes on this card: P is tiny (8 cut slots at the
// white-wine width, 2 for domain adaptation) and D wide (242,628 and
// 925,590), so the least the round can move is A once, v, g_other and
// mask in and v_new out (11.6 MB at white-wine in f32, 3.5 us at 3.35
// TB/s).  The round needs A twice: the second mat-vec reads v_new, which
// depends on the first one's result through every column.  The TPU kernel
// keeps its tiles in VMEM across a grid that runs in order.  Hopper's
// blocks run concurrently, but the main paths' A (7.8 MB at white-wine,
// 7.4 MB at domain adaptation, in f32) fits in the shared memory of the
// card's 132 SMs.  So the round is one persistent, cooperative launch of
// one or two blocks per SM (the wrapper sizes it, inner_round.round_plan),
// block b owning columns [b cw, (b + 1) cw) of every row, cw a multiple
// of 8:
//
//   phase 0   the block's threads start bulk copies (cp.async.bulk, one
//             a row from its own thread, completing on mbarriers) of its
//             slices of v and of A into shared memory, and copy the
//             entries of each slice that are not 16-byte aligned (rows of
//             A are not, in general: a slice sits in shared memory at its
//             source's offset from a 16-byte boundary).  Once A's rows
//             have landed the block sums A v over its slice, by warp
//             shuffles and then the warps in order, into a (P, blocks)
//             partial buffer, and starts the copies of g_other and mask,
//             which land during the barrier.
//   barrier   one grid-wide barrier: an acq_rel add to a counter and a
//             spin on it.  The cooperative launch refuses a grid whose
//             blocks cannot all be resident at once, so no block waits on
//             one that never starts.
//   phase 1   every block sums the partials of each row in one fixed order
//             (the same bits in every block) and forms w; then, from
//             shared memory, g_cut = w^T A (rows in order for each column)
//             and v_new, written to device memory, and the partial sums of
//             A v_new.  Up to 8 rows this is one pass that reads each
//             column's entries of A once; above, two (v_new is kept in
//             shared memory between them).
//   epilogue  the block that finishes phase 1 last (a second add to the
//             same counter) sums those partials per row in a fixed order,
//             applies the cv1 / s' / gamma' arithmetic and resets the
//             counter to 0.
//
// Where the slices do not fit in shared memory (the wrapper decides from
// the bytes), the same kernel streams: phases 0 and 1 read A's slice and
// the vectors from device memory (above 8 rows v_new is read back from
// there too).  It takes every P <= kMaxRows and every D.
//
// Batched (the sweep engine's run axis, which vmapping the Pallas kernel
// turns into a grid axis): fused_cut_round_runs puts R rounds into one
// cooperative launch of blocks x R blocks, grid y the run.  Every operand
// carries a run stride (0 where the runs share it), each run has its own
// counter and scratch, and its blocks meet at their own barrier.  The
// wrapper plans the partition for R runs at once (round_plan's `runs`).
// R runs' A fits on chip only at small R (7.8 MB a white-wine run against
// the SMs' 30.7 MB), and streaming reads A twice; so where all of A does
// not fit, a batched plan keeps the partition and holds the first `rows`
// rows of each slice in shared memory (kPartial): phase 0 reads every row
// through registers (the first read, kept in L2 by an evict_last policy)
// and stores the rows held, and phase 1 reads each row from shared or
// device memory by one predicated load, so that every row's load issues
// together.  The vectors stay in device memory there, to leave the shared
// memory to A.
//
// No atomics on values: every sum is taken in f32 in a fixed order, so the
// result is bitwise identical run to run, which the replay and resume
// contracts rely on.  The counter (one int per stream, 0 between calls,
// shared with cut_matvec's ticket) only elects blocks.  A is f32 or bf16,
// the vectors and rows f32; the step scalars are kernel arguments.  The
// launcher returns the launch's error so the caller raises on a refused
// launch; outputs and the (2, P, blocks) scratch come from the caller.

#include <cstdint>

#include "cut_common.cuh"
#include "sm90_common.cuh"

namespace {

// Cut rows one call takes (inner_round.MAX_ROWS; the weights live in
// shared memory).
constexpr int kMaxRows = 4096;
// mbarriers over A's rows held in shared memory
constexpr int kMaxPieces = 32;

// Where A's slice and the vectors live (inner_round.STREAMED, ON_CHIP,
// PARTIAL): all in device memory; all of A and the four vector slices in
// shared memory; the first `rows` rows of A in shared memory and the rest,
// and the vectors, in device memory.
constexpr int kStreamed = 0;
constexpr int kOnChip = 1;
constexpr int kPartial = 2;

struct Steps {
  float eta_z, eta_s, eta_dual, rho2;
};

struct RoundArgs {
  const void* a;
  const float* v;
  const float* g_other;
  const float* mask;
  const float* c;
  const float* active;
  const float* s;
  const float* gamma;
  float* partial;   // (2, P, blocks)
  int* counter;     // 0 between calls
  float* v_new;
  float* cv1;
  float* s_new;
  float* gamma_new;
  int p;
  long long d, cw;
  Steps k;
  int rows;         // rows of A in shared memory (kPartial)
};

__host__ __device__ constexpr long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory, byte offsets (inner_round.round_smem mirrors
// it): on chip, the mbarriers (v; g_other and mask; A's pieces), the
// weights w, four vector slices (v, g_other, mask, v_new) of cw + 4
// floats and A's slice, each row in cw + V entries; partly on chip, w and
// the first `rows` rows of A's slice; streaming, w alone.  Every region
// starts 16-byte aligned.
struct Layout {
  int rows_per_piece, n_pieces;
  long long w, vec, a, total;
};

__host__ __device__ inline Layout layout_of(int p, long long cw, int es,
                                            int mode, int rows) {
  const int held = mode == kOnChip ? p : mode == kPartial ? rows : 0;
  Layout l;
  l.rows_per_piece = (p + kMaxPieces - 1) / kMaxPieces;
  l.n_pieces = (p + l.rows_per_piece - 1) / l.rows_per_piece;
  l.w = mode == kOnChip ? round16(8LL * (2 + l.n_pieces)) : 0;
  l.vec = l.w + round16(4LL * p);
  l.a = l.vec + (mode == kOnChip ? 16 * (cw + 4) : 0);
  l.total = held > 0 ? l.a + held * (cw * es + 16) : l.vec;
  return l;
}

// max(0, x) as torch.maximum / jnp.maximum give it: NaN propagates.
__device__ __forceinline__ float relu_nan(float x) {
  return (x != x) ? x : fmaxf(0.f, x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An L2 policy that keeps what it loads ahead of other lines: a streamed
// row's first read, so that its second read finds it in the 50 MB L2.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// (Read-only data, so the loads carry no side effect and issue as early
// as plain loads of A do.)
__device__ __forceinline__ float ld_last(const float* p, long long i,
                                         uint64_t pol) {
  float x;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
      : "=f"(x) : "l"(p + i), "l"(pol));
  return x;
}

__device__ __forceinline__ float ld_last(const __nv_bfloat16* p, long long i,
                                         uint64_t pol) {
  unsigned short x;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;\n"
      : "=h"(x) : "l"(p + i), "l"(pol));
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// Entry j of a row held on chip at shared address `s` (from_s) or in
// device memory at `g`: one load or the other, predicated, so that the
// loads of every row issue together whichever rows are held.  The asm
// declares no memory access (so the loads of several columns may issue
// together); `s` must therefore come from `after_barrier`, which ties
// every such load to the barrier that follows the stores of the rows
// held.
__device__ __forceinline__ float ld_either(uint32_t s, const float* g,
                                           long long j, bool from_s) {
  float x;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p ld.shared.f32 %0, [%1];\n@!p ld.global.nc.f32 %0, [%2];\n}\n"
      : "=f"(x) : "r"(s + static_cast<uint32_t>(4 * j)), "l"(g + j),
        "r"(int(from_s)));
  return x;
}

__device__ __forceinline__ float ld_either(uint32_t s,
                                           const __nv_bfloat16* g,
                                           long long j, bool from_s) {
  unsigned short x;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p ld.shared.b16 %0, [%1];\n@!p ld.global.nc.b16 %0, [%2];\n}\n"
      : "=h"(x) : "r"(s + static_cast<uint32_t>(2 * j)), "l"(g + j),
        "r"(int(from_s)));
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// x, opaque to the compiler and ordered after every memory access and
// barrier before it: a shared-memory address handed to ld_either only
// once the rows it reads are stored and the block has met.
__device__ __forceinline__ uint32_t after_barrier(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x) : "memory");
  return y;
}

__device__ __forceinline__ float from_f(float x, const float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x,
                                                const __nv_bfloat16*) {
  return __float2bfloat16(x);   // exact: x was read from a bf16
}

template <typename TA, int kMode>
__device__ __forceinline__ void round_body(const RoundArgs& g) {
  constexpr bool kVecs = kMode == kOnChip;   // the vectors on chip
  constexpr int V = 16 / sizeof(TA);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][kRows];
  __shared__ int last;
  const int p = g.p;
  const long long d = g.d;
  const int n_blocks = gridDim.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * g.cw;
  const int len = static_cast<int>(min(g.cw, d - c0));
  const TA* a = static_cast<const TA*>(g.a) + c0;   // row 0 of the slice
  const Layout lay = layout_of(p, g.cw, sizeof(TA), kMode, g.rows);
  const int held = g.rows;   // rows of A on chip, kPartial
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* w = reinterpret_cast<float*>(smem + lay.w);
  const int vs = static_cast<int>(g.cw) + 4;   // floats a vector region
  float* regions = reinterpret_cast<float*>(smem + lay.vec);
  float* vn_s = regions + 3 * vs;
  TA* a_reg = reinterpret_cast<TA*>(smem + lay.a);
  const int rs = static_cast<int>(g.cw) + V;   // entries a row region
  // row r of the slice starts ((m0 + r dm) mod V) entries past a 16-byte
  // boundary, in device memory and in its shared-memory region alike
  const int m0 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(a) / sizeof(TA)) % V);
  const int dm = static_cast<int>(d % V);
  const float* src[3] = {g.v + c0, g.g_other + c0, g.mask + c0};
  const float* vec[3] = {src[0], src[1], src[2]};   // v, g_other, mask
  uint64_t pol = 0;
  if constexpr (kMode == kPartial) pol = evict_last_policy();
  auto bar = [&](int i) { return smem_u32(bars + i); };
  auto a_row = [&](int r) -> const TA* {
    if constexpr (kMode == kOnChip) {
      return a_reg + r * rs + ((m0 + r * dm) & (V - 1));
    } else if constexpr (kMode == kPartial) {
      return r < held ? a_reg + r * rs + ((m0 + r * dm) & (V - 1))
                      : a + static_cast<long long>(r) * d;
    } else {
      return a + static_cast<long long>(r) * d;
    }
  };
  // entry j of row r (at a_row(r))
  auto a_at = [&](const TA* row, int r, int j) -> float {
    if constexpr (kMode == kOnChip) {
      return to_f(row[j]);
    } else if constexpr (kMode == kPartial) {
      return r < held ? to_f(row[j]) : ld(row, j);
    } else {
      return ld(row, j);
    }
  };
  // partly on chip, row r of the slice in device memory, and the offset
  // in a_reg of its shared-memory region (row 0's where it is not held)
  auto g_row = [&](int r) { return a + static_cast<long long>(r) * d; };
  auto s_off = [&](int r) {
    const int q = r < held ? r : 0;
    return q * rs + ((m0 + q * dm) & (V - 1));
  };
  // (read by ld_either, after the grid barrier)
  uint32_t a_sh = smem_u32(a_reg);
  auto vec_at = [&](int q, int j) -> float {
    if constexpr (kVecs) {
      return vec[q][j];
    } else if constexpr (kMode == kPartial) {
      // v is read again after the barrier: kept in L2
      return q == 0 ? ld_last(vec[0], j, pol) : ld(vec[q], j);
    } else {
      return ld(vec[q], j);
    }
  };

  // phase 0: the slices on their way into shared memory
  if constexpr (kMode == kOnChip) {
    if (threadIdx.x == 0) {
      mbar_init(bar(0), 1);
      mbar_init(bar(1), 1);
      for (int k = 0; k < lay.n_pieces; ++k) {
        const int r0 = k * lay.rows_per_piece;
        mbar_init(bar(2 + k), min(p, r0 + lay.rows_per_piece) - r0);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // row r's copy from thread r, v's from the last thread, all at once
    for (int r = threadIdx.x; r < p; r += kThreads) {
      const TA* row = a + static_cast<long long>(r) * d;
      const uint32_t b = bar(2 + r / lay.rows_per_piece);
      mbar_expect_tx(b, body_bytes(row, len));
      bulk_body(a_reg + r * rs, row, len, b);
    }
    if (threadIdx.x == kThreads - 1) {
      mbar_expect_tx(bar(0), body_bytes(src[0], len));
      bulk_body(regions, src[0], len, bar(0));
    }
    // heads and tails: 8 entries of each vector, 2V of each row
    if (threadIdx.x < 3 * 8) {
      const int q = threadIdx.x / 8;
      copy_end(regions + q * vs, q == 0 ? src[0] : q == 1 ? src[1] : src[2],
               len, threadIdx.x % 8);
    }
    for (int i = threadIdx.x; i < p * 2 * V; i += kThreads) {
      const int r = i / (2 * V);
      copy_end(a_reg + r * rs, a + static_cast<long long>(r) * d, len,
               i % (2 * V));
    }
    for (int q = 0; q < 3; ++q) {
      vec[q] = regions + q * vs + span_of(src[q], len).mis;
    }
    __syncthreads();
    mbar_wait(bar(0), 0);
  }

  // partial[(r, block)] = A[r, slice] . x[slice] for every row, 8 rows a
  // sweep; in phase 0 on chip each sweep first waits for its rows to land;
  // partly on chip, phase 0 reads every row from device memory (kept in
  // L2 for phase 1) and stores the rows it holds into shared memory
  float* part0 = g.partial;
  float* part1 = g.partial + static_cast<long long>(p) * n_blocks;
  auto store_rows = [&](const float* acc, int p0, int nr, float* part) {
    const float sum = rows_sum(acc, nr, red);
    if (threadIdx.x < nr) {
      part[static_cast<long long>(p0 + threadIdx.x) * n_blocks
           + blockIdx.x] = sum;
    }
  };
  auto mat_vec = [&](auto x, float* part, bool landing) {
    for (int p0 = 0; p0 < p; p0 += kRows) {
      const int nr = min(kRows, p - p0);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if constexpr (kMode == kPartial) {
        const TA* g0 = g_row(p0);
        if (landing) {
          // the loads of every row first, then the sums, then the stores
          // of the rows held: small predicated steps, so that the loads of
          // four columns are in flight together
#pragma unroll 4
          for (int j = threadIdx.x; j < len; j += kThreads) {
            const float xj = x(j);
            float e[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              e[r] = r < nr ? ld_last(g0 + static_cast<long long>(r) * d, j,
                                      pol)
                            : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < nr) acc[r] += e[r] * xj;
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < nr && p0 + r < held) {
                a_reg[s_off(p0 + r) + j] =
                    from_f(e[r], static_cast<const TA*>(nullptr));
              }
            }
          }
        } else {
#pragma unroll 2
          for (int j = threadIdx.x; j < len; j += kThreads) {
            const float xj = x(j);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < nr) {
                const int q = p0 + r;
                acc[r] += ld_either(a_sh + s_off(q) * sizeof(TA),
                                    g0 + static_cast<long long>(r) * d, j,
                                    q < held) * xj;
              }
            }
          }
        }
      } else {
        const TA* row[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          row[r] = a_row(p0 + min(r, nr - 1));
          if constexpr (kMode == kOnChip) {
            if (landing && r < nr) {
              mbar_wait(bar(2 + (p0 + r) / lay.rows_per_piece), 0);
            }
          }
        }
#pragma unroll 4
        for (int j = threadIdx.x; j < len; j += kThreads) {
          const float xj = x(j);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) acc[r] += a_at(row[r], p0 + r, j) * xj;
          }
        }
      }
      store_rows(acc, p0, nr, part);
    }
  };
  mat_vec([&](int j) { return vec_at(0, j); }, part0, true);
  // g_other and mask, needed after the barrier, start once A has landed,
  // so they do not share the bandwidth A's copies need
  if constexpr (kVecs) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar(1), body_bytes(src[1], len)
                                 + body_bytes(src[2], len));
      bulk_body(regions + vs, src[1], len, bar(1));
      bulk_body(regions + 2 * vs, src[2], len, bar(1));
    }
  }

  // w from the partials of A v, formed in one fixed order (the same bits
  // wherever it is formed)
  auto form_w = [&](auto put) {
    for (int p0 = 0; p0 < p; p0 += kRows) {
      const int nr = min(kRows, p - p0);
      const float mv = partial_totals(part0, p0, nr, n_blocks, red);
      if (threadIdx.x < nr) {
        const int r = p0 + threadIdx.x;
        const float act = g.active[r];
        const float cv0 = (mv - g.c[r]) * act;
        const float viol = (cv0 + g.s[r]) * act;
        put(r, (g.gamma[r] + g.k.rho2 * viol) * act);
      }
    }
  };
  // the grid-wide barrier: every block's partials of A v (and its rows
  // held) are stored
  __syncthreads();
  if (threadIdx.x == 0) {
    ticket_add(g.counter);
    wait_count(g.counter, n_blocks);
  }
  __syncthreads();
  // phase 1: w from the partials, the same bits in every block
  form_w([&](int r, float x) { w[r] = x; });
  __syncthreads();
  if constexpr (kMode == kPartial) a_sh = after_barrier(a_sh);
  if constexpr (kVecs) mbar_wait(bar(1), 0);
  auto v_new_at = [&](int j, float g_cut) {
    const float x = vec_at(0, j)
        - g.k.eta_z * (vec_at(1, j) + g_cut * vec_at(2, j));
    g.v_new[c0 + j] = x;
    return x;
  };
  if (p <= kRows) {
    // one pass: each column's entries of A give g_cut, then v_new, then
    // their share of A v_new (the sums in the order of the two passes)
    const TA* row[kRows];
    float wr[kRows], acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q = min(r, p - 1);
      row[r] = kMode == kPartial ? g_row(q) : a_row(q);
      wr[r] = w[q];
      acc[r] = 0.f;
    }
    // partly on chip: the loads of two columns in flight, not four (the
    // registers of the shared-memory offsets)
#pragma unroll (kMode == kPartial ? 2 : 4)
    for (int j = threadIdx.x; j < len; j += kThreads) {
      float av[kRows];
      float g_cut = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if constexpr (kMode == kPartial) {
          const int q = min(r, p - 1);
          av[r] = ld_either(a_sh + s_off(q) * sizeof(TA), row[r], j,
                            q < held);
        } else {
          av[r] = a_at(row[r], r, j);
        }
        if (r < p) g_cut += wr[r] * av[r];
      }
      const float x = v_new_at(j, g_cut);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < p) acc[r] += av[r] * x;
      }
    }
    store_rows(acc, 0, p, part1);
  } else {
    for (int j = threadIdx.x; j < len; j += kThreads) {
      float g_cut = 0.f;
#pragma unroll 8
      for (int r = 0; r < p; ++r) {
        g_cut += w[r] * a_at(a_row(r), r, j);
      }
      const float x = v_new_at(j, g_cut);
      if constexpr (kVecs) vn_s[j] = x;
    }
    __syncthreads();
    // v_new read back from shared memory, or from device memory (written
    // by this block: never through the read-only path `ld` takes)
    mat_vec([&](int j) {
              if constexpr (kVecs) {
                return vn_s[j];
              } else {
                return __ldcg(g.v_new + c0 + j);
              }
            },
            part1, false);
  }

  // epilogue: the last block of phase 1 sums the partials of A v_new
  __syncthreads();
  if (threadIdx.x == 0) {
    last = ticket_add(g.counter) == 2 * n_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int p0 = 0; p0 < p; p0 += kRows) {
    const int nr = min(kRows, p - p0);
    const float mv = partial_totals(part1, p0, nr, n_blocks, red);
    if (threadIdx.x < nr) {
      const int r = p0 + threadIdx.x;
      const float act = g.active[r];
      const float sr = g.s[r];
      const float gr = g.gamma[r];
      const float cv = (mv - g.c[r]) * act;
      const float g_s = (gr + g.k.rho2 * (cv + sr)) * act;
      const float sn = relu_nan(sr - g.k.eta_s * g_s) * act;
      g.cv1[r] = cv;
      g.s_new[r] = sn;
      g.gamma_new[r] = relu_nan(gr + g.k.eta_dual * (cv + sn)) * act;
    }
  }
  if (threadIdx.x == 0) *g.counter = 0;
}

template <typename TA, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
fused_round(const RoundArgs g) {
  round_body<TA, kMode>(g);
}

// Run strides (in elements) of a batched call's operands, 0 for an
// operand the runs share.
struct RunStrides {
  long long a, v, g_other, mask, c, active, s, gamma;
};

// gridDim.y runs in one launch: run y reads its operands at their run
// strides and owns counter y, its (2, P, blocks) scratch and row y of
// each (runs, D) / (runs, P) output.  Its blocks meet at their own grid
// barrier (the counter counts gridDim.x arrivals), so each run is the
// single-run kernel on its own pointers, bit for bit, at this launch's
// partition of D.
template <typename TA, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
fused_round_runs(const RoundArgs g, const RunStrides rs) {
  const long long y = blockIdx.y;
  const long long p = g.p;
  RoundArgs r = g;
  r.a = static_cast<const TA*>(g.a) + y * rs.a;
  r.v = g.v + y * rs.v;
  r.g_other = g.g_other + y * rs.g_other;
  r.mask = g.mask + y * rs.mask;
  r.c = g.c + y * rs.c;
  r.active = g.active + y * rs.active;
  r.s = g.s + y * rs.s;
  r.gamma = g.gamma + y * rs.gamma;
  r.partial = g.partial + y * 2 * p * gridDim.x;
  r.counter = g.counter + y;
  r.v_new = g.v_new + y * g.d;
  r.cv1 = g.cv1 + y * p;
  r.s_new = g.s_new + y * p;
  r.gamma_new = g.gamma_new + y * p;
  round_body<TA, kMode>(r);
}

template <bool kRuns, typename TA, int kMode>
const void* kernel_of() {
  if constexpr (kRuns) {
    return reinterpret_cast<const void*>(&fused_round_runs<TA, kMode>);
  } else {
    return reinterpret_cast<const void*>(&fused_round<TA, kMode>);
  }
}

template <bool kRuns, typename TA>
const void* kernel_by_mode(int mode) {
  return mode == kOnChip    ? kernel_of<kRuns, TA, kOnChip>()
         : mode == kPartial ? kernel_of<kRuns, TA, kPartial>()
                            : kernel_of<kRuns, TA, kStreamed>();
}

// The kernel of A's type and mode.
template <bool kRuns>
const void* round_kernel(int a_bf16, int mode) {
  return a_bf16 ? kernel_by_mode<kRuns, __nv_bfloat16>(mode)
                : kernel_by_mode<kRuns, float>(mode);
}

bool set_smem(const void* fn, long long smem) {
  return smem >= 0 && smem <= INT32_MAX
         && cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem)) == cudaSuccess;
}

// Blocks of `fn` that one SM of the current device holds with `smem`
// bytes of dynamic shared memory; 0 where it cannot run with that much.
int occupancy_of(const void* fn, long long smem) {
  int n = 0;
  if (!set_smem(fn, smem)
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, fn, kThreads, static_cast<size_t>(smem)) != cudaSuccess) {
    cudaGetLastError();   // the query's error is its answer, not a fault
    return 0;
  }
  return n;
}

bool valid_round(int p, long long d, int blocks, long long cw, int a_bf16,
                 int mode, int rows, long long smem) {
  return p >= 1 && p <= kMaxRows && d >= 1 && blocks >= 1 && cw >= 8
         && cw % 8 == 0 && static_cast<long long>(blocks - 1) * cw < d
         && static_cast<long long>(blocks) * cw >= d && smem <= INT32_MAX
         && mode >= kStreamed && mode <= kPartial
         && (mode != kPartial || (rows >= 1 && rows <= p))
         && smem >= layout_of(p, cw, a_bf16 ? 2 : 4, mode, rows).total;
}

// One cooperative launch of `fn` with `params`; the launch's error.
int launch_round(const void* fn, void** params, dim3 grid, long long smem,
                 void* stream) {
  cudaError_t err = set_smem(fn, smem) ? cudaSuccess : cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    err = cudaLaunchCooperativeKernel(fn, grid, dim3(kThreads), params,
                                      static_cast<size_t>(smem),
                                      static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch one call needs: two (P, blocks) partial buffers.
long long fused_cut_round_scratch(int p, int blocks) {
  return 2LL * p * blocks;
}

// Blocks of the kernel (A's type, mode; the batched kernel when `runs`)
// that one SM of the current device holds with `smem` bytes of dynamic
// shared memory; 0 where the kernel cannot run with that much.
int fused_cut_round_occupancy(int a_bf16, int mode, long long smem,
                              int runs) {
  return occupancy_of(runs ? round_kernel<true>(a_bf16, mode)
                           : round_kernel<false>(a_bf16, mode),
                      smem);
}

// `counter`: an int that is 0 between calls, one per stream; `scratch`:
// fused_cut_round_scratch(p, blocks) floats; blocks of cw columns cover
// [0, d), cw a multiple of 8; `mode` and `rows` where A and the vectors
// live; `smem` at least the layout's.
int fused_cut_round(const void* a, int a_bf16, const float* v,
                    const float* g_other, const float* mask, const float* c,
                    const float* active, const float* s, const float* gamma,
                    float* scratch, int* counter, float* v_new, float* cv1,
                    float* s_new, float* gamma_new, int p, long long d,
                    int blocks, long long cw, int mode, int rows,
                    long long smem, float eta_z, float eta_s,
                    float eta_dual, float rho2, void* stream) {
  if (!valid_round(p, d, blocks, cw, a_bf16, mode, rows, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs args{a, v, g_other, mask, c, active, s, gamma, scratch,
                 counter, v_new, cv1, s_new, gamma_new, p, d, cw,
                 Steps{eta_z, eta_s, eta_dual, rho2}, rows};
  void* params[] = {&args};
  return launch_round(round_kernel<false>(a_bf16, mode), params,
                      dim3(blocks), smem, stream);
}

// `runs` rounds in one cooperative launch, blocks x runs blocks in all
// (the caller checks they fit resident: the launch refuses a grid that
// does not).  Operands at their run strides (`strides`: a, v, g_other, mask, c,
// active, s, gamma, in elements); `counters`: runs ints, 0 between calls;
// `scratch`: runs x fused_cut_round_scratch(p, blocks) floats; outputs
// (runs, d) and (runs, p), contiguous.
int fused_cut_round_runs(const void* a, int a_bf16, const float* v,
                         const float* g_other, const float* mask,
                         const float* c, const float* active, const float* s,
                         const float* gamma, const long long* strides,
                         float* scratch, int* counters, float* v_new,
                         float* cv1, float* s_new, float* gamma_new,
                         int runs, int p, long long d, int blocks,
                         long long cw, int mode, int rows,
                         long long smem, float eta_z, float eta_s,
                         float eta_dual, float rho2, void* stream) {
  if (!valid_round(p, d, blocks, cw, a_bf16, mode, rows, smem)
      || runs < 1 || runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs args{a, v, g_other, mask, c, active, s, gamma, scratch,
                 counters, v_new, cv1, s_new, gamma_new, p, d, cw,
                 Steps{eta_z, eta_s, eta_dual, rho2}, rows};
  RunStrides rs{strides[0], strides[1], strides[2], strides[3], strides[4],
                strides[5], strides[6], strides[7]};
  void* params[] = {&args, &rs};
  return launch_round(round_kernel<true>(a_bf16, mode), params,
                      dim3(blocks, runs), smem, stream);
}

}  // extern "C"
