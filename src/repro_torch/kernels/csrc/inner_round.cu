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
// wrapper plans the partition for R runs at once (round_plan's `runs`),
// holding A's slices on chip only where all R runs' blocks fit resident
// with their shared memory, and streaming otherwise.
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
// mbarriers over A's rows in the on-chip branch
constexpr int kMaxPieces = 32;

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
};

__host__ __device__ constexpr long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory, byte offsets (inner_round.round_smem mirrors
// it): the mbarriers (v; g_other and mask; A's pieces), the weights w,
// then, on chip, four vector slices (v, g_other, mask, v_new) of cw + 4
// floats and A's slice, each row in cw + V entries.  Every region starts
// 16-byte aligned.  Streaming uses w alone.
struct Layout {
  int rows_per_piece, n_pieces;
  long long w, vec, a, total;
};

__host__ __device__ inline Layout layout_of(int p, long long cw, int es,
                                            bool on_chip) {
  Layout l;
  l.rows_per_piece = (p + kMaxPieces - 1) / kMaxPieces;
  l.n_pieces = (p + l.rows_per_piece - 1) / l.rows_per_piece;
  l.w = on_chip ? round16(8LL * (2 + l.n_pieces)) : 0;
  l.vec = l.w + round16(4LL * p);
  l.a = l.vec + 16 * (cw + 4);
  l.total = on_chip ? l.a + p * (cw * es + 16) : l.vec;
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

// A slice src[0 : len] of T, V = 16 / sizeof(T) entries to 16 bytes: it
// starts `mis` entries past a 16-byte boundary, then has a head of h < V
// entries, a 16-byte-aligned body of nb and a tail of fewer than V.
struct Span {
  int mis, h, nb;
};

template <typename T>
__device__ __forceinline__ Span span_of(const T* src, int len) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(
      reinterpret_cast<uintptr_t>(src) % 16 / sizeof(T));
  const int h = min(len, (V - mis) % V);
  return {mis, h, (len - h) / V * V};
}

template <typename T>
__device__ __forceinline__ uint32_t body_bytes(const T* src, int len) {
  return static_cast<uint32_t>(span_of(src, len).nb * sizeof(T));
}

// The body of src[0 : len] to dst + mis + h (dst 16-byte aligned, so the
// body lands 16-byte aligned) in one bulk copy completing on `bar`.
template <typename T>
__device__ __forceinline__ void bulk_body(T* dst, const T* src, int len,
                                          uint32_t bar) {
  const Span sp = span_of(src, len);
  if (sp.nb > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst + sp.mis + sp.h)), "l"(src + sp.h),
           "r"(static_cast<uint32_t>(sp.nb * sizeof(T))), "r"(bar)
        : "memory");
  }
}

// Entry e < 2V of the head (e < V) or the tail (e >= V) of src[0 : len]
// to dst + mis, where the slice has one.
template <typename T>
__device__ __forceinline__ void copy_end(T* dst, const T* src, int len,
                                         int e) {
  constexpr int V = 16 / sizeof(T);
  const Span sp = span_of(src, len);
  const int j = e < V ? e : sp.h + sp.nb + (e - V);
  if (e < V ? e < sp.h : j < len) dst[sp.mis + j] = src[j];
}

// Spin until the counter reaches `target` (acquire); trap after
// kHangCycles rather than hang.
__device__ __forceinline__ void wait_count(const int* counter, int target) {
  const long long start = clock64();
  int x;
  do {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(x) : "l"(counter) : "memory");
    if (clock64() - start > kHangCycles) __trap();
  } while (x < target);
}

template <typename TA, bool kOnChip>
__device__ __forceinline__ void round_body(const RoundArgs& g) {
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
  const Layout lay = layout_of(p, g.cw, sizeof(TA), kOnChip);
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
  auto bar = [&](int i) { return smem_u32(bars + i); };
  auto a_row = [&](int r) -> const TA* {
    if constexpr (kOnChip) {
      return a_reg + r * rs + ((m0 + r * dm) & (V - 1));
    } else {
      return a + static_cast<long long>(r) * d;
    }
  };
  auto a_at = [&](const TA* row, int j) -> float {
    if constexpr (kOnChip) {
      return to_f(row[j]);
    } else {
      return ld(row, j);
    }
  };
  auto vec_at = [&](int q, int j) -> float {
    if constexpr (kOnChip) {
      return vec[q][j];
    } else {
      return ld(vec[q], j);
    }
  };

  // phase 0: the slices on their way into shared memory
  if constexpr (kOnChip) {
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
  // sweep; in phase 0 on chip each sweep first waits for its rows to land
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
      const TA* row[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        row[r] = a_row(p0 + min(r, nr - 1));
        if constexpr (kOnChip) {
          if (landing && r < nr) {
            mbar_wait(bar(2 + (p0 + r) / lay.rows_per_piece), 0);
          }
        }
      }
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = threadIdx.x; j < len; j += kThreads) {
        const float xj = x(j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) acc[r] += a_at(row[r], j) * xj;
        }
      }
      store_rows(acc, p0, nr, part);
    }
  };
  mat_vec([&](int j) { return vec_at(0, j); }, part0, true);
  // g_other and mask, needed after the barrier, start once A has landed,
  // so they do not share the bandwidth A's copies need
  if constexpr (kOnChip) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar(1), body_bytes(src[1], len)
                                 + body_bytes(src[2], len));
      bulk_body(regions + vs, src[1], len, bar(1));
      bulk_body(regions + 2 * vs, src[2], len, bar(1));
    }
  }

  // the grid-wide barrier: every block's partials of A v are stored
  __syncthreads();
  if (threadIdx.x == 0) {
    ticket_add(g.counter);
    wait_count(g.counter, n_blocks);
  }
  __syncthreads();

  // phase 1: w from the partials, the same bits in every block
  for (int p0 = 0; p0 < p; p0 += kRows) {
    const int nr = min(kRows, p - p0);
    const float mv = partial_totals(part0, p0, nr, n_blocks, red);
    if (threadIdx.x < nr) {
      const int r = p0 + threadIdx.x;
      const float act = g.active[r];
      const float cv0 = (mv - g.c[r]) * act;
      const float viol = (cv0 + g.s[r]) * act;
      w[r] = (g.gamma[r] + g.k.rho2 * viol) * act;
    }
  }
  __syncthreads();
  if constexpr (kOnChip) mbar_wait(bar(1), 0);
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
      row[r] = a_row(min(r, p - 1));
      wr[r] = w[min(r, p - 1)];
      acc[r] = 0.f;
    }
#pragma unroll 4
    for (int j = threadIdx.x; j < len; j += kThreads) {
      float av[kRows];
      float g_cut = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        av[r] = a_at(row[r], j);
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
      for (int r = 0; r < p; ++r) g_cut += w[r] * a_at(a_row(r), j);
      const float x = v_new_at(j, g_cut);
      if constexpr (kOnChip) vn_s[j] = x;
    }
    __syncthreads();
    // v_new read back from shared memory, or from device memory (written
    // by this block: never through the read-only path `ld` takes)
    mat_vec([&](int j) {
              if constexpr (kOnChip) {
                return vn_s[j];
              } else {
                return __ldcg(g.v_new + c0 + j);
              }
            },
            part1, false);
  }

  // epilogue: the last block of phase 1 sums the partials of A v_new
  __syncthreads();
  if (threadIdx.x == 0) last = ticket_add(g.counter) == 2 * n_blocks - 1;
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

template <typename TA, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
fused_round(const RoundArgs g) {
  round_body<TA, kOnChip>(g);
}

// Run strides (in elements) of a batched call's operands, 0 for an
// operand the runs share.
struct RunStrides {
  long long a, v, g_other, mask, c, active, s, gamma;
};

// gridDim.y runs in one cooperative launch: run y reads its operands at
// their run strides and owns counter y, its (2, P, blocks) scratch and
// row y of each (runs, D) / (runs, P) output.  Its blocks meet at their
// own grid barrier (the counter counts gridDim.x arrivals), so each run
// is the single-run kernel on its own pointers, bit for bit, at this
// launch's partition of D.
template <typename TA, bool kOnChip>
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
  round_body<TA, kOnChip>(r);
}

template <bool kRuns, typename TA, bool kOnChip>
const void* kernel_of() {
  if constexpr (kRuns) {
    return reinterpret_cast<const void*>(&fused_round_runs<TA, kOnChip>);
  } else {
    return reinterpret_cast<const void*>(&fused_round<TA, kOnChip>);
  }
}

template <bool kRuns>
const void* round_kernel(int a_bf16, int on_chip) {
  if (a_bf16) {
    return on_chip ? kernel_of<kRuns, __nv_bfloat16, true>()
                   : kernel_of<kRuns, __nv_bfloat16, false>();
  }
  return on_chip ? kernel_of<kRuns, float, true>()
                 : kernel_of<kRuns, float, false>();
}

// Blocks of `fn` that one SM of the current device holds with `smem`
// bytes of dynamic shared memory; 0 where it cannot run with that much.
int occupancy_of(const void* fn, long long smem) {
  int n = 0;
  if (smem < 0 || smem > INT32_MAX
      || cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem)) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, fn, kThreads, static_cast<size_t>(smem)) != cudaSuccess) {
    cudaGetLastError();   // the query's error is its answer, not a fault
    return 0;
  }
  return n;
}

bool valid_round(int p, long long d, int blocks, long long cw, int a_bf16,
                 int on_chip, long long smem) {
  return p >= 1 && p <= kMaxRows && d >= 1 && blocks >= 1 && cw >= 8
         && cw % 8 == 0 && static_cast<long long>(blocks - 1) * cw < d
         && static_cast<long long>(blocks) * cw >= d && smem <= INT32_MAX
         && smem >= layout_of(p, cw, a_bf16 ? 2 : 4, on_chip).total;
}

// One cooperative launch of `fn` with `params`; the launch's error.
int launch_round(const void* fn, void** params, dim3 grid, long long smem,
                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
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

// Blocks of the kernel (A's type, branch; the batched kernel when `runs`)
// that one SM of the current device holds with `smem` bytes of dynamic
// shared memory; 0 where the kernel cannot run with that much.
int fused_cut_round_occupancy(int a_bf16, int on_chip, long long smem,
                              int runs) {
  return occupancy_of(runs ? round_kernel<true>(a_bf16, on_chip)
                           : round_kernel<false>(a_bf16, on_chip),
                      smem);
}

// `counter`: an int that is 0 between calls, one per stream; `scratch`:
// fused_cut_round_scratch(p, blocks) floats; blocks of cw columns cover
// [0, d), cw a multiple of 8; `smem` at least the branch's layout.
int fused_cut_round(const void* a, int a_bf16, const float* v,
                    const float* g_other, const float* mask, const float* c,
                    const float* active, const float* s, const float* gamma,
                    float* scratch, int* counter, float* v_new, float* cv1,
                    float* s_new, float* gamma_new, int p, long long d,
                    int blocks, long long cw, int on_chip, long long smem,
                    float eta_z, float eta_s, float eta_dual, float rho2,
                    void* stream) {
  if (!valid_round(p, d, blocks, cw, a_bf16, on_chip, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs args{a, v, g_other, mask, c, active, s, gamma, scratch,
                 counter, v_new, cv1, s_new, gamma_new, p, d, cw,
                 Steps{eta_z, eta_s, eta_dual, rho2}};
  void* params[] = {&args};
  return launch_round(round_kernel<false>(a_bf16, on_chip), params,
                      dim3(blocks), smem, stream);
}

// `runs` rounds in one cooperative launch, blocks x runs blocks in all
// (the caller checks they fit resident: the launch refuses a grid that
// does not).  Operands at their run strides (`strides`: a, v, g_other,
// mask, c, active, s, gamma, in elements); `counters`: runs ints, 0
// between calls; `scratch`: runs x fused_cut_round_scratch(p, blocks)
// floats; outputs (runs, d) and (runs, p), contiguous.
int fused_cut_round_runs(const void* a, int a_bf16, const float* v,
                         const float* g_other, const float* mask,
                         const float* c, const float* active, const float* s,
                         const float* gamma, const long long* strides,
                         float* scratch, int* counters, float* v_new,
                         float* cv1, float* s_new, float* gamma_new,
                         int runs, int p, long long d, int blocks,
                         long long cw, int on_chip, long long smem,
                         float eta_z, float eta_s, float eta_dual, float rho2,
                         void* stream) {
  if (!valid_round(p, d, blocks, cw, a_bf16, on_chip, smem) || runs < 1
      || runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs args{a, v, g_other, mask, c, active, s, gamma, scratch,
                 counters, v_new, cv1, s_new, gamma_new, p, d, cw,
                 Steps{eta_z, eta_s, eta_dual, rho2}};
  RunStrides rs{strides[0], strides[1], strides[2], strides[3], strides[4],
                strides[5], strides[6], strides[7]};
  void* params[] = {&args, &rs};
  return launch_round(round_kernel<true>(a_bf16, on_chip), params,
                      dim3(blocks, runs), smem, stream);
}

}  // extern "C"
