// Hand-written Hopper kernels for the hyper-polyhedral cut contraction.
//
// They replace the three Pallas TPU kernels of the JAX package
// (src/repro/kernels/cut_eval.py):
//
//   cut_matvec  (P,)   = A @ v     replaces _matvec_kernel (cut_eval.py:60)
//   cut_vecmat  (D,)   = g^T A     replaces _vecmat_kernel (cut_eval.py:96)
//   cut_rank1   (P, D) = x y^T     replaces _rank1_kernel  (cut_eval.py:129)
//
// All three are bound by device-memory bytes: P is tiny (8 cuts on the
// paper's runs) and D wide (242,628 columns at the white-wine width), so
// each element of A is used for 2 flops.  The designs therefore read A
// once, coalesced along D, and accumulate in f32 whatever the input type.
//
// matvec: the TPU kernel carries its sum across a sequential grid axis,
// which Hopper's concurrently scheduled blocks cannot do.  One launch of
// at most two blocks per SM instead: block b owns a contiguous range of
// D, stages its slice of v in shared memory as f32, and keeps up to 8 row
// sums in registers while it reads A in 16-byte loads (4 f32 or 8 bf16
// values).  Rows of A are not 16-byte aligned in general (at D = 925,590
// row r starts r x 3,702,360 bytes in), so each row has a scalar head and
// tail around its vector body, and v is read from shared memory at any
// offset.  The block reduces its sums with warp shuffles and a
// fixed-order pass over the warps into a (P, blocks) f32 partial; the
// block that finishes last (a ticket counter: partials stored, then one
// acq_rel atomic add) sums every row's partials in index order and
// resets the counter.  The counter decides only which block adds, never
// the order of the sum: results are bitwise identical run to run, which
// replay and resume contracts rely on.  The caller keeps one zeroed
// counter per stream, so calls on one stream never overlap on it.
//
// vecmat (replaces _vecmat_kernel, cut_eval.py:96): bytes bound it on
// this card as they bound matvec: A once, g, and the (D,) output.  On the
// same grid as matvec (at most two blocks per SM, sized once per shape in
// cut_eval.py), each thread owns 16 bytes of columns (4 f32 or 8 bf16)
// and keeps one f32 sum per column in registers.  It issues the 16-byte
// loads of 8 rows (or, at P <= 2, of 2 rows in 4 column groups) before
// their FMAs, so 128 bytes a thread are in flight, with the rows' entries
// of g, through the read-only path without allocating in L1, and writes
// the output in 16-byte stores.  A row that is not
// 16-byte aligned is read in the widest loads its alignment allows (8, 4
// or 2 bytes; the same 16 bytes), and the slice's ragged last columns
// one per thread.  Each column sums its rows in order r = 0 .. P-1 in
// one thread: no atomics, bitwise repeatable.
//
// Batched forms (the sweep engine's run axis; src/repro/kernels/cut_ad.py
// batches the Pallas kernels by vmapping them, which adds a grid axis):
// cut_matvec_runs, cut_vecmat_runs and cut_rank1_runs take R problems in
// one launch, the run index a grid dimension.  Each operand carries a run
// stride, 0 for an operand the runs share, so a shared operand is never
// copied.  Each run takes the single-run grid and the single-run kernel
// body on its own pointers (matvec with its own ticket and partials), so
// row r of a batched call is bitwise the single-run kernel on run r.
// The batched launch is bound by R times the single run's bytes, which
// its blocks move in waves; each block's serial steps (staging v, the
// reduction, the ticket) leave the memory idle between waves.  matvec's
// batched body therefore fetches v's slices ahead of A's loads (a block
// that staged v after issuing A's loads, as the single-run kernel does,
// waited for v's bytes after A's) and fits four blocks an SM where A is
// f32, its two 4-row sweeps sharing one staged slice of v and one
// reduction.  A persistent launch of the resident blocks walking (run,
// chunk) items, fed by bulk copies or cp.async into a ring of
// shared-memory stages, pays each item's serial steps one after another
// and measured slower than this grid on the H100
// (benchmarks/torch_cut_runs_designs.py, benchmarks/
// cut_matvec_runs_ring.cu).
//
// Each launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.  Kernels allocate nothing; the caller passes outputs
// and scratch.  Built for sm_90a with the other sources of this
// directory into one library by repro_torch/kernels/build.py.

#include <cstdint>

#include "cut_common.cuh"

namespace {

constexpr int kMvCols = 4096;    // columns of v in shared memory at a time

// v's slice in shared memory holds column j at pad(j): one float of
// padding after every 32, so the lanes of a warp that read 4 (f32 A) or
// 8 (bf16 A) consecutive columns each hit 32 different banks.
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

// x . vs[j0 : j0 + 16 / sizeof(T)] for 16 bytes x of f32 or bf16 values.
__device__ __forceinline__ float dot16(uint4 x, const float* vs, int j0,
                                       const float*) {
  return __uint_as_float(x.x) * vs[pad(j0)]
         + __uint_as_float(x.y) * vs[pad(j0 + 1)]
         + __uint_as_float(x.z) * vs[pad(j0 + 2)]
         + __uint_as_float(x.w) * vs[pad(j0 + 3)];
}

__device__ __forceinline__ float dot16(uint4 x, const float* vs, int j0,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x * vs[pad(j0 + 2 * i)] + f.y * vs[pad(j0 + 2 * i + 1)];
  }
  return s;
}

// vs[pad(j)] = v[j] as f32 for j < len: in 16-byte loads where v is
// 16-byte aligned (a block's slice starts at a multiple of 8 columns),
// scalar loads for the rest.
template <typename TV>
__device__ __forceinline__ void stage_v(const TV* __restrict__ v, int len,
                                        float* vs) {
  constexpr int W = 16 / sizeof(TV);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(v) % 16 == 0) {
    const int n_vec = len / W;
#pragma unroll 4
    for (int j = threadIdx.x; j < n_vec; j += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(v) + j);
      if constexpr (W == 4) {
        vs[pad(4 * j)] = __uint_as_float(raw.x);
        vs[pad(4 * j + 1)] = __uint_as_float(raw.y);
        vs[pad(4 * j + 2)] = __uint_as_float(raw.z);
        vs[pad(4 * j + 3)] = __uint_as_float(raw.w);
      } else {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          vs[pad(8 * j + 2 * i)] = f.x;
          vs[pad(8 * j + 2 * i + 1)] = f.y;
        }
      }
    }
    done = n_vec * W;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    vs[pad(j)] = ld(v, j);
  }
}

// 4 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// vs[pad(j)] = v[j] for j < len, the values stage_v stores, in 4-byte
// asynchronous copies (f32 v only: a copy moves 4 bytes at least), issued
// ahead of A's loads so that they land first; cp_async_wait_all waits for
// them.
template <typename TV>
__device__ __forceinline__ void fetch_v(const TV* v, int len, float* vs) {
  if constexpr (sizeof(TV) == 4) {
    for (int j = threadIdx.x; j < len; j += kThreads) {
      cp_async4(vs + pad(j), v + j);
    }
  }
}

// The U x R 16-byte loads of A that thread-strided vector k0 starts:
// x[u][r] is vector k0 + u kThreads of row r's body, where it has one.
template <int R, int U, typename TA>
__device__ __forceinline__ void mv_load(uint4 (&x)[U][R],
                                        const TA* const (&row)[R],
                                        const int (&body)[R],
                                        const int (&nv)[R], int k0) {
  constexpr int V = 16 / sizeof(TA);
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + u * kThreads;
      if (k < nv[r]) {
        x[u][r] = __ldg(reinterpret_cast<const uint4*>(row[r] + body[r]
                                                       + k * V));
      }
    }
  }
}

// acc[r] += A[p0 + r, s0 : s0 + len] . v[s0 : s0 + len] for the nr <= R
// rows of this sweep.  v's slice is staged in shared memory (vs) after
// the first loads of A are issued, so the two reads overlap.  Each row's
// 16-byte-aligned body is read in 16-byte loads, U of each row in flight
// per thread, and its head and tail (under 16 bytes each) in scalar
// loads issued with the first vectors.  With kStage false the slice of v
// is in vs already (an earlier sweep of the same columns staged it).
template <int R, int U, bool kVFirst, typename TA, typename TV,
          bool kStage = true>
__device__ __forceinline__ void mv_sweep(const TA* __restrict__ a,
                                         const TV* __restrict__ v,
                                         float* vs, int p0, int nr,
                                         long long d, long long s0, int len,
                                         float* acc) {
  constexpr int V = 16 / sizeof(TA);
  const TA* row[R];
  int h[R], nv[R];
  int n_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = a + static_cast<long long>(p0 + min(r, nr - 1)) * d + s0;
    const int mis = static_cast<int>(
        reinterpret_cast<uintptr_t>(row[r]) % 16 / sizeof(TA));
    h[r] = min(len, (V - mis) % V);
    nv[r] = r < nr ? (len - h[r]) / V : 0;
    n_max = max(n_max, nv[r]);
  }
  // (bf16 v is staged after A's loads go out, as in the single-run body)
  constexpr bool kAsyncV = kStage && kVFirst && sizeof(TV) == 4;
  if constexpr (kAsyncV) {
    __syncthreads();   // the previous slice's reads of vs are done
    fetch_v(v + s0, len, vs);
  }
  // this thread's head and tail entries of each row (under 16 bytes of a
  // row each side of its body), loaded with the first vectors
  const int t = threadIdx.x;
  float head[R], tail[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t0 = h[r] + nv[r] * V;
    head[r] = r < nr && t < h[r] ? ld(row[r], t) : 0.f;
    tail[r] = r < nr && t < len - t0 ? ld(row[r], t0 + t) : 0.f;
  }
  uint4 x[U][R];
  int k0 = t;
  mv_load<R, U>(x, row, h, nv, k0);
  if constexpr (kAsyncV) {
    cp_async_wait_all();
    __syncthreads();
  } else if constexpr (kStage) {
    __syncthreads();   // the previous slice's reads of vs are done
    stage_v(v + s0, len, vs);
    __syncthreads();
  }
#pragma unroll 1
  while (k0 < n_max) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + u * kThreads;
        if (k < nv[r]) {
          acc[r] += dot16(x[u][r], vs, h[r] + k * V,
                          static_cast<const TA*>(nullptr));
        }
      }
    }
    k0 += kThreads * U;
    mv_load<R, U>(x, row, h, nv, k0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t0 = h[r] + nv[r] * V;
    if (t < h[r]) acc[r] += head[r] * vs[pad(t)];
    if (t < len - t0) acc[r] += tail[r] * vs[pad(t0 + t)];
  }
}

// (P,) = A @ v in one launch; block b owns columns [b cw, (b + 1) cw) and
// sweeps the rows R at a time.  Two blocks fit each SM.  The caller sizes
// the grid (cut_eval.py cut_grid): at most two blocks per SM, each
// wide enough that, in the 8-row kernel, every thread has a 16-byte load
// of each row.
template <int R, int U, bool kVFirst, typename TA, typename TV>
__device__ __forceinline__ void matvec_body(
    const TA* __restrict__ a, const TV* __restrict__ v,
    float* __restrict__ partial, int* __restrict__ ticket,
    float* __restrict__ out, int p, long long d, long long cw) {
  __shared__ float vs[kMvCols + kMvCols / 32];
  __shared__ float red[kWarps][kRows];
  __shared__ int last;
  const int n_blocks = gridDim.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * cw;
  const long long c1 = min(c0 + cw, d);
  bool swept = false;
  if constexpr (kVFirst && 2 * R == kRows) {
    // f32 A, up to 8 rows over one slice of v: the two 4-row sweeps share
    // the slice staged once and one reduction (each row's sum is its own,
    // so neither changes a bit)
    if (p <= kRows && c1 - c0 <= kMvCols) {
      const int len = static_cast<int>(c1 - c0);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      mv_sweep<R, U, true>(a, v, vs, 0, min(R, p), d, c0, len, acc);
      if (p > R) {
        mv_sweep<R, U, true, TA, TV, false>(a, v, vs, R, p - R, d, c0, len,
                                            acc + R);
      }
      const float s = rows_sum(acc, p, red);
      if (threadIdx.x < p) {
        partial[static_cast<long long>(threadIdx.x) * n_blocks
                + blockIdx.x] = s;
      }
      swept = true;
    }
  }
  for (int p0 = 0; p0 < p && !swept; p0 += R) {
    const int nr = min(R, p - p0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (long long s0 = c0; s0 < c1; s0 += kMvCols) {
      const int len = static_cast<int>(min(static_cast<long long>(kMvCols),
                                           c1 - s0));
      mv_sweep<R, U, kVFirst>(a, v, vs, p0, nr, d, s0, len, acc);
    }
    const float s = rows_sum(acc, nr, red);
    if (threadIdx.x < nr) {
      partial[static_cast<long long>(p0 + threadIdx.x) * n_blocks
              + blockIdx.x] = s;
    }
  }
  // the last block to finish sums the partials, each row in index order
  __syncthreads();
  if (threadIdx.x == 0) last = ticket_add(ticket) == n_blocks - 1;
  __syncthreads();
  if (!last) return;
  for (int p0 = 0; p0 < p; p0 += kRows) {
    const int nr = min(kRows, p - p0);
    const float s = partial_totals(partial, p0, nr, n_blocks, red);
    if (threadIdx.x < nr) out[p0 + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int R, int U, typename TA, typename TV>
__global__ void __launch_bounds__(kThreads, 2)
matvec_kernel(const TA* __restrict__ a, const TV* __restrict__ v,
              float* __restrict__ partial, int* __restrict__ ticket,
              float* __restrict__ out, int p, long long d, long long cw) {
  matvec_body<R, U, false>(a, v, partial, ticket, out, p, d, cw);
}

// The same for gridDim.y runs: run y reads A and v at its run strides
// (0 for an operand the runs share) and owns row y of the (runs, P,
// blocks) partials, ticket y and row y of the (runs, P) output, so each
// run is the single-run kernel on its own operands, bit for bit.  Each
// sweep copies its slice of v (f32) into shared memory asynchronously
// before it issues its loads of A, so v's bytes travel with A's instead
// of after them, and (f32 A) four blocks share an SM, so that one
// block's loads are in flight while another reduces and takes its
// ticket; to fit four, f32 A sweeps 4 rows at a time above P = 2, two
// sweeps of one slice of v sharing its staging and the reduction (each
// row's sum is its own, so the sweeps' width changes no bit).  bf16 A
// keeps 8 rows a sweep and two blocks an SM (at more its rows'
// registers spill).
template <int R, int U, typename TA, typename TV>
__global__ void __launch_bounds__(kThreads, sizeof(TA) == 4 ? 4 : 2)
matvec_runs_kernel(const TA* __restrict__ a, long long a_rs,
                   const TV* __restrict__ v, long long v_rs,
                   float* __restrict__ partial, int* __restrict__ tickets,
                   float* __restrict__ out, int p, long long d,
                   long long cw) {
  const long long y = blockIdx.y;
  matvec_body<R, U, true>(a + y * a_rs, v + y * v_rs,
                          partial + y * p * gridDim.x, tickets + y,
                          out + y * p, p, d, cw);
}

// Loads of A that vecmat reads once: through the read-only path without
// allocating in L1 (measured faster than __ldg on the H100).
__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 x;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "l"(p));
  return x;
}

__device__ __forceinline__ uint2 ld_once(const uint2* p) {
  uint2 x;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(x.x), "=r"(x.y) : "l"(p));
  return x;
}

__device__ __forceinline__ unsigned ld_once(const unsigned* p) {
  unsigned x;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n"
               : "=r"(x) : "l"(p));
  return x;
}

__device__ __forceinline__ unsigned ld_once(const unsigned short* p) {
  unsigned short x;
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n"
               : "=h"(x) : "l"(p));
  return x;
}

// 16 bytes of A at `p`, which lies `mis` bytes past a 16-byte boundary,
// in the widest loads that alignment allows: one 16-byte load where the
// row is aligned.  `mis` depends on the row only, so every branch is
// uniform over the block.
__device__ __forceinline__ uint4 ld16(const void* p, int mis) {
  if (mis == 0) return ld_once(static_cast<const uint4*>(p));
  if (mis % 8 == 0) {
    const uint2* q = static_cast<const uint2*>(p);
    const uint2 lo = ld_once(q);
    const uint2 hi = ld_once(q + 1);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  if (mis % 4 == 0) {
    const unsigned* q = static_cast<const unsigned*>(p);
    return make_uint4(ld_once(q), ld_once(q + 1), ld_once(q + 2),
                      ld_once(q + 3));
  }
  const unsigned short* q = static_cast<const unsigned short*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = ld_once(q + 2 * i) | ld_once(q + 2 * i + 1) << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc[e] += g x[e] for 16 bytes x of f32 or bf16 values.
__device__ __forceinline__ void axpy16(float* acc, float g, uint4 x,
                                       const float*) {
  acc[0] += g * __uint_as_float(x.x);
  acc[1] += g * __uint_as_float(x.y);
  acc[2] += g * __uint_as_float(x.z);
  acc[3] += g * __uint_as_float(x.w);
}

__device__ __forceinline__ void axpy16(float* acc, float g, uint4 x,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += g * f.x;
    acc[2 * i + 1] += g * f.y;
  }
}

// (D,) = g^T A in one launch; block b owns columns [b cw, (b + 1) cw).
// Each thread owns 16 bytes of A's columns (V = 4 f32 or 8 bf16), U of
// them at a time, and sums the P rows in order for each column: it
// issues the loads of R rows (each 16 bytes of each of its U column
// groups, and the rows' entries of g, into registers) before their FMAs,
// so the first loads of A wait on nothing.
// A row that is not 16-byte aligned is read in narrower loads of the same
// 16 bytes; the slice's last len % V columns are summed one per thread.
template <int R, int U, typename TG, typename TA>
__device__ __forceinline__ void vecmat_body(
    const TG* __restrict__ g, const TA* __restrict__ a,
    float* __restrict__ out, int p, long long d, long long cw) {
  constexpr int V = 16 / sizeof(TA);
  const long long c0 = static_cast<long long>(blockIdx.x) * cw;
  const int len = static_cast<int>(min(cw, d - c0));
  const int n_vec = len / V;
  const TA* slice = a + c0;
  // row r of the slice starts ((m0 + r dm) mod V) elements past a 16-byte
  // boundary
  const int m0 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(slice) / sizeof(TA)) % V);
  const int dm = static_cast<int>(d % V);
  for (int k0 = threadIdx.x; k0 < n_vec; k0 += kThreads * U) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[u][e] = 0.f;
    }
    for (int r0 = 0; r0 < p; r0 += R) {
      uint4 x[U][R];
      float gr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r0 + r;
        if (row < p) {
          gr[r] = ld(g, row);
          const TA* rp = slice + static_cast<long long>(row) * d;
          const int mis = ((m0 + row * dm) & (V - 1)) * sizeof(TA);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int k = k0 + u * kThreads;
            if (k < n_vec) x[u][r] = ld16(rp + k * V, mis);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r < p) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (k0 + u * kThreads < n_vec) {
              axpy16(acc[u], gr[r], x[u][r],
                     static_cast<const TA*>(nullptr));
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kThreads;
      if (k < n_vec) {
        float4* o = reinterpret_cast<float4*>(out + c0 + k * V);
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          o[i] = make_float4(acc[u][4 * i], acc[u][4 * i + 1],
                             acc[u][4 * i + 2], acc[u][4 * i + 3]);
        }
      }
    }
  }
  const int t0 = n_vec * V;
  if (threadIdx.x < len - t0) {
    const long long col = c0 + t0 + threadIdx.x;
    float s = 0.f;
    for (int r = 0; r < p; ++r) {
      s += ld(g, r) * ld(a, r * d + col);
    }
    out[col] = s;
  }
}

template <int R, int U, typename TG, typename TA>
__global__ void __launch_bounds__(kThreads, 2)
vecmat_kernel(const TG* __restrict__ g, const TA* __restrict__ a,
              float* __restrict__ out, int p, long long d, long long cw) {
  vecmat_body<R, U>(g, a, out, p, d, cw);
}

// gridDim.y runs: run y reads g and A at their run strides and writes
// row y of the output, whose rows start `o_rs` floats apart (a multiple
// of 4, so every row stays 16-byte aligned).
template <int R, int U, typename TG, typename TA>
__global__ void __launch_bounds__(kThreads, 2)
vecmat_runs_kernel(const TG* __restrict__ g, long long g_rs,
                   const TA* __restrict__ a, long long a_rs,
                   float* __restrict__ out, long long o_rs, int p,
                   long long d, long long cw) {
  const long long y = blockIdx.y;
  vecmat_body<R, U>(g + y * g_rs, a + y * a_rs, out + y * o_rs, p, d, cw);
}

// Elementwise, grid-stride along D (x) and the cut rows (y); grid z
// runs over the runs of a batched call, each reading x and y at their
// run strides (0 for a single call) and writing its own (P, D) block.
template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(const TX* __restrict__ x, long long x_rs,
             const TY* __restrict__ y, long long y_rs,
             float* __restrict__ out, int p, long long d) {
  const long long run = blockIdx.z;
  x += run * x_rs;
  y += run * y_rs;
  out += run * p * d;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int r = blockIdx.y; r < p; r += gridDim.y) {
    const float xr = ld(x, r);
    float* row = out + static_cast<long long>(r) * d;
    for (long long col = static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x;
         col < d; col += stride) {
      row[col] = xr * ld(y, col);
    }
  }
}

unsigned grid_cols(long long d) {
  const long long blocks = (d + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 65535 ? blocks : 65535);
}

// blocks of cw columns cover [0, d) exactly, cw a multiple of 8
bool valid_grid(long long d, int blocks, long long cw) {
  return blocks >= 1 && cw >= 8 && cw % 8 == 0
         && static_cast<long long>(blocks - 1) * cw < d
         && static_cast<long long>(blocks) * cw >= d;
}

// Rows a sweep (2 or 8: up to p) and 16-byte loads of each row in flight
// per thread (8 loads in all).  The caller sizes the grid (blocks of cw
// columns, cw a multiple of 8, at most two blocks per SM).
template <typename TA, typename TV>
cudaError_t launch_matvec(const void* a, const void* v, float* partial,
                          int* ticket, float* out, int p, long long d,
                          int blocks, long long cw, cudaStream_t stream) {
  if (!valid_grid(d, blocks, cw)) return cudaErrorInvalidValue;
  const TA* pa = static_cast<const TA*>(a);
  const TV* pv = static_cast<const TV*>(v);
  if (p <= 2) {
    matvec_kernel<2, 4><<<blocks, kThreads, 0, stream>>>(
        pa, pv, partial, ticket, out, p, d, cw);
  } else {
    matvec_kernel<8, 1><<<blocks, kThreads, 0, stream>>>(
        pa, pv, partial, ticket, out, p, d, cw);
  }
  return cudaGetLastError();
}

// The same grid as matvec's; out 16-byte aligned (the wrapper allocates
// it).
template <typename TG, typename TA>
cudaError_t launch_vecmat(const void* g, const void* a, float* out, int p,
                          long long d, int blocks, long long cw,
                          cudaStream_t stream) {
  if (!valid_grid(d, blocks, cw)
      || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const TG* pg = static_cast<const TG*>(g);
  const TA* pa = static_cast<const TA*>(a);
  if (p <= 2) {
    vecmat_kernel<2, 4><<<blocks, kThreads, 0, stream>>>(pg, pa, out, p, d,
                                                         cw);
  } else {
    vecmat_kernel<8, 1><<<blocks, kThreads, 0, stream>>>(pg, pa, out, p, d,
                                                         cw);
  }
  return cudaGetLastError();
}

// gridDim.y = runs, each run on the single-run grid; `tickets`: runs
// ints, 0 between calls; `partial`: (runs, p, blocks) floats.
template <typename TA, typename TV>
cudaError_t launch_matvec_runs(const void* a, long long a_rs, const void* v,
                               long long v_rs, float* partial, int* tickets,
                               float* out, int runs, int p, long long d,
                               int blocks, long long cw,
                               cudaStream_t stream) {
  if (!valid_grid(d, blocks, cw) || runs < 1 || runs > 65535) {
    return cudaErrorInvalidValue;
  }
  const TA* pa = static_cast<const TA*>(a);
  const TV* pv = static_cast<const TV*>(v);
  const dim3 grid(blocks, runs);
  if (p <= 2) {
    matvec_runs_kernel<2, 4><<<grid, kThreads, 0, stream>>>(
        pa, a_rs, pv, v_rs, partial, tickets, out, p, d, cw);
  } else if constexpr (sizeof(TA) == 4) {
    matvec_runs_kernel<4, 1><<<grid, kThreads, 0, stream>>>(
        pa, a_rs, pv, v_rs, partial, tickets, out, p, d, cw);
  } else {
    matvec_runs_kernel<8, 1><<<grid, kThreads, 0, stream>>>(
        pa, a_rs, pv, v_rs, partial, tickets, out, p, d, cw);
  }
  return cudaGetLastError();
}

// Rows of `out` o_rs floats apart, o_rs a multiple of 4 and out 16-byte
// aligned.
template <typename TG, typename TA>
cudaError_t launch_vecmat_runs(const void* g, long long g_rs, const void* a,
                               long long a_rs, float* out, long long o_rs,
                               int runs, int p, long long d, int blocks,
                               long long cw, cudaStream_t stream) {
  if (!valid_grid(d, blocks, cw) || runs < 1 || runs > 65535
      || o_rs < d || o_rs % 4 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const TG* pg = static_cast<const TG*>(g);
  const TA* pa = static_cast<const TA*>(a);
  const dim3 grid(blocks, runs);
  if (p <= 2) {
    vecmat_runs_kernel<2, 4><<<grid, kThreads, 0, stream>>>(
        pg, g_rs, pa, a_rs, out, o_rs, p, d, cw);
  } else {
    vecmat_runs_kernel<8, 1><<<grid, kThreads, 0, stream>>>(
        pg, g_rs, pa, a_rs, out, o_rs, p, d, cw);
  }
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_rank1(const void* x, long long x_rs, const void* y,
                         long long y_rs, float* out, int runs, int p,
                         long long d, cudaStream_t stream) {
  if (runs < 1 || runs > 65535) return cudaErrorInvalidValue;
  const dim3 grid(grid_cols(d), static_cast<unsigned>(p < 65535 ? p : 65535),
                  static_cast<unsigned>(runs));
  rank1_kernel<TX, TY><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), x_rs, static_cast<const TY*>(y), y_rs, out,
      p, d);
  return cudaGetLastError();
}

// Instantiate F<T0, T1> for the two operand types (f32 = 0, bf16 = 1).
#define CUT_DISPATCH(F, bf0, bf1, ...)                                  \
  ((bf0) ? ((bf1) ? F<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__)        \
                  : F<__nv_bfloat16, float>(__VA_ARGS__))               \
         : ((bf1) ? F<float, __nv_bfloat16>(__VA_ARGS__)                \
                  : F<float, float>(__VA_ARGS__)))

}  // namespace

extern "C" {

// `ticket`: an int that is 0 between calls, one per stream; `partial`:
// (p, blocks) f32 scratch.
int cut_matvec(const void* a, int a_bf16, const void* v, int v_bf16,
               float* partial, int* ticket, float* out, int p, long long d,
               int blocks, long long cw, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_matvec, a_bf16, v_bf16, a, v,
                                       partial, ticket, out, p, d, blocks,
                                       cw,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_vecmat(const void* g, int g_bf16, const void* a, int a_bf16,
               float* out, int p, long long d, int blocks, long long cw,
               void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_vecmat, g_bf16, a_bf16, g, a,
                                       out, p, d, blocks, cw,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_rank1(const void* x, int x_bf16, const void* y, int y_bf16,
              float* out, int p, long long d, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_rank1, x_bf16, y_bf16, x, 0LL,
                                       y, 0LL, out, 1, p, d,
                                       static_cast<cudaStream_t>(stream)));
}

// The batched forms: `runs` problems in one launch, each operand at its
// run stride in elements (0 for an operand the runs share); outputs
// (runs, p), (runs, d) at row stride o_rs, and (runs, p, d).
int cut_matvec_runs(const void* a, int a_bf16, long long a_rs, const void* v,
                    int v_bf16, long long v_rs, float* partial, int* tickets,
                    float* out, int runs, int p, long long d, int blocks,
                    long long cw, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_matvec_runs, a_bf16, v_bf16, a,
                                       a_rs, v, v_rs, partial, tickets, out,
                                       runs, p, d, blocks, cw,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_vecmat_runs(const void* g, int g_bf16, long long g_rs, const void* a,
                    int a_bf16, long long a_rs, float* out, long long o_rs,
                    int runs, int p, long long d, int blocks, long long cw,
                    void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_vecmat_runs, g_bf16, a_bf16, g,
                                       g_rs, a, a_rs, out, o_rs, runs, p, d,
                                       blocks, cw,
                                       static_cast<cudaStream_t>(stream)));
}

int cut_rank1_runs(const void* x, int x_bf16, long long x_rs, const void* y,
                   int y_bf16, long long y_rs, float* out, int runs, int p,
                   long long d, void* stream) {
  return static_cast<int>(CUT_DISPATCH(launch_rank1, x_bf16, y_bf16, x, x_rs,
                                       y, y_rs, out, runs, p, d,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
