// The batched matvec as one persistent launch fed by copies into a ring
// of shared-memory stages: a design measured against the port's
// cut_matvec_runs by benchmarks/torch_cut_runs_designs.py, not used by
// the port.  It includes the port's source (compile with
// -I src/repro_torch/kernels/csrc), so it sums with the port's own
// helpers (dot16, pad, rows_sum, partial_totals, ticket_add, span_of,
// bulk_body, end_index) and only the walk over items and the ring are its
// own.  f32 A and v.
//
// A work item is (run y, chunk b) = (i / blocks, i % blocks), chunk b the
// single-run grid's columns [b cw, (b + 1) cw) (cut_eval.cut_grid).  The
// launch has at most the resident blocks; block x takes items x, x +
// gridDim.x, ...  An item is read in pieces, the single-run kernel's
// sweeps: a group of R rows (8, or 2 at P <= 2) over a sub-slice of at
// most kMvCols columns.  Each piece's rows of A and slice of v land in a
// ring stage by copies completing on the stage's mbarrier, issued
// n_stages pieces ahead, so the next pieces' bytes are in flight while one
// is summed: with kBulk, one cp.async.bulk a row and one for v from
// thread 0 (expect_tx on the stage's mbarrier); else 16-byte cp.async
// spread over the block, each thread arriving on the mbarrier once its
// copies land.  The entries before and after each 16-byte-aligned body
// are loaded into registers a piece ahead.  Every thread sums exactly the
// entries, in exactly the order, of the single-run kernel's thread
// (mv_sweep: vectors t, t + 256, ... of each row's body, then its head and
// tail), and rows_sum reduces them alike, so row y of the output is
// bitwise the single-run kernel on run y.  Warp 0 takes run y's ticket
// when an item's partials are stored; the block reads the answer after
// the next piece has landed, and the block that added last sums run y's
// partials (partial_totals) and resets the ticket.

#include "cut_kernels.cu"

namespace {

constexpr int kMaxStages = 3;

__host__ __device__ constexpr long long r16(long long x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory: an mbarrier a stage, v's
// sub-slice as padded f32 (vs), then the stages, each `rows` rows of A in
// `row_bytes` and v's raw entries; every region 16-byte aligned.
struct RingLayout {
  long long vs, stages, row_bytes, stage_bytes, total;
};

__host__ __device__ inline RingLayout ring_layout(int p, long long cw,
                                                  int n_stages) {
  const long long cols = cw < kMvCols ? cw : kMvCols;
  const long long rows = p <= 2 ? p : (p < kRows ? p : kRows);
  RingLayout l;
  l.vs = r16(8LL * n_stages);
  l.stages = l.vs + r16(4 * (cols + cols / 32 + 1));
  l.row_bytes = r16(4 * (cols + 4));
  l.stage_bytes = rows * l.row_bytes + r16(4 * (cols + 4));
  l.total = l.stages + n_stages * l.stage_bytes;
  return l;
}

struct RingArgs {
  const float* a;
  long long a_rs;
  const float* v;
  long long v_rs;
  float* partial;   // (runs, P, blocks)
  int* tickets;     // runs ints, 0 between calls
  float* out;       // (runs, P)
  int p, blocks, items, n_stages;
  long long d, cw;
};

// Item, row group and sub-slice of one piece.
struct Cursor {
  int i, g, s;
};

// One piece's place: run y, chunk b, rows p0 .. p0 + nr - 1, columns
// [s0, s0 + len); whether it is its item's last sub-slice of the group
// and its item's last group.
struct PieceAt {
  int y, b, p0, nr, len;
  long long s0;
  bool last_sub, last_group;
};

template <int R>
__device__ __forceinline__ PieceAt piece_at(const RingArgs& g,
                                            const Cursor& c) {
  PieceAt pc;
  pc.y = c.i / g.blocks;
  pc.b = c.i % g.blocks;
  const long long c0 = static_cast<long long>(pc.b) * g.cw;
  const long long c1 = min(c0 + g.cw, g.d);
  pc.s0 = c0 + static_cast<long long>(c.s) * kMvCols;
  pc.len = static_cast<int>(min(static_cast<long long>(kMvCols),
                                c1 - pc.s0));
  pc.p0 = c.g * R;
  pc.nr = min(R, g.p - pc.p0);
  pc.last_sub = pc.s0 + pc.len == c1;
  pc.last_group = pc.p0 + pc.nr == g.p;
  return pc;
}

template <int R>
__device__ __forceinline__ void advance(const RingArgs& g, Cursor& c) {
  const PieceAt pc = piece_at<R>(g, c);
  if (!pc.last_sub) {
    ++c.s;
  } else if (!pc.last_group) {
    c.s = 0;
    ++c.g;
  } else {
    c = {c.i + static_cast<int>(gridDim.x), 0, 0};
  }
}

__device__ __forceinline__ const float* row_of(const RingArgs& g,
                                                const PieceAt& pc, int r) {
  return g.a + pc.y * g.a_rs + static_cast<long long>(pc.p0 + r) * g.d
         + pc.s0;
}

__device__ __forceinline__ const float* v_of(const RingArgs& g,
                                              const PieceAt& pc) {
  return g.v + pc.y * g.v_rs + pc.s0;
}

// The entries of a piece outside the rows' and v's 16-byte-aligned bodies
// that thread t sums or stages: head and tail entry t of each row (as
// mv_sweep loads them) and entry t of v's head and tail.
template <int R>
struct Ends {
  float head[R], tail[R], v;
};

template <int R>
__device__ __forceinline__ Ends<R> load_ends(const RingArgs& g,
                                             const PieceAt& pc) {
  const int t = threadIdx.x;
  Ends<R> e;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* row = row_of(g, pc, min(r, pc.nr - 1));
    const Span sp = span_of(row, pc.len);
    const int t0 = sp.h + sp.nb;
    e.head[r] = r < pc.nr && t < sp.h ? ld(row, t) : 0.f;
    e.tail[r] = r < pc.nr && t < pc.len - t0 ? ld(row, t0 + t) : 0.f;
  }
  const float* v = v_of(g, pc);
  const int j = t < 8 ? end_index(v, pc.len, t) : -1;
  e.v = j >= 0 ? ld(v, j) : 0.f;
  return e;
}

// 16 bytes from device memory to shared memory, asynchronously (through
// L2 only: A is read once).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// The mbarrier at `bar` counts one arrival when every cp.async this
// thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The body of src[0 : len] to dst + mis + h (where bulk_body puts it), in
// 16-byte copies spread over the block's threads.
__device__ __forceinline__ void async_body(float* dst, const float* src,
                                           int len) {
  const Span sp = span_of(src, len);
  const uint32_t d0 = smem_u32(dst + sp.mis + sp.h);
  const float* s0 = src + sp.h;
  for (int k = threadIdx.x; k < sp.nb / 4; k += kThreads) {
    cp_async16(d0 + 16 * k, s0 + 4 * k);
  }
}

template <int R, bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
ring_kernel(const RingArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kWarps][kRows];
  __shared__ int done_run, done_last;
  const int t = threadIdx.x;
  const RingLayout lay = ring_layout(g.p, g.cw, g.n_stages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* vs = reinterpret_cast<float*>(smem + lay.vs);
  auto bar = [&](int st) { return smem_u32(bars + st); };
  auto stage_row = [&](int st, int r) {
    return reinterpret_cast<float*>(smem + lay.stages + st * lay.stage_bytes
                                    + r * lay.row_bytes);
  };
  auto stage_vraw = [&](int st) {
    return reinterpret_cast<float*>(smem + lay.stages + st * lay.stage_bytes
                                    + min(g.p, R) * lay.row_bytes);
  };
  // piece `c`'s rows and v slice into stage `st`; the stage's mbarrier
  // completes when they have landed
  auto issue = [&](const Cursor& c, int st) {
    const PieceAt pc = piece_at<R>(g, c);
    if constexpr (kBulk) {
      if (t == 0) {
        uint32_t bytes = body_bytes(v_of(g, pc), pc.len);
        for (int r = 0; r < pc.nr; ++r) {
          bytes += body_bytes(row_of(g, pc, r), pc.len);
        }
        mbar_expect_tx(bar(st), bytes);
        for (int r = 0; r < pc.nr; ++r) {
          bulk_body(stage_row(st, r), row_of(g, pc, r), pc.len, bar(st));
        }
        bulk_body(stage_vraw(st), v_of(g, pc), pc.len, bar(st));
      }
    } else {
      for (int r = 0; r < pc.nr; ++r) {
        async_body(stage_row(st, r), row_of(g, pc, r), pc.len);
      }
      async_body(stage_vraw(st), v_of(g, pc), pc.len);
      cp_async_arrive(bar(st));
    }
  };
  // the block that added last to run y's ticket sums its partials, each
  // row in the single-run kernel's order, and resets the ticket
  auto finish = [&](int y) {
    const float* part = g.partial + static_cast<long long>(y) * g.p * g.blocks;
    for (int p0 = 0; p0 < g.p; p0 += kRows) {
      const int nr = min(kRows, g.p - p0);
      const float sum = partial_totals(part, p0, nr, g.blocks, red);
      if (t < nr) g.out[static_cast<long long>(y) * g.p + p0 + t] = sum;
    }
    if (t == 0) g.tickets[y] = 0;
  };

  Cursor cons{static_cast<int>(blockIdx.x), 0, 0};
  Cursor prod = cons;
  if (t == 0) {
    for (int st = 0; st < g.n_stages; ++st) {
      mbar_init(bar(st), kBulk ? 1 : kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int st = 0; st < g.n_stages && prod.i < g.items; ++st) {
    issue(prod, st);
    advance<R>(g, prod);
  }
  Ends<R> ends = load_ends<R>(g, piece_at<R>(g, cons));
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  bool ticketed = false;   // a ticket's answer waits in done_*
  for (int n = 0; cons.i < g.items; ++n) {
    const int st = n % g.n_stages;
    const PieceAt pc = piece_at<R>(g, cons);
    Cursor next = cons;
    advance<R>(g, next);
    Ends<R> next_ends{};
    if (next.i < g.items) next_ends = load_ends<R>(g, piece_at<R>(g, next));
    mbar_wait(bar(st), (n / g.n_stages) & 1);

    // v's sub-slice at its padded places, as stage_v puts it
    const float* v = v_of(g, pc);
    const Span sv = span_of(v, pc.len);
    const float* v_raw = stage_vraw(st) + sv.mis;
    for (int j = sv.h + t; j < sv.h + sv.nb; j += kThreads) {
      vs[pad(j)] = v_raw[j];
    }
    if (t < 8) {
      const int j = end_index(v, pc.len, t);
      if (j >= 0) vs[pad(j)] = ends.v;
    }
    __syncthreads();
    if (ticketed) {
      ticketed = false;
      if (done_last) finish(done_run);
    }

    // mv_sweep's sums, A read from the stage
    const float* row[R];
    int h[R], nv[R];
    int n_max = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = min(r, pc.nr - 1);
      const Span sp = span_of(row_of(g, pc, rr), pc.len);
      row[r] = stage_row(st, rr) + sp.mis + sp.h;
      h[r] = sp.h;
      nv[r] = r < pc.nr ? sp.nb / 4 : 0;
      n_max = max(n_max, nv[r]);
    }
#pragma unroll 2
    for (int k = t; k < n_max; k += kThreads) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (k < nv[r]) {
          acc[r] += dot16(*reinterpret_cast<const uint4*>(row[r] + 4 * k),
                          vs, h[r] + 4 * k, static_cast<const float*>(nullptr));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t0 = h[r] + nv[r] * 4;
      if (t < h[r]) acc[r] += ends.head[r] * vs[pad(t)];
      if (t < pc.len - t0) acc[r] += ends.tail[r] * vs[pad(t0 + t)];
    }
    __syncthreads();   // stage st and vs read: the stage takes a new piece
    if (prod.i < g.items) {
      issue(prod, st);
      advance<R>(g, prod);
    }

    if (pc.last_sub) {
      const float s = rows_sum(acc, pc.nr, red);
      if (t < pc.nr) {
        g.partial[(static_cast<long long>(pc.y) * g.p + pc.p0 + t) * g.blocks
                  + pc.b] = s;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if (pc.last_group) {
        // warp 0 holds the item's partials: it alone takes run y's
        // ticket, and the block reads the answer after the next piece
        // has landed
        ticketed = true;
        if (t < 32) {
          __syncwarp();
          if (t == 0) {
            done_run = pc.y;
            done_last = ticket_add(g.tickets + pc.y) == g.blocks - 1;
          }
        }
      }
    }
    cons = next;
    ends = next_ends;
  }
  __syncthreads();
  if (ticketed && done_last) finish(done_run);
}

const void* ring_fn(int p, int bulk) {
  if (p <= 2) {
    return bulk ? reinterpret_cast<const void*>(&ring_kernel<2, true>)
                : reinterpret_cast<const void*>(&ring_kernel<2, false>);
  }
  return bulk ? reinterpret_cast<const void*>(&ring_kernel<8, true>)
              : reinterpret_cast<const void*>(&ring_kernel<8, false>);
}

bool ring_set_smem(const void* fn, long long smem) {
  return smem >= 0 && smem <= INT32_MAX
         && cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem)) == cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block with a ring of n_stages stages.
long long ring_smem(int p, long long cw, int n_stages) {
  return ring_layout(p, cw, n_stages).total;
}

// Blocks of the ring kernel (P, copy kind) one SM of the current device
// holds with `smem` bytes of dynamic shared memory; 0 where none.
int ring_occupancy(int p, int bulk, long long smem) {
  const void* fn = ring_fn(p, bulk);
  int n = 0;
  if (!ring_set_smem(fn, smem)
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, fn, kThreads, static_cast<size_t>(smem)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// `grid` persistent blocks over runs x blocks items (chunks of cw
// columns, the single-run grid), a ring of n_stages stages in `smem`
// bytes, bulk copies (`bulk`) or 16-byte cp.async; `tickets`: runs ints,
// 0 between calls; `partial`: (runs, p, blocks) floats; outputs (runs,
// p).  A and v at run strides a_rs, v_rs (0: shared).
int ring_matvec_runs(const float* a, long long a_rs, const float* v,
                     long long v_rs, float* partial, int* tickets,
                     float* out, int runs, int p, long long d, int blocks,
                     long long cw, int grid, int n_stages, int bulk,
                     long long smem, void* stream) {
  if (!valid_grid(d, blocks, cw) || runs < 1 || p < 1
      || static_cast<long long>(runs) * blocks > INT32_MAX || grid < 1
      || static_cast<long long>(grid) > static_cast<long long>(runs) * blocks
      || n_stages < 1 || n_stages > kMaxStages
      || smem < ring_layout(p, cw, n_stages).total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = ring_fn(p, bulk);
  if (!ring_set_smem(fn, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RingArgs args{a, a_rs, v, v_rs, partial, tickets, out, p, blocks,
                      runs * blocks, n_stages, d, cw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= 2) {
    if (bulk) {
      ring_kernel<2, true><<<grid, kThreads, smem, s>>>(args);
    } else {
      ring_kernel<2, false><<<grid, kThreads, smem, s>>>(args);
    }
  } else if (bulk) {
    ring_kernel<8, true><<<grid, kThreads, smem, s>>>(args);
  } else {
    ring_kernel<8, false><<<grid, kThreads, smem, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
