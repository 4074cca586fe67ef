// K20 segment_hll: per-group HyperLogLog registers,
//   flat = int32(gids) * m + int32(reg_idx)      (wrapping int32)
//   regs = max(0, segment_max(rho, flat, num_segments = G * m))
// -> regs int32 [G * m] (the wrapper reshapes to [G, m]); flat ids below 0
// or at/after G * m are dropped, as JAX's segment ops drop them.
//
// Replaces greptimedb_tpu/ops/sketch.py:185 `segment_hll` (B21: one
// jax.ops.segment_max over flattened (gid, register) ids, clamped at 0).
//
// Int32 wrap.  The reference multiplies and adds in int32 two's
// complement, so an out-of-range gid can alias into a valid register and,
// with G * m >= 2^31, the last groups' rows wrap negative and are dropped.
// Signed overflow is undefined in C++, so the id is computed in uint32 and
// cast to int32, which is the two's complement wrap.
//
// Bound on the H100: bytes.  Each row's reg_idx, rho and gids are read
// once (12 B) and the registers written once (G * m * 4 B): 17.28 M rows
// and G = 4000 are 207 MB + 66 MB at m = 4096 (0.082 ms at 3.35 TB/s) and
// 207 MB + 262 MB at m = 16384 (0.140 ms).  The operations (a multiply, an
// add, two compares a row) are far below 67 TOP/s.  The ordered path
// moves these bytes once where a window is one group (the run pass reads
// gids, the owners reg_idx and rho); with several groups a window the
// owners read gids again.
//
// Design: two device paths, chosen on the card with no host read.  Rows
// arrive in group runs (the TSBS scan's (host, ts) order), so each
// group's register row can have one owner, in shared memory.
//
// * The ordered path (csrc/group_runs.cuh, shared with K21): the run pass
//   sets the verdict and each window's first and last row; a window is
//   `cap` consecutive groups of m registers (ops/sketch.py::hll_layout:
//   4096 registers below m = 4096, else one group).  The host keeps the
//   ordered path off when G * m >= 2^31 (the int32 wrap) or m >
//   kMaxOrderedM (the shared-memory budget).  An owner block per window
//   zeroes the window's registers in shared memory, takes its first
//   `tile_rows` rows with a shared atomicMax (after a plain read;
//   registers only grow), and stores the whole row, empty registers and
//   empty groups included, with coalesced 16-byte stores: no global
//   atomic and no zero fill.  Helper blocks and the fold (max) take the
//   rest of a longer run.  A reg_idx outside [0, m) also sets the verdict
//   (the row is skipped, and the atomic path redoes the call).
// * The atomic path (verdict set: by-hour gids in host order, ids out of
//   range, the wrap): a fill kernel zeroes the registers, then one thread
//   a row reads the register through L2 and calls a global atomicMax only
//   where its rho is larger.
// Every kernel of the path not taken returns at once (a Gate, as K18's).
// A max is order free, so every run gives the same bytes.
#include "group_runs.cuh"

constexpr int kThreads = 256;
constexpr int kOwnThreads = 512;
constexpr int kMaxOrderedM = 1 << 15;     // 128 KB of registers in shared memory

// Mirrored field for field by _HllArgs in ops/sketch.py (ctypes).
struct HllArgs {
  int64_t n;            // rows
  int64_t total;        // G * m
  const int32_t* reg;   // [n] register index
  const int32_t* rho;   // [n]
  const int32_t* gids;  // [n]
  int32_t* regs;        // [total] out
  int32_t* verdict;     // [1] 0 = ordered path, else the atomic path
  int64_t* windows;     // [2 * n_windows] first row + 1, last row + 1 (0 = none), after
                        // the verdict word's line in one span
  int32_t* scratch;     // [n_tiles * stride] the helpers' partial rows
  int64_t groups;       // G
  int64_t n_windows;    // ceil(G / cap)
  int64_t tile_rows;    // rows an owner or a helper takes
  int64_t n_tiles;      // ceil(n / tile_rows), 0 off the ordered path
  int64_t stride;       // ints per partial row, cap * m rounded up to 4
  int32_t m;
  int32_t cap;          // groups per window
  int32_t ordered;      // 0: the host keeps the ordered path off
  int32_t reserved;
};

// ---- the run pass ----

__global__ void __launch_bounds__(kRunThreads) run_kernel(const HllArgs a) {
  run_pass_any(a.gids, a.n, a.groups, a.cap, a.verdict, a.windows, a.windows + a.n_windows);
}

// ---- the ordered path ----

// Zero, fill from rows [lo, hi), store to dst: a window's `width`
// registers in shared memory.
__device__ void own_rows(const HllArgs& a, int32_t* sreg, int64_t width, int64_t ga, int64_t lo,
                         int64_t hi, int32_t* dst, bool vec) {
  zero_row(sreg, width, vec);
  __syncthreads();
  bool bad = false;
  auto take = [&](int32_t reg, int32_t rho, int32_t g) {
    if ((uint32_t)reg >= (uint32_t)a.m) {
      bad = true;
    } else if (rho > 0) {
      const int32_t slot = reg + (int32_t)(g - ga) * a.m;
      if (sreg[slot] < rho) atomicMax(sreg + slot, rho);
    }
  };
  // four rows in flight a thread; a window of one group needs no gids
  const int64_t step = blockDim.x;
  int64_t r = lo + threadIdx.x;
  for (; r + 3 * step < hi; r += 4 * step) {
    int32_t rg[4], rh[4], gg[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rg[u] = a.reg[r + u * step];
      rh[u] = a.rho[r + u * step];
      gg[u] = a.cap > 1 ? a.gids[r + u * step] : (int32_t)ga;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) take(rg[u], rh[u], gg[u]);
  }
  for (; r < hi; r += step) take(a.reg[r], a.rho[r], a.cap > 1 ? a.gids[r] : (int32_t)ga);
  if (bad) set_atomic_path(a.verdict);
  __syncthreads();
  store_row(sreg, width, dst, vec);
}

__global__ void __launch_bounds__(kOwnThreads) own_kernel(const HllArgs a, const Gate gate) {
  extern __shared__ int4 smem4[];
  if (block_gate_shut(gate)) return;
  int32_t* sreg = (int32_t*)smem4;
  BlockRows br;
  if (!block_rows(blockIdx.x, a.gids, a.windows, a.n_windows, a.tile_rows, a.cap, br)) return;
  const int64_t w = br.w, lo = br.lo, hi = br.hi;
  int32_t* dst = br.owner ? a.regs + w * a.cap * a.m
                          : a.scratch + ((int64_t)blockIdx.x - a.n_windows) * a.stride;
  const int64_t ga = w * a.cap;
  const int64_t width = min64(a.cap, a.groups - ga) * a.m;
  own_rows(a, sreg, width, ga, lo, hi, dst, (a.m & 3) == 0);
}

// The windows longer than tile_rows: the max of the owner's row and every
// helper's partial (group_runs.cuh).
__global__ void __launch_bounds__(kThreads) fold_kernel(const HllArgs a, const Gate gate) {
  __shared__ int4 part[kThreads];
  if (block_gate_shut(gate)) return;
  fold_window<kThreads>(a.gids, a.windows, a.n_windows, a.tile_rows, a.cap, a.groups, a.m,
                        a.scratch, a.stride, a.regs, part, FoldMax());
}

// ---- the atomic path ----

__global__ void __launch_bounds__(kThreads) fill_kernel(const HllArgs a, const Gate gate) {
  if (block_gate_shut(gate)) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t4 = a.total / 4;
  int4* r4 = (int4*)a.regs;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < t4; i += stride)
    r4[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = 4 * t4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.total; i += stride)
    a.regs[i] = 0;
}

__global__ void __launch_bounds__(kThreads) hll_kernel(const HllArgs a, const Gate gate) {
  if (block_gate_shut(gate)) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const int32_t r = a.rho[i];
    if (r <= 0) continue;
    const int32_t flat = (int32_t)((uint32_t)a.gids[i] * (uint32_t)a.m + (uint32_t)a.reg[i]);
    if (flat < 0 || (int64_t)flat >= a.total) continue;
    int32_t* p = a.regs + flat;
    if (__ldcg(p) < r) atomicMax(p, r);
  }
}

GT_EXPORT int gt_segment_hll(const HllArgs* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Gate ordered{a->verdict, 0, 0}, atomic{a->verdict, 1, 0};
  if (a->ordered) {
    static bool allowed[64] = {false};
    allow_smem(own_kernel, allowed, kMaxOrderedM * 4);
    // the verdict word and the window table are one span (ops/sketch.py
    // `_run_buffers`): one memset clears both
    cudaMemsetAsync(a->verdict, 0, (char*)(a->windows + 2 * a->n_windows) - (char*)a->verdict, s);
    if (a->n > 0) {
      run_kernel<<<run_pass_grid(a->n), kRunThreads, 0, s>>>(*a);
    }
    const int smem = (int)(a->cap * a->m * 4);
    own_kernel<<<(unsigned)(a->n_windows + a->n_tiles), kOwnThreads, smem, s>>>(*a, ordered);
    if (a->n_tiles > 0) fold_kernel<<<(unsigned)a->n_tiles, kThreads, 0, s>>>(*a, ordered);
  } else {
    cudaMemsetAsync(a->verdict, 0xff, sizeof(int32_t), s);
  }
  fill_kernel<<<run_grid(a->total / 4 + 1, kThreads), kThreads, 0, s>>>(*a, atomic);
  hll_kernel<<<run_grid(a->n, kThreads), kThreads, 0, s>>>(*a, atomic);
  return (int)cudaGetLastError();
}
