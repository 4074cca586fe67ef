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
// * The run pass reads gids once (a warp 256 rows at a time) and sets the
//   `verdict` word (0 = ordered) where a gid lies outside [0, G) or below
//   the gid of the row before it; it records each window's first and last
//   row by plain stores from the one row where the window's run starts
//   or ends, and stops once the verdict is set.  A window is `cap`
//   consecutive groups of m registers (ops/sketch.py::hll_layout: 4096
//   registers below m = 4096, else one group).  The host keeps the
//   ordered path off when G * m >= 2^31 (the int32 wrap) or m >
//   kMaxOrderedM (the shared-memory budget).
// * The ordered path.  An owner block per window zeroes the window's
//   registers in shared memory, takes its first `tile_rows` rows with a
//   shared atomicMax (after a plain read; registers only grow), and
//   stores the whole row, empty registers and empty groups included, with
//   coalesced 16-byte stores: no global atomic and no zero fill.  A longer
//   run (one group's rows, or every row on one register) is split over
//   helper blocks, one per tile_rows rows of the extra part, each storing
//   its partial row to scratch; the fold kernel then takes the max of the
//   owner's row and the partials, each helper block of the window folding
//   a slice of its columns.  A reg_idx outside [0, m) also sets the
//   verdict (the row is skipped, and the atomic path redoes the call).
// * The atomic path (verdict set: by-hour gids in host order, ids out of
//   range, the wrap): a fill kernel zeroes the registers, then one thread
//   a row reads the register through L2 and calls a global atomicMax only
//   where its rho is larger.
// Every kernel of the path not taken returns at once (a Gate, as K18's).
// A max is order free, so every run gives the same bytes.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kOwnThreads = 512;
constexpr int kRunRows = 8;  // rows in flight a lane in the run pass
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;
constexpr int kMaxOrderedM = 1 << 15;     // 128 KB of registers in shared memory

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// Mirrored field for field by _HllArgs in ops/sketch.py (ctypes).
struct HllArgs {
  int64_t n;            // rows
  int64_t total;        // G * m
  const int32_t* reg;   // [n] register index
  const int32_t* rho;   // [n]
  const int32_t* gids;  // [n]
  int32_t* regs;        // [total] out
  int32_t* verdict;     // [1] 0 = ordered path, else the atomic path
  int64_t* windows;     // [2 * n_windows] first row + 1, last row + 1 (0 = none)
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

__device__ __forceinline__ void set_atomic_path(const HllArgs& a) {
  *(volatile int32_t*)a.verdict = 1;
}

// ---- the run pass ----

__global__ void __launch_bounds__(kThreads) run_kernel(const HllArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kRunRows;
  int64_t* first = a.windows;
  int64_t* last = a.windows + a.n_windows;
  // a warp takes 32 * kRunRows rows at once, all loaded before any is
  // checked; the loop is warp-uniform (every lane takes part in the
  // shuffles)
  for (int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * kRunRows; r0 < a.n;
       r0 += stride) {
    // one round trip a chunk: its gids, the rows on either side of it and
    // the verdict word are loaded together
    int32_t gg[kRunRows], prev[kRunRows], next[kRunRows];
#pragma unroll
    for (int u = 0; u < kRunRows; ++u) {
      const int64_t r = r0 + 32 * u + lane;
      gg[u] = r < a.n ? a.gids[r] : 0;
    }
    const int64_t r_end = r0 + 32 * kRunRows;
    const int32_t before = lane == 0 && r0 > 0 ? a.gids[r0 - 1] : 0;
    const int32_t after = lane == 31 && r_end < a.n ? a.gids[r_end] : 0;
    // once a row breaks the order nothing here is read: stop (this also
    // keeps unordered rows from storing run ends into a few hot words)
    if (__any_sync(0xffffffffu, lane == 0 && *(volatile const int32_t*)a.verdict != 0)) break;
    bool bad = false;
#pragma unroll
    for (int u = 0; u < kRunRows; ++u) {
      const int64_t r = r0 + 32 * u + lane;
      prev[u] = __shfl_up_sync(0xffffffffu, gg[u], 1);
      next[u] = __shfl_down_sync(0xffffffffu, gg[u], 1);
      // the neighbours across this chunk's groups of 32 rows
      const int32_t last_of_prev = __shfl_sync(0xffffffffu, gg[u > 0 ? u - 1 : 0], 31);
      const int32_t first_of_next = __shfl_sync(0xffffffffu, gg[u + 1 < kRunRows ? u + 1 : u], 0);
      if (lane == 0) prev[u] = u > 0 ? last_of_prev : before;
      if (lane == 31) next[u] = u + 1 < kRunRows ? first_of_next : after;
      if (r < a.n) bad |= gg[u] < 0 || (int64_t)gg[u] >= a.groups || (r > 0 && gg[u] < prev[u]);
    }
    if (__any_sync(0xffffffffu, bad)) {
      if (lane == 0) set_atomic_path(a);
      break;
    }
#pragma unroll
    for (int u = 0; u < kRunRows; ++u) {
      const int64_t r = r0 + 32 * u + lane;
      const bool head = r == 0 || prev[u] != gg[u], tail = r + 1 == a.n || next[u] != gg[u];
      if (r >= a.n || !(head || tail)) continue;  // inside a group's run: no division
      const int32_t w = gg[u] / a.cap;
      if (r == 0 || (head && prev[u] / a.cap != w)) first[w] = r + 1;
      if (r + 1 == a.n || (tail && next[u] / a.cap != w)) last[w] = r + 1;
    }
  }
}

// ---- the ordered path ----

// Zero, fill from rows [lo, hi), store to dst: a window's `width`
// registers in shared memory.
__device__ void own_rows(const HllArgs& a, int32_t* sreg, int64_t width, int64_t ga, int64_t lo,
                         int64_t hi, int32_t* dst, bool vec) {
  const int64_t w4 = vec ? width / 4 : 0;
  int4* s4 = (int4*)sreg;
  for (int64_t i = threadIdx.x; i < w4; i += blockDim.x) s4[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = 4 * w4 + threadIdx.x; i < width; i += blockDim.x) sreg[i] = 0;
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
  if (bad) set_atomic_path(a);
  __syncthreads();
  int4* d4 = (int4*)dst;
  for (int64_t i = threadIdx.x; i < w4; i += blockDim.x) d4[i] = s4[i];
  for (int64_t i = 4 * w4 + threadIdx.x; i < width; i += blockDim.x) dst[i] = sreg[i];
}

// A window's rows: [first, last] (first > last when it has none).
__device__ __forceinline__ void window_rows(const HllArgs& a, int64_t w, int64_t& f, int64_t& l) {
  f = a.windows[w] - 1;
  l = a.windows[a.n_windows + w] - 1;
  if (f < 0) l = -2;
}

__global__ void __launch_bounds__(kOwnThreads) own_kernel(const HllArgs a, const Gate gate) {
  extern __shared__ int4 smem4[];
  if (gate_shut(gate)) return;
  int32_t* sreg = (int32_t*)smem4;
  const int64_t b = blockIdx.x;
  int64_t w, lo, hi;
  int32_t* dst;
  if (b < a.n_windows) {  // the owner of window b
    w = b;
    int64_t f, l;
    window_rows(a, w, f, l);
    lo = f < 0 ? 0 : f;
    hi = f < 0 ? 0 : min64(f + a.tile_rows, l + 1);
    dst = a.regs + w * a.cap * a.m;
  } else {  // a helper: the extra part of the window holding its tile's first row
    const int64_t h = b - a.n_windows;
    const int64_t hs = h * a.tile_rows;
    w = a.gids[hs] / a.cap;
    int64_t f, l;
    window_rows(a, w, f, l);
    lo = max64(hs, f + a.tile_rows);
    hi = min64(hs + a.tile_rows, l + 1);
    if (lo >= hi) return;
    dst = a.scratch + h * a.stride;
  }
  const int64_t ga = w * a.cap;
  const int64_t width = min64(a.cap, a.groups - ga) * a.m;
  own_rows(a, sreg, width, ga, lo, hi, dst, (a.m & 3) == 0);
}

// The windows longer than tile_rows: the max of the owner's row and every
// helper's partial, helper tile h folding its share of the columns.
__global__ void __launch_bounds__(kThreads) fold_kernel(const HllArgs a, const Gate gate) {
  __shared__ int4 part[kThreads];
  if (gate_shut(gate)) return;
  const int64_t h = blockIdx.x;
  const int64_t hs = h * a.tile_rows;
  const int64_t w = a.gids[hs] / a.cap;
  int64_t f, l;
  window_rows(a, w, f, l);
  if (max64(hs, f + a.tile_rows) >= min64(hs + a.tile_rows, l + 1)) return;  // not a helper
  const int64_t h0 = (f + a.tile_rows) / a.tile_rows, h1 = l / a.tile_rows;
  const int64_t ga = w * a.cap;
  const int64_t width = min64(a.cap, a.groups - ga) * a.m;
  const int64_t width4 = (width + 3) / 4;
  const int64_t per = (width4 + (h1 - h0)) / (h1 - h0 + 1);
  const int64_t c_lo = (h - h0) * per, c_hi = min64(width4, c_lo + per);
  // lanes: `cl` columns of 16 bytes x `hl` helpers, cl a power of two
  int cl = 1;
  while (cl < 32 && cl < per) cl <<= 1;
  const int hl = kThreads / cl;
  const int col = threadIdx.x % cl, hlane = threadIdx.x / cl;
  const int4* sc = (const int4*)a.scratch;
  const int64_t stride4 = a.stride / 4;
  int32_t* dst = a.regs + ga * a.m;
  for (int64_t c0 = c_lo; c0 < c_hi; c0 += cl) {
    const int64_t c = c0 + col;
    int4 acc = make_int4(0, 0, 0, 0);
    if (c < c_hi) {
#pragma unroll 4
      for (int64_t hh = h0 + hlane; hh <= h1; hh += hl) {
        const int4 v = __ldcg(sc + hh * stride4 + c);
        acc.x = max(acc.x, v.x);
        acc.y = max(acc.y, v.y);
        acc.z = max(acc.z, v.z);
        acc.w = max(acc.w, v.w);
      }
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    if (hlane == 0 && c < c_hi) {
      for (int j = 1; j < hl; ++j) {
        const int4 v = part[j * cl + col];
        acc.x = max(acc.x, v.x);
        acc.y = max(acc.y, v.y);
        acc.z = max(acc.z, v.z);
        acc.w = max(acc.w, v.w);
      }
      const int32_t got[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int j = 0; j < 4 && 4 * c + j < width; ++j) {
        int32_t* p = dst + 4 * c + j;
        *p = max(*p, got[j]);
      }
    }
    __syncthreads();
  }
}

// ---- the atomic path ----

__global__ void __launch_bounds__(kThreads) fill_kernel(const HllArgs a, const Gate gate) {
  if (gate_shut(gate)) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t4 = a.total / 4;
  int4* r4 = (int4*)a.regs;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < t4; i += stride)
    r4[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = 4 * t4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.total; i += stride)
    a.regs[i] = 0;
}

__global__ void __launch_bounds__(kThreads) hll_kernel(const HllArgs a, const Gate gate) {
  if (gate_shut(gate)) return;
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

static int grid_for(int64_t items) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want < kSms * kBlocksPerSm ? want : kSms * kBlocksPerSm));
}

GT_EXPORT int gt_segment_hll(const HllArgs* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Gate ordered{a->verdict, 0, 0}, atomic{a->verdict, 1, 0};
  if (a->ordered) {
    static bool allowed[64] = {false};
    int dev = -1;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64 || !allowed[dev]) {
      cudaFuncSetAttribute(own_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxOrderedM * 4);
      if (dev >= 0 && dev < 64) allowed[dev] = true;
    }
    cudaMemsetAsync(a->verdict, 0, sizeof(int32_t), s);
    cudaMemsetAsync(a->windows, 0, 2 * a->n_windows * sizeof(int64_t), s);
    if (a->n > 0) run_kernel<<<grid_for((a->n + kRunRows - 1) / kRunRows), kThreads, 0, s>>>(*a);
    const int smem = (int)(a->cap * a->m * 4);
    own_kernel<<<(unsigned)(a->n_windows + a->n_tiles), kOwnThreads, smem, s>>>(*a, ordered);
    if (a->n_tiles > 0) fold_kernel<<<(unsigned)a->n_tiles, kThreads, 0, s>>>(*a, ordered);
  } else {
    cudaMemsetAsync(a->verdict, 0xff, sizeof(int32_t), s);
  }
  fill_kernel<<<grid_for(a->total / 4 + 1), kThreads, 0, s>>>(*a, atomic);
  hll_kernel<<<grid_for(a->n), kThreads, 0, s>>>(*a, atomic);
  return (int)cudaGetLastError();
}
