// Rows in group runs: the ordered path that K20 (segment_hll.cu) and K21
// (segment_udd.cu) share.
//
// Both kernels build one row of `width` ints a group (K20 registers, K21
// bucket counts) from rows that arrive in group runs (the TSBS scan's
// (host, ts) order).  A window is `cap` consecutive groups
// (ops/sketch.py::run_layout); its rows are one contiguous range of the
// input, so one owner block can build the window in shared memory and
// store it whole, with no fill and no global atomic.
//
// * The run pass reads gids once (a warp 256 rows at a time) and sets the
//   `verdict` word (0 = ordered) where a gid lies outside [0, G) or below
//   the gid of the row before it; it records each window's first and last
//   row by plain stores from the one row where the window's run starts or
//   ends, and stops once the verdict is set.
// * An owner block takes its window's first `tile_rows` rows; a longer
//   run is split over helper blocks, one per tile_rows rows of the extra
//   part, each storing its partial row to scratch; a fold kernel then
//   combines the owner's row with the partials (max for K20, + for K21),
//   each helper block of the window folding a slice of its columns.
//
// The verdict word sits alone on its 128-byte line (ops/sketch.py
// `_run_buffers`): the run pass polls it while run ends are stored to the
// window table, and the kernels after it read it once a block.
#pragma once

#include "common.cuh"

constexpr int kRunRows = 8;       // rows in flight a lane in the run pass
constexpr int kRunThreads = 256;  // threads a CTA of the run pass
constexpr int kRunCtasPerSm = 4;  // the run pass's grid cap (its 64 registers' occupancy)

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void set_atomic_path(int32_t* verdict) {
  *(volatile int32_t*)verdict = 1;
}

// The run pass over rows [0, n): a grid-stride walk, warp-uniform (every
// lane takes part in the shuffles).
__device__ __forceinline__ void run_pass(const int32_t* gids, int64_t n, int64_t groups,
                                         int32_t cap, int32_t* verdict, int64_t* first,
                                         int64_t* last) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kRunRows;
  // a warp takes 32 * kRunRows rows at once, all loaded before any is
  // checked
  for (int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * kRunRows; r0 < n;
       r0 += stride) {
    // one round trip a chunk: its gids, the rows on either side of it and
    // the verdict word are loaded together
    int32_t gg[kRunRows], prev[kRunRows], next[kRunRows];
#pragma unroll
    for (int u = 0; u < kRunRows; ++u) {
      const int64_t r = r0 + 32 * u + lane;
      gg[u] = r < n ? gids[r] : 0;
    }
    const int64_t r_end = r0 + 32 * kRunRows;
    const int32_t before = lane == 0 && r0 > 0 ? gids[r0 - 1] : 0;
    const int32_t after = lane == 31 && r_end < n ? gids[r_end] : 0;
    // once a row breaks the order nothing here is read: stop (this also
    // keeps unordered rows from storing run ends into a few hot words)
    if (__any_sync(0xffffffffu, lane == 0 && *(volatile const int32_t*)verdict != 0)) break;
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
      if (r < n) bad |= gg[u] < 0 || (int64_t)gg[u] >= groups || (r > 0 && gg[u] < prev[u]);
    }
    if (__any_sync(0xffffffffu, bad)) {
      if (lane == 0) set_atomic_path(verdict);
      break;
    }
#pragma unroll
    for (int u = 0; u < kRunRows; ++u) {
      const int64_t r = r0 + 32 * u + lane;
      const bool head = r == 0 || prev[u] != gg[u], tail = r + 1 == n || next[u] != gg[u];
      if (r >= n || !(head || tail)) continue;  // inside a group's run: no division
      const int32_t w = gg[u] / cap;
      if (r == 0 || (head && prev[u] / cap != w)) first[w] = r + 1;
      if (r + 1 == n || (tail && next[u] / cap != w)) last[w] = r + 1;
    }
  }
}

// A warp step of the run pass with 16 B loads: 32 * kRunRows rows from
// r0, a lane holding 4 consecutive rows of each 128-row part, with the
// rows just before and after the step and the verdict as read beside them.
struct RunStep {
  static constexpr int kV = kRunRows / 4;  // 128-row parts a step
  int32_t g[kV][4];
  int32_t before, after, seen;

  __device__ __forceinline__ void load(const int32_t* gids, int64_t n, int64_t r0, int lane,
                                       const int32_t* verdict) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int64_t r = r0 + 128 * v + 4 * lane;
      if (r + 3 < n) {
        const int4 q = *(const int4*)(gids + r);
        g[v][0] = q.x;
        g[v][1] = q.y;
        g[v][2] = q.z;
        g[v][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[v][j] = r + j < n ? gids[r + j] : 0;
      }
    }
    const int64_t r_end = r0 + 32 * kRunRows;
    before = lane == 0 && r0 > 0 && r0 <= n ? gids[r0 - 1] : 0;
    after = lane == 31 && r_end < n ? gids[r_end] : 0;
    seen = lane == 0 ? *(volatile const int32_t*)verdict : 0;
  }
};

// The run pass for gids on a 16 B boundary: the same walk as run_pass,
// the next step's rows loaded while this one's are checked.  A lane whose
// 4 rows are neither the first nor the last row checks their order with
// three compares and their range at its ends, and has nothing to store
// when they equal the rows on either side (inside a group's run); any
// other lane takes the rows one by one.
__device__ __forceinline__ void run_pass_vec(const int32_t* gids, int64_t n, int64_t groups,
                                             int32_t cap, int32_t* verdict, int64_t* first,
                                             int64_t* last) {
  constexpr int kV = RunStep::kV;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kRunRows;
  int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * kRunRows;
  RunStep cur, nxt;
  cur.load(gids, n, r0, lane, verdict);
  for (; r0 < n; r0 += stride) {
    // once a row breaks the order nothing here is read: stop (this also
    // keeps unordered rows from storing run ends into a few hot words)
    if (__any_sync(0xffffffffu, cur.seen != 0)) break;
    nxt.load(gids, n, r0 + stride, lane, verdict);
    // the rows before a lane's first and after its last of each part
    int32_t up[kV], down[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      up[v] = __shfl_up_sync(0xffffffffu, cur.g[v][3], 1);
      down[v] = __shfl_down_sync(0xffffffffu, cur.g[v][0], 1);
      const int32_t last_of_prev = __shfl_sync(0xffffffffu, cur.g[v > 0 ? v - 1 : 0][3], 31);
      const int32_t first_of_next =
          __shfl_sync(0xffffffffu, cur.g[v + 1 < kV ? v + 1 : v][0], 0);
      if (lane == 0) up[v] = v > 0 ? last_of_prev : cur.before;
      if (lane == 31) down[v] = v + 1 < kV ? first_of_next : cur.after;
    }
    bool bad = false, inner[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int64_t rs = r0 + 128 * v + 4 * lane;
      inner[v] = rs > 0 && rs + 4 < n;
      if (inner[v]) {
        const int32_t g0 = cur.g[v][0], g1 = cur.g[v][1], g2 = cur.g[v][2], g3 = cur.g[v][3];
        bad |= up[v] > g0 || g0 > g1 || g1 > g2 || g2 > g3 || g0 < 0 || (int64_t)g3 >= groups;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t r = rs + j;
          const int32_t gv = cur.g[v][j], prev = j > 0 ? cur.g[v][j - 1] : up[v];
          if (r < n) bad |= gv < 0 || (int64_t)gv >= groups || (r > 0 && gv < prev);
        }
      }
    }
    if (__any_sync(0xffffffffu, bad)) {
      if (lane == 0) set_atomic_path(verdict);
      break;
    }
    // a lane's four rows all inside a group's run have nothing to store
    bool quiet[kV], stores = false;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      quiet[v] = inner[v] && up[v] == cur.g[v][3] && cur.g[v][3] == down[v];
      stores |= !quiet[v];
    }
    // cur.seen was read a step ahead: a warp with run ends to store reads
    // the verdict again first, so that rows out of order (a run end in
    // every step) stop before they store into a few hot words
    if (__any_sync(0xffffffffu, stores) &&
        __any_sync(0xffffffffu, lane == 0 && *(volatile const int32_t*)verdict != 0)) {
      break;
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      if (quiet[v]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t r = r0 + 128 * v + 4 * lane + j;
        const int32_t gv = cur.g[v][j];
        const int32_t prev = j > 0 ? cur.g[v][j - 1] : up[v];
        const int32_t next = j < 3 ? cur.g[v][j + 1] : down[v];
        const bool head = r == 0 || prev != gv, tail = r + 1 == n || next != gv;
        if (r >= n || !(head || tail)) continue;  // inside a group's run: no division
        const int32_t w = gv / cap;
        if (r == 0 || (head && prev / cap != w)) first[w] = r + 1;
        if (r + 1 == n || (tail && next / cap != w)) last[w] = r + 1;
      }
    }
    cur = nxt;
  }
}

// The run pass, 16 B loads where the gids allow them.
__device__ __forceinline__ void run_pass_any(const int32_t* gids, int64_t n, int64_t groups,
                                             int32_t cap, int32_t* verdict, int64_t* first,
                                             int64_t* last) {
  if (((uintptr_t)gids & 15) == 0) {
    run_pass_vec(gids, n, groups, cap, verdict, first, last);
  } else {
    run_pass(gids, n, groups, cap, verdict, first, last);
  }
}

// A Gate read once a block (gate_shut, common.cuh, read by every thread,
// puts every thread's load on the one line that holds the verdict).
__device__ __forceinline__ bool block_gate_shut(const Gate& g) {
  __shared__ int shut;
  if (threadIdx.x == 0) shut = gate_shut(g);
  __syncthreads();
  return shut != 0;
}

// A window's rows: [first, last] (first > last when it has none).
__device__ __forceinline__ void window_rows(const int64_t* windows, int64_t n_windows, int64_t w,
                                            int64_t& f, int64_t& l) {
  f = windows[w] - 1;
  l = windows[n_windows + w] - 1;
  if (f < 0) l = -2;
}

// What block b of the owner launch builds: window w from rows [lo, hi)
// (empty for a helper with nothing to take: it returns false), an owner
// (b < n_windows) into the output, a helper into its scratch row.
struct BlockRows {
  int64_t w, lo, hi;
  bool owner;
};

__device__ __forceinline__ bool block_rows(int64_t b, const int32_t* gids, const int64_t* windows,
                                           int64_t n_windows, int64_t tile_rows, int32_t cap,
                                           BlockRows& out) {
  int64_t f, l;
  if (b < n_windows) {  // the owner of window b
    window_rows(windows, n_windows, b, f, l);
    out.w = b;
    out.lo = f < 0 ? 0 : f;
    out.hi = f < 0 ? 0 : min64(f + tile_rows, l + 1);
    out.owner = true;
    return true;
  }
  // a helper: the extra part of the window holding its tile's first row
  // (none for a gid off the table: K21 reads this beside the verdict,
  // before it knows the gids are in order)
  const int64_t hs = (b - n_windows) * tile_rows;
  out.w = gids[hs] / cap;
  if (out.w < 0 || out.w >= n_windows) return false;
  window_rows(windows, n_windows, out.w, f, l);
  out.lo = max64(hs, f + tile_rows);
  out.hi = min64(hs + tile_rows, l + 1);
  out.owner = false;
  return out.lo < out.hi;
}

// Zero `width` ints of shared memory (16 B at a time with vec).
__device__ __forceinline__ void zero_row(int32_t* srow, int64_t width, bool vec) {
  const int64_t w4 = vec ? width / 4 : 0;
  int4* s4 = (int4*)srow;
  for (int64_t i = threadIdx.x; i < w4; i += blockDim.x) s4[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = 4 * w4 + threadIdx.x; i < width; i += blockDim.x) srow[i] = 0;
}

// Store `width` ints of shared memory to dst (16 B at a time with vec).
__device__ __forceinline__ void store_row(const int32_t* srow, int64_t width, int32_t* dst,
                                          bool vec) {
  const int64_t w4 = vec ? width / 4 : 0;
  const int4* s4 = (const int4*)srow;
  int4* d4 = (int4*)dst;
  for (int64_t i = threadIdx.x; i < w4; i += blockDim.x) d4[i] = s4[i];
  for (int64_t i = 4 * w4 + threadIdx.x; i < width; i += blockDim.x) dst[i] = srow[i];
}

// A fold's operator, and how it updates the owner's stored row.
struct FoldMax {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const { return max(a, b); }
  __device__ __forceinline__ void update(int32_t* p, int32_t v) const { *p = max(*p, v); }
};
struct FoldAdd {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
  __device__ __forceinline__ void update(int32_t* p, int32_t v) const { *p += v; }
};
// + where other adds reach the row in the same launch
struct FoldAddAtomic : FoldAdd {
  __device__ __forceinline__ void update(int32_t* p, int32_t v) const { atomicAdd(p, v); }
};

// The windows longer than tile_rows: the owner's row in out combined with
// every helper's partial, helper tile h (this block) folding its share of
// the columns.  `per_group` ints a group; `part` is kFoldThreads int4 of
// shared memory.
template <int kFoldThreads, typename Op>
__device__ __forceinline__ void fold_window(const int32_t* gids, const int64_t* windows,
                                            int64_t n_windows, int64_t tile_rows, int32_t cap,
                                            int64_t groups, int64_t per_group,
                                            const int32_t* scratch, int64_t stride, int32_t* out,
                                            int4* part, Op op) {
  const int64_t h = blockIdx.x;
  const int64_t hs = h * tile_rows;
  const int64_t w = gids[hs] / cap;
  int64_t f, l;
  window_rows(windows, n_windows, w, f, l);
  if (max64(hs, f + tile_rows) >= min64(hs + tile_rows, l + 1)) return;  // not a helper
  const int64_t h0 = (f + tile_rows) / tile_rows, h1 = l / tile_rows;
  const int64_t ga = w * cap;
  const int64_t width = min64(cap, groups - ga) * per_group;
  const int64_t width4 = (width + 3) / 4;
  const int64_t per = (width4 + (h1 - h0)) / (h1 - h0 + 1);
  const int64_t c_lo = (h - h0) * per, c_hi = min64(width4, c_lo + per);
  // lanes: `cl` columns of 16 bytes x `hl` helpers, cl a power of two
  int cl = 1;
  while (cl < 32 && cl < per) cl <<= 1;
  const int hl = kFoldThreads / cl;
  const int col = threadIdx.x % cl, hlane = threadIdx.x / cl;
  const int4* sc = (const int4*)scratch;
  const int64_t stride4 = stride / 4;
  int32_t* dst = out + ga * per_group;
  for (int64_t c0 = c_lo; c0 < c_hi; c0 += cl) {
    const int64_t c = c0 + col;
    int4 acc = make_int4(0, 0, 0, 0);
    if (c < c_hi) {
#pragma unroll 4
      for (int64_t hh = h0 + hlane; hh <= h1; hh += hl) {
        const int4 v = __ldcg(sc + hh * stride4 + c);
        acc.x = op(acc.x, v.x);
        acc.y = op(acc.y, v.y);
        acc.z = op(acc.z, v.z);
        acc.w = op(acc.w, v.w);
      }
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    if (hlane == 0 && c < c_hi) {
      for (int j = 1; j < hl; ++j) {
        const int4 v = part[j * cl + col];
        acc.x = op(acc.x, v.x);
        acc.y = op(acc.y, v.y);
        acc.z = op(acc.z, v.z);
        acc.w = op(acc.w, v.w);
      }
      const int32_t got[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int j = 0; j < 4 && 4 * c + j < width; ++j) op.update(dst + 4 * c + j, got[j]);
    }
    __syncthreads();
  }
}

// Blocks of a grid-stride kernel over `items`, capped at the card's
// resident CTAs (kCapBlocks).
static inline int run_grid(int64_t items, int threads) {
  const int64_t want = (items + threads - 1) / threads;
  return (int)(want < 1 ? 1 : (want < kCapBlocks ? want : kCapBlocks));
}

// Blocks of the run pass over n rows (kRunThreads threads each).
static inline int run_pass_grid(int64_t n) {
  const int64_t step = (int64_t)kRunThreads * kRunRows;
  const int64_t want = (n + step - 1) / step;
  const int64_t cap = 132 * kRunCtasPerSm;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

// Lets an owner kernel take `bytes` of dynamic shared memory past 48 KB,
// once a device.
template <typename K>
static inline void allow_smem(K kernel, bool* allowed, int bytes) {
  int dev = -1;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
}
