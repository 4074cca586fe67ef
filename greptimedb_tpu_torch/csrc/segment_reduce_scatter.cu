// K3 segment_reduce_scatter: sum / count / min / max per group for any id
// order (shuffled ids, unclustered layouts, scans under 2^16 rows, the
// hash group-by's slot ids).
//
// Replaces greptimedb_tpu/ops/aggregate.py:598 `_segment_scatter` (XLA
// segment_sum/min/max with an overflow slot G for masked rows).
//
// Bound on the H100: bytes — the ids (4 B), mask (1 B) and values (8 B per
// column) of every row once, the [C, G] outputs once, plus the index
// plumbing below.  A scatter with f64 atomicAdd would be faster but adds
// in a different order on every run; this kernel is deterministic
// instead.  The caller sorts the masked ids stably with the flag-reading
// radix sort of csrc/segment_sort.cu (index plumbing: rows of one group
// end up in one run, in row order).  Behind K2's guard every launch here
// is predicated on the guard's flag (Gate): it runs only when the guard
// failed.
//
// The order of the adds is fixed by the data alone: lane l of a warp folds
// the run's positions start + l, start + l + 32, ... in order, from
// s = 0.0, mn = +inf, mx = -inf, and warp_sum / warp_min / warp_max
// (common.cuh) combine the lanes.  Within that order the kernel reads each
// run position's row (`perm`, 8 B) once for all of a launch's columns: a
// warp walks a run in passes of P positions a lane, loads the pass's
// rows, then for each column loads the pass's values (every load of a
// pass before any add, so P gathers are in flight a lane) and folds them
// into the lane's partials, which wait in shared memory between passes.
// Column pointers ride in the arguments (up to kMaxCols a launch; more
// columns run as further launches).
//
// One launch a call.  A CTA takes a contiguous share of tiles of groups,
// carrying the position where the next tile's runs begin, and per tile
// finds where each group's run starts and ends:
//   - dense ids (G <= n / 32; tiles of 4-128 groups, sized at the launch so
//     that the tiles outnumber the CTAs): a warp search finds the tile's
//     end, then each thread one group's start by an 8-ary search inside
//     the tile;
//   - sparse ids (a hash plan's slot ids, host x minute buckets; tiles of
//     kSparseTile groups): the CTA reads the tile's sorted ids once, 1024
//     a step, and marks where runs start and end.
// Then every empty group's identities are written once (no pass over all
// of [C, G] first), and the tile's runs go on two lists that every thread
// and warp share: a run of up to kShortRun rows (kSparseShortRun on sparse
// ids) is folded by one thread through the same tree (its lanes past the
// run hold the identities, so the tree's upper levels add +0.0, the
// identity of a sum that is never -0.0, and the thread skips them), a
// longer run by a warp.  The grid is capped at the CTAs the card holds at
// once, so a launch whose gate is shut costs one wave.
#include <limits.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxCols = 32;       // columns a launch (ops/aggregate.py _K3_MAX_COLS)
constexpr int kThreads = 128;      // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kDenseTileMax = 128;  // groups a dense tile at most (one search a thread)
constexpr int kSparseTile = 1024;  // groups a sparse tile
constexpr int kShortRun = 8;       // the longest run one thread folds (an 8-leaf tree)
constexpr int kShortLevels = 3;
constexpr int kSparseShortRun = 16;  // and on sparse ids (runs of 9 to 16: a 16-leaf tree)
constexpr int kSparseShortLevels = 4;
constexpr int kDensePos = 16;      // run positions a lane holds a pass, dense ids
constexpr int kSparsePos = 8;      // and sparse ids (short runs, CTAs that take many tiles)
constexpr int kMinBlocks = 4;      // CTAs an SM holds at least (caps the registers)
constexpr int kRunWarps = kWarps;  // warps of a CTA that walk its tiles' long runs
constexpr int kTilesPerCta = 2;    // dense tiles at least, for each CTA the card holds
constexpr int kPrewriteBelow = 1;  // sparse ids write every identity first when n < this x G
static_assert(1 << kShortLevels == kShortRun && 1 << kSparseShortLevels == kSparseShortRun,
              "a short run's tree is a full binary tree");
constexpr int kMaxDevices = 16;    // devices whose kernels opted in to kMaxCols' partials

struct ScatterArgs {
  int64_t n;
  const int32_t* skeys;              // [n] sorted ids; masked rows carry G
  const int64_t* perm;               // [n] row of each sorted id
  const double* values[kMaxCols];
  const uint8_t* masks[kMaxCols];    // nullptr = the base mask
  double* sums;                      // [n_cols, G] or nullptr
  int32_t* counts;
  double* mins;
  double* maxs;
  int32_t num_groups;
  int32_t n_cols;
  int32_t tile_groups;               // groups a tile: set by the entry point
  int32_t prewrite;                  // sparse: identities first (entry point: n < G)
  Gate gate;                         // behind K2's or K6's guard: runs when it failed
};

// A warp's lane partials in shared memory: [column][lane] of each.
struct Partials {
  double* s;
  double* mn;
  double* mx;
  int32_t* cnt;
};

__device__ __forceinline__ Partials warp_partials(unsigned char* smem, int warp, int n_cols) {
  const int per = n_cols * 32;
  double* base = (double*)smem + (size_t)warp * per * 3;
  Partials p;
  p.s = base;
  p.mn = base + per;
  p.mx = base + 2 * per;
  p.cnt = (int32_t*)((double*)smem + (size_t)kWarps * per * 3) + (size_t)warp * per;
  return p;
}

// the dynamic shared memory of a CTA's partials at n_cols columns
constexpr size_t partials_bytes(int n_cols) {
  return (size_t)kWarps * n_cols * 32 * (3 * sizeof(double) + sizeof(int32_t));
}

__device__ __forceinline__ void write_state(const ScatterArgs& a, int c, int64_t g, double s,
                                            int32_t cnt, double mn, double mx) {
  const int64_t o = (int64_t)c * a.num_groups + g;
  if (a.sums != nullptr) a.sums[o] = s;
  if (a.counts != nullptr) a.counts[o] = cnt;
  if (a.mins != nullptr) a.mins[o] = mn;
  if (a.maxs != nullptr) a.maxs[o] = mx;
}

// One warp reduces the run [start, end) of group g into every column.
template <int P>
__device__ void walk_run(const ScatterArgs& a, const Partials& p, int64_t g, int64_t start,
                         int64_t end, int lane) {
  const int C = a.n_cols;
  for (int c = 0; c < C; ++c) {
    p.s[c * 32 + lane] = 0.0;
    p.mn[c * 32 + lane] = INFINITY;
    p.mx[c * 32 + lane] = -INFINITY;
    p.cnt[c * 32 + lane] = 0;
  }
  for (int64_t base = start; base < end; base += 32 * P) {
    int32_t r[P];  // rows (n < 2^31)
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int64_t j = base + lane + 32 * k;
      r[k] = j < end ? (int32_t)a.perm[j] : -1;
    }
    for (int c = 0; c < C; ++c) {
      const double* v = a.values[c];
      const uint8_t* cm = a.masks[c];
      double x[P];
      bool on[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        on[k] = r[k] >= 0;
        x[k] = on[k] ? v[r[k]] : 0.0;
      }
      if (cm != nullptr) {
#pragma unroll
        for (int k = 0; k < P; ++k) on[k] = on[k] && cm[r[k]] != 0;
      }
      double s = p.s[c * 32 + lane], mn = p.mn[c * 32 + lane], mx = p.mx[c * 32 + lane];
      int32_t cnt = p.cnt[c * 32 + lane];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (!on[k]) continue;
        s += x[k];
        cnt += 1;
        mn = nan_min(mn, x[k]);
        mx = nan_max(mx, x[k]);
      }
      p.s[c * 32 + lane] = s;
      p.mn[c * 32 + lane] = mn;
      p.mx[c * 32 + lane] = mx;
      p.cnt[c * 32 + lane] = cnt;
    }
  }
  for (int c = 0; c < C; ++c) {
    const double s = warp_sum(p.s[c * 32 + lane]);
    const int32_t cnt = warp_sum_i(p.cnt[c * 32 + lane]);
    const double mn = warp_min(p.mn[c * 32 + lane]);
    const double mx = warp_max(p.mx[c * 32 + lane]);
    if (lane == 0) write_state(a, c, g, s, cnt, mn, mx);
  }
}

// One thread reduces a run of 1 <= len <= L rows.  Leaf l is what
// lane l of walk_run holds after its one position (0.0 + x, or the
// identity where the row is masked or l >= len); the tree is warp_sum's
// below level L / 2 (node l takes node l + o, l < o), whose upper
// levels add identities only.  Each aggregate's tree runs on its own, so
// only the values stay live across them.
template <int L, int kLevels>
__device__ void fold_short(const ScatterArgs& a, int64_t g, int64_t start, int len) {
  int32_t r[L];  // rows (n < 2^31)
#pragma unroll
  for (int k = 0; k < L; ++k) r[k] = k < len ? (int32_t)a.perm[start + k] : -1;
  for (int c = 0; c < a.n_cols; ++c) {
    const double* v = a.values[c];
    const uint8_t* cm = a.masks[c];
    double x[L];
    bool on[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      on[k] = r[k] >= 0;
      x[k] = on[k] ? v[r[k]] : 0.0;
    }
    if (cm != nullptr) {
#pragma unroll
      for (int k = 0; k < L; ++k) on[k] = on[k] && cm[r[k]] != 0;
    }
    double t[L];
    int32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      t[k] = 0.0;
      if (on[k]) t[k] += x[k];
      cnt += on[k] ? 1 : 0;
    }
#pragma unroll
    for (int level = 1; level <= kLevels; ++level) {
      const int o = L >> level;
#pragma unroll
      for (int l = 0; l < L / 2; ++l) {
        if (l < o) t[l] += t[l + o];
      }
    }
    const double s = t[0];
#pragma unroll
    for (int k = 0; k < L; ++k) t[k] = on[k] ? nan_min(INFINITY, x[k]) : INFINITY;
#pragma unroll
    for (int level = 1; level <= kLevels; ++level) {
      const int o = L >> level;
#pragma unroll
      for (int l = 0; l < L / 2; ++l) {
        if (l < o) t[l] = nan_min(t[l], t[l + o]);
      }
    }
    const double mn = t[0];
#pragma unroll
    for (int k = 0; k < L; ++k) t[k] = on[k] ? nan_max(-INFINITY, x[k]) : -INFINITY;
#pragma unroll
    for (int level = 1; level <= kLevels; ++level) {
      const int o = L >> level;
#pragma unroll
      for (int l = 0; l < L / 2; ++l) {
        if (l < o) t[l] = nan_max(t[l], t[l + o]);
      }
    }
    write_state(a, c, g, s, cnt, mn, t[0]);
  }
}

// lower_bound(key) in [lo, hi) (first index i with a[i] >= key, hi if
// none) in every lane: the warp narrows [lo, hi] 32-fold a round.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* a, int64_t lo, int64_t hi,
                                                    int64_t key, int lane) {
  while (hi > lo) {  // uniform: every lane holds the same lo and hi
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + (int64_t)(lane + 1) * step - 1;
    const bool less = probe < hi && (int64_t)a[probe] < key;
    const int64_t k = __popc(__ballot_sync(0xffffffffu, less));
    const int64_t next = lo + (k + 1) * step - 1;  // the first probe not below key
    if (k < 32 && next < hi) hi = next;
    lo += k * step;
  }
  return lo;
}

// lower_bound(key) inside [lo, hi) for one thread: 7 probes a round, all
// loaded before any is compared.
__device__ __forceinline__ int64_t lower_bound8(const int32_t* a, int64_t lo, int64_t hi,
                                                int64_t key) {
  while (hi > lo) {
    const int64_t step = (hi - lo + 7) / 8;
    int32_t probe[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int64_t q = lo + (int64_t)(i + 1) * step - 1;
      probe[i] = q < hi ? a[q] : INT_MAX;
    }
    int64_t k = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) k += (int64_t)probe[i] < key ? 1 : 0;
    const int64_t next = lo + (k + 1) * step - 1;
    if (k < 7 && next < hi) hi = next;
    lo += k * step;
  }
  return lo;
}

struct TileTables {
  int32_t start[kSparseTile];  // each group's run [start, end) of sorted positions
  int32_t end[kSparseTile];
  int16_t shorts[kSparseTile];  // the tile's groups whose runs one thread folds
  int16_t longs[kSparseTile];   // and with longer runs, in no order
  int64_t p1;                   // the tile's end
  int32_t n_short;
  int32_t n_long;
};

// Where each group of the tile [g0, g0 + ng) has its run, from p0 (the
// first position of the tile): dense, a search a group; sparse, one read
// of the tile's ids.  Returns the tile's end (the next tile's p0).
template <bool kDense>
__device__ int64_t find_runs(const ScatterArgs& a, TileTables& tt, int64_t g0, int ng,
                             int64_t p0) {
  const int t = threadIdx.x;
  const int64_t gend = g0 + ng;
  if constexpr (kDense) {
    if (t < 32) {
      const int64_t p1 = warp_lower_bound(a.skeys, p0, a.n, gend, t);
      if (t == 0) tt.p1 = p1;
    }
    __syncthreads();
    const int64_t p1 = tt.p1;
    for (int lg = t; lg < ng; lg += kThreads) {
      tt.start[lg] = (int32_t)(lg == 0 ? p0 : lower_bound8(a.skeys, p0, p1, g0 + lg));
    }
    __syncthreads();
    for (int lg = t; lg < ng; lg += kThreads) {
      tt.end[lg] = lg + 1 < ng ? tt.start[lg + 1] : (int32_t)p1;
    }
    __syncthreads();
    return p1;
  } else {
    for (int lg = t; lg < ng; lg += kThreads) {
      tt.start[lg] = 0;
      tt.end[lg] = 0;
    }
    if (t == 0) tt.p1 = LLONG_MAX;
    __syncthreads();
    // 8 consecutive positions a thread, with a neighbour on each side, 1024
    // a step until a key >= gend shows the tile's end (past n every key
    // counts as >= gend)
    for (int64_t step = p0;; step += kThreads * 8) {
      const int64_t base = step + (int64_t)t * 8;
      int32_t k[10];
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        const int64_t j = base - 1 + q;
        k[q] = j < p0 ? -1 : j < a.n ? a.skeys[j] : INT_MAX;
      }
      int in = 0;
#pragma unroll
      for (int q = 1; q <= 8; ++q) {
        if ((int64_t)k[q] >= gend) continue;  // sorted: every later key is past the tile too
        ++in;
        const int64_t j = base - 1 + q;
        if (k[q - 1] != k[q]) tt.start[k[q] - g0] = (int32_t)j;
        if (k[q + 1] != k[q]) tt.end[k[q] - g0] = (int32_t)(j + 1);
      }
      // the one thread whose positions hold the first key >= gend (or whose
      // first position is it) writes the tile's end
      if (in < 8 && (in > 0 || (int64_t)k[0] < gend)) tt.p1 = base + in;
      __syncthreads();
      const int64_t p1 = tt.p1;
      if (p1 != LLONG_MAX) {
        __syncthreads();  // every thread has read p1 before the next tile resets it
        return p1;
      }
    }
  }
}

// Appends lg to list[] where `on`: the warp's lanes take consecutive
// places, reserved by one shared atomic (`full`: every lane of the warp is
// in this loop round, else each lane appends alone).
__device__ __forceinline__ void append(int16_t* list, int32_t* count, bool on, int lg, int lane,
                                       bool full) {
  if (!full) {
    if (on) list[atomicAdd(count, 1)] = (int16_t)lg;
    return;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (mask == 0u) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (on) list[base + __popc(mask & ((1u << lane) - 1u))] = (int16_t)lg;
}

// A CTA takes a contiguous share of the tiles; per tile: its runs, the
// empty groups' identities (a thread a group), then the runs from two
// lists, so that every thread and warp has its share of them: the short
// runs a thread a run, the longer a warp a run.
template <bool kDense, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scatter_kernel(
    const __grid_constant__ ScatterArgs a) {
  if (gate_shut(a.gate)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ TileTables tt;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const Partials parts = warp_partials(smem, warp, a.n_cols);
  const int64_t G = a.num_groups;
  const int tg = a.tile_groups;
  const int64_t tiles = (G + tg - 1) / tg;
  const int64_t share = (tiles + gridDim.x - 1) / gridDim.x;
  const int64_t first = (int64_t)blockIdx.x * share;
  const int64_t last = first + share < tiles ? first + share : tiles;
  if (first >= last) return;
  if (t < 32) {
    const int64_t p0 = warp_lower_bound(a.skeys, 0, a.n, first * tg, t);
    if (t == 0) {
      tt.p1 = p0;
      tt.n_short = 0;
      tt.n_long = 0;
    }
  }
  __syncthreads();
  int64_t p0 = tt.p1;
  __syncthreads();
  for (int64_t tile = first; tile < last; ++tile) {
    const int64_t g0 = tile * tg;
    const int ng = (int)(G - g0 < tg ? G - g0 : tg);
    constexpr int thread_run = kDense ? kShortRun : kSparseShortRun;
    // where most groups are empty, the identities go out before the tile's
    // ids are read, and the occupied groups' results overwrite theirs
    const bool prewrite = !kDense && a.prewrite;
    if (prewrite) {
      for (int lg = t; lg < ng; lg += kThreads) {
        for (int c = 0; c < a.n_cols; ++c) write_state(a, c, g0 + lg, 0.0, 0, INFINITY, -INFINITY);
      }
    }
    const int64_t p1 = find_runs<kDense>(a, tt, g0, ng, p0);
    for (int lg = t; lg < ng; lg += kThreads) {
      const int len = tt.end[lg] - tt.start[lg];
      if (len == 0 && !prewrite) {
        for (int c = 0; c < a.n_cols; ++c) write_state(a, c, g0 + lg, 0.0, 0, INFINITY, -INFINITY);
      }
      // onto the lists, one shared atomic a warp and list
      const bool full = lg - lane + 32 <= ng;  // every lane of the warp is in this round
      append(tt.shorts, &tt.n_short, len > 0 && len <= thread_run, lg, lane, full);
      append(tt.longs, &tt.n_long, len > thread_run, lg, lane, full);
    }
    __syncthreads();
    const int n_short = tt.n_short, n_long = tt.n_long;
    for (int i = t; i < n_short; i += kThreads) {
      const int lg = tt.shorts[i];
      const int len = tt.end[lg] - tt.start[lg];
      if constexpr (!kDense) {
        if (len > kShortRun) {
          fold_short<kSparseShortRun, kSparseShortLevels>(a, g0 + lg, tt.start[lg], len);
          continue;
        }
      }
      fold_short<kShortRun, kShortLevels>(a, g0 + lg, tt.start[lg], len);
    }
    if (warp < kRunWarps) {
      for (int i = warp; i < n_long; i += kRunWarps) {
        const int lg = tt.longs[i];
        walk_run<P>(a, parts, g0 + lg, tt.start[lg], tt.end[lg], lane);
      }
    }
    __syncthreads();  // the tables are the next tile's
    if (t == 0) {
      tt.n_short = 0;
      tt.n_long = 0;
    }
    p0 = p1;
  }
}

// CTAs the card holds at once of each kernel at each column count, found
// at the first launch of that count
template <bool kDense, int P>
static int resident_ctas(int n_cols) {
  static int cache[kMaxCols + 1];
  int& r = cache[n_cols];
  if (r == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_kernel<kDense, P>, kThreads,
                                                  partials_bytes(n_cols));
    r = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return r;
}

template <bool kDense, int P>
static int launch(ScatterArgs a, cudaStream_t s) {
  // past 48 KB of dynamic shared memory (C > 13) a kernel must opt in, once
  // per device
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(scatter_kernel<kDense, P>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)partials_bytes(kMaxCols));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int64_t G = a.num_groups;
  const int cap = resident_ctas<kDense, P>(a.n_cols);
  // dense tiles: the largest power of two in [kWarps, kDenseTileMax] that
  // leaves kTilesPerCta tiles a resident CTA (a warp a group where groups
  // are few)
  int tg = kDenseTileMax;
  while (tg > kWarps && G / tg < kTilesPerCta * (int64_t)cap) tg >>= 1;
  a.tile_groups = kDense ? tg : kSparseTile;
  a.prewrite = a.n < kPrewriteBelow * G;
  const int64_t tiles = (G + a.tile_groups - 1) / a.tile_groups;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  scatter_kernel<kDense, P><<<grid, kThreads, partials_bytes(a.n_cols), s>>>(a);
  return (int)cudaGetLastError();
}

// Dense ids (G <= n / 32) take the dense tiles, sparse ids the sparse ones.
GT_EXPORT int gt_scatter_reduce(const ScatterArgs* args, void* stream) {
  const ScatterArgs& a = *args;
  const int64_t G = a.num_groups, n = a.n;
  if (a.n_cols <= 0 || a.n_cols > kMaxCols || n < 0 || n >= (1LL << 31) || G < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  return G <= n / 32 ? launch<true, kDensePos>(a, s) : launch<false, kSparsePos>(a, s);
}
