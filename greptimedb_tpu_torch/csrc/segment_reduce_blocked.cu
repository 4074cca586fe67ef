// K2 segment_reduce_blocked: sum / count / min / max per group for C value
// columns whose masked rows are clustered, one CTA per 4096-row block.
//
// Replaces greptimedb_tpu/ops/aggregate.py:642 `_segment_blocked` and the
// layout guard of :511 `segment_aggregate` / :729 `segment_aggregate_multi`
// (per-block masked bmin/bmax, span < 16, ids in range), plus the windowed
// fold of :190 `windowed_slot_sum` / :206 `windowed_slot_reduce`.
//
// Bound on the H100: bytes.  Each row's id (4 B), base mask (1 B) and
// value (8 B per column) are read once; the [nb, C, 16] partials and the
// [C, G] states are small.  The TPU version built a [block, 4096, 16]
// one-hot for the vector unit; here each warp owns 512 consecutive rows of
// its block (a lane reads rows lane, lane + 32, ...: coalesced) and folds
// them into the slots of its block's window, so no one-hot and no scatter
// ever touches device memory.  A warp visits only the slots its own rows
// touch (on a clustered layout one or two of the 16), folds sum, count,
// min and max in one pass over its rows, and keeps its per-slot results in
// shared memory for a chunk of up to 8 columns: one barrier per chunk.
//
// Pass 1 (`blocked_partials_kernel`) keeps little per thread so that
// three CTAs fit an SM: a row's slot is its id less the warp's least id
// in four bit planes (a warp spanning 16 ids or more fails the guard
// anyway), so a slot's rows are four mask operations away; one column's
// 16 values are live at a time; a slot's count is a popcount, and NaN is
// a flag beside a plain min and max.  The ids and the mask are loaded
// together, and the first column's values as soon as they are in, before
// the block's guard is decided; a failing block's wasted reads are
// harmless.  Thread 0 writes the block's base (= min(bmin, G); an
// all-masked block gets the overflow slot G) and occupied slots, then the
// block layout (block_layout.cuh) is finished by the last CTA: the verdict
// word (no memset: it is written, not ORed into) and the fold's keys.  A
// failing block stops before its first column's use.  No host reads the
// verdict: the fold and the scatter branch (the flag-reading sort and K3)
// are all launched, each predicated on the word (Gate in common.cuh), so a
// CUDA graph can hold the whole choice.  Column pointers ride in the
// argument struct (no descriptor table to upload), up to kMaxCols a launch.
// Pass 2 (`blocked_fold_kernel`) folds the partials into [C, G]: each
// (column, group) thread, or warp where the groups are few against the
// blocks, adds the blocks whose window holds its group in BLOCK ORDER, as
// the reference's scatter does (block_layout.cuh), with no sort of the
// bases.
//
// Determinism: no atomics on values.  Within a warp every lane adds its
// rows in row order and a fixed shuffle tree combines the lanes; the
// block combines its warps in warp order and the fold adds the blocks in
// block order, so the same input gives the same bytes on every run.
#include "block_layout.cuh"

constexpr int kMaxCols = 32;

// Mirrored field for field by _BlockedArgs in ops/aggregate.py (ctypes).
struct BlockedArgs {
  int64_t n;
  const int32_t* gids;
  const uint8_t* base_mask;
  const double* values[kMaxCols];
  const uint8_t* masks[kMaxCols];  // nullptr: the base mask
  BlockLayout layout;              // base, occ, keys, verdict, mode
  double* psum;                    // [nb, C, kSpan] or nullptr
  int32_t* pcnt;
  double* pmin;
  double* pmax;
  int32_t n_cols;
  int32_t reserved;
};

// Mirrored field for field by _FoldArgs in ops/aggregate.py (ctypes).
struct FoldArgs {
  BlockLayout layout;
  const double* psum;
  const int32_t* pcnt;
  const double* pmin;
  const double* pmax;
  double* sums;  // [C, G] or nullptr
  int32_t* counts;
  double* mins;
  double* maxs;
  int32_t n_cols;
  int32_t reserved;
  Gate gate;  // runs when the guard passed
};

constexpr int kWarps = kBlockThreads / 32;
// columns whose per-warp slot results share memory between two barriers
constexpr int kColChunk = 8;

// The values of column c at this thread's rows whose bit is set in
// `live` (the base mask), loaded together with the column-mask bytes;
// returns the rows in both masks as bits.
__device__ __forceinline__ uint32_t load_column(const BlockedArgs& a, int c, int64_t wrow0,
                                                uint32_t live, double (&x)[kRowsPerThread]) {
  const double* v = a.values[c];
  const uint8_t* cm = a.masks[c];
  uint8_t m[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = wrow0 + (int64_t)i * 32;
    const bool on = (live >> i) & 1u;
    x[i] = on ? v[r] : 0.0;
    m[i] = (on && cm != nullptr) ? cm[r] : (uint8_t)1;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) bits |= ((live >> i) & (m[i] != 0 ? 1u : 0u)) << i;
  return bits;
}

// min of the lanes' values by a fixed shuffle tree; no operand is NaN
// (the callers carry NaN as a flag)
__device__ __forceinline__ double warp_min_num(double v) {
  for (int o = 16; o > 0; o >>= 1) {
    const double y = __shfl_down_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  return v;
}
__device__ __forceinline__ double warp_max_num(double v) {
  for (int o = 16; o > 0; o >>= 1) {
    const double y = __shfl_down_sync(0xffffffffu, v, o);
    v = y > v ? y : v;
  }
  return v;
}

__global__ void __launch_bounds__(kBlockThreads, 3) blocked_partials_kernel(const BlockedArgs a) {
  const BlockLayout& L = a.layout;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int32_t s_lo[kWarps], s_hi[kWarps], s_bad[kWarps];
  __shared__ uint32_t s_wocc[kWarps];
  __shared__ int32_t s_base, s_ok;
  // per warp, column of the chunk and slot: sum, count, min, max; a warp
  // writes only the slots in its range [s_klo, s_khi]
  __shared__ double w_sum[kWarps][kColChunk][kSpan];
  __shared__ int32_t w_cnt[kWarps][kColChunk][kSpan];
  __shared__ double w_min[kWarps][kColChunk][kSpan];
  __shared__ double w_max[kWarps][kColChunk][kSpan];
  __shared__ int32_t s_klo[kWarps], s_khi[kWarps];

  // warp w owns rows [w * 512, (w + 1) * 512) of the block; lane l holds
  // rows l, l + 32, ... of them
  const int64_t wrow0 = row0 + (int64_t)warp * 32 * kRowsPerThread + lane;
  int32_t id[kRowsPerThread];
  uint8_t mk[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = wrow0 + (int64_t)i * 32;
    const bool in = r < a.n;
    mk[i] = in ? a.base_mask[r] : (uint8_t)0;
    id[i] = in ? a.gids[r] : 0;
  }
  uint32_t live = 0u;  // bit i: row i is masked in
  int32_t lo = 0x7fffffff, hi = -1, bad = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (mk[i] != 0) {
      live |= 1u << i;
      lo = min(lo, id[i]);
      hi = max(hi, id[i]);
      bad |= (id[i] < 0 || id[i] >= L.num_groups) ? 1 : 0;
    }
  }
  // every lane gets the warp's masked id range
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  bad = (int32_t)__reduce_or_sync(0xffffffffu, (unsigned)bad);
  // each row's id less the warp's least, 4 bits (exact while the warp
  // spans fewer than 16 ids; past that the block fails), kept as four bit
  // planes: bit i of plane k is bit k of row i's offset
  uint32_t plane[4] = {0u, 0u, 0u, 0u};
  uint32_t wocc = 0u;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const uint32_t d = ((uint32_t)id[i] - (uint32_t)lo) & 15u;
#pragma unroll
    for (int k = 0; k < 4; ++k) plane[k] |= ((d >> k) & 1u) << i;
    if ((live >> i) & 1u) wocc |= 1u << d;
  }
  wocc = __reduce_or_sync(0xffffffffu, wocc);
  // the first column's loads go out before the guard is decided
  double x[kRowsPerThread];
  uint32_t cbits = load_column(a, 0, wrow0, live, x);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_bad[warp] = bad;
    s_wocc[warp] = wocc;
  }
  __syncthreads();
  bool failed = false;
  if (t == 0) {
    int32_t blo = s_lo[0], bhi = s_hi[0], bbad = s_bad[0];
    for (int w = 1; w < kWarps; ++w) {
      blo = min(blo, s_lo[w]);
      bhi = max(bhi, s_hi[w]);
      bbad |= s_bad[w];
    }
    // empty block: -1 - INT32_MAX < span, as in the reference guard
    const bool ok = ((int64_t)bhi - (int64_t)blo) < kSpan && !bbad;
    const int32_t base = min(blo, L.num_groups);
    uint32_t occ = 0u;
    if (ok) {
      for (int w = 0; w < kWarps; ++w) {
        if (s_hi[w] >= 0) occ |= s_wocc[w] << (s_lo[w] - base);
      }
    }
    L.base[b] = base;
    L.occ[b] = occ;
    s_base = base;
    s_ok = ok ? 1 : 0;
    failed = !ok;
  }
  finish_layout(L, failed);  // starts with a barrier: s_base, s_ok visible
  if (!s_ok) return;
  const int32_t base = s_base;
  // the guard passed: every masked id lies in [base, base + 16); this
  // warp's rows in slots woff + rel, [klo, khi] (none: an empty range)
  const int woff = lo - base;
  const int klo = hi < 0 ? kSpan : woff;
  const int khi = hi < 0 ? -1 : hi - base;
  if (lane == 0) {
    s_klo[warp] = klo;
    s_khi[warp] = khi;
  }
  const bool w_s = a.psum != nullptr, w_c = a.pcnt != nullptr;
  const bool w_mn = a.pmin != nullptr, w_mx = a.pmax != nullptr;

  for (int c0 = 0; c0 < a.n_cols; c0 += kColChunk) {
    const int cc = min(kColChunk, a.n_cols - c0);
    for (int ci = 0; ci < cc; ++ci) {
      if (c0 + ci > 0) cbits = load_column(a, c0 + ci, wrow0, live, x);
      for (int j = klo; j <= khi; ++j) {  // warp-uniform
        // the rows in slot j: offset j - woff in the four planes
        const uint32_t rj = (uint32_t)(j - woff);
        uint32_t rows = cbits;
#pragma unroll
        for (int k = 0; k < 4; ++k) rows &= ((rj >> k) & 1u) ? plane[k] : ~plane[k];
        double s = 0.0, mn = kDblMax, mx = -kDblMax;
        bool nan = false;  // NaN wins min and max, as in XLA
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (!((rows >> i) & 1u)) continue;
          s += x[i];
          nan |= x[i] != x[i];
          mn = x[i] < mn ? x[i] : mn;
          mx = x[i] > mx ? x[i] : mx;
        }
        int32_t cnt = __popc(rows);
        if (w_s) s = warp_sum(s);
        if (w_c) cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (w_mn || w_mx) nan = __any_sync(0xffffffffu, nan);
        if (w_mn) mn = nan ? __longlong_as_double(0x7ff8000000000000LL) : warp_min_num(mn);
        if (w_mx) mx = nan ? __longlong_as_double(0x7ff8000000000000LL) : warp_max_num(mx);
        if (lane == 0) {
          w_sum[warp][ci][j] = s;
          w_cnt[warp][ci][j] = cnt;
          w_min[warp][ci][j] = mn;
          w_max[warp][ci][j] = mx;
        }
      }
    }
    __syncthreads();
    // one thread per (column of the chunk, slot): the warps in warp order
    if (t < cc * kSpan) {
      const int ci = t / kSpan, j = t % kSpan;
      double s = 0.0, mn = kDblMax, mx = -kDblMax;
      int32_t cnt = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (j < s_klo[w] || j > s_khi[w]) continue;
        s += w_sum[w][ci][j];
        cnt += w_cnt[w][ci][j];
        mn = nan_min(mn, w_min[w][ci][j]);
        mx = nan_max(mx, w_max[w][ci][j]);
      }
      const int64_t off = (b * a.n_cols + c0 + ci) * kSpan + j;
      if (w_s) a.psum[off] = s;
      if (w_c) a.pcnt[off] = cnt;
      if (w_mn) a.pmin[off] = mn;
      if (w_mx) a.pmax[off] = mx;
    }
    __syncthreads();
  }
}

struct BlockedPart {
  double s;
  int32_t c;
  double mn;
  double mx;
};

// grid (ceil(G / groups a CTA), C): a thread or a warp (fold_lanes) per
// (column, group)
__global__ void __launch_bounds__(256) blocked_fold_kernel(const FoldArgs a) {
  if (gate_shut(a.gate)) return;
  const BlockLayout& L = a.layout;
  const int64_t G = L.num_groups;
  const int lanes = fold_lanes(L.nb, G);
  const int64_t g = (int64_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int64_t c = blockIdx.y;
  if (g >= G) return;  // uniform per warp when a warp folds a group
  const int64_t C = a.n_cols;
  double s = 0.0, mn = kDblMax, mx = -kDblMax;
  int32_t cnt = 0;
  auto load = [&](int64_t blk, int slot) {
    const int64_t p = (blk * C + c) * kSpan + slot;
    BlockedPart v;
    v.s = a.psum != nullptr ? a.psum[p] : 0.0;
    v.c = a.pcnt != nullptr ? a.pcnt[p] : 0;
    v.mn = a.pmin != nullptr ? a.pmin[p] : kDblMax;
    v.mx = a.pmax != nullptr ? a.pmax[p] : -kDblMax;
    return v;
  };
  if (lanes == 1) {
    fold_blocks<4, BlockedPart>(L, g, load, [&](const BlockedPart& v) {
      s += v.s;
      cnt += v.c;
      mn = nan_min(mn, v.mn);
      mx = nan_max(mx, v.mx);
    });
  } else {
    const int lane = threadIdx.x & 31;
    fold_blocks_warp<BlockedPart>(L, g, lane, load, [&](const BlockedPart& v, int l) {
      s += __shfl_sync(0xffffffffu, v.s, l);
      cnt += __shfl_sync(0xffffffffu, v.c, l);
      mn = nan_min(mn, __shfl_sync(0xffffffffu, v.mn, l));
      mx = nan_max(mx, __shfl_sync(0xffffffffu, v.mx, l));
    });
    if (lane != 0) return;
  }
  const int64_t o = c * G + g;
  if (a.sums != nullptr) a.sums[o] = s;
  if (a.counts != nullptr) a.counts[o] = cnt;
  if (a.mins != nullptr) a.mins[o] = mn;
  if (a.maxs != nullptr) a.maxs[o] = mx;
}

GT_EXPORT int gt_blocked_partials(const BlockedArgs* args, void* stream) {
  if (args->layout.nb <= 0 || args->n_cols <= 0 || args->n_cols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  blocked_partials_kernel<<<(unsigned)args->layout.nb, kBlockThreads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_blocked_fold(const FoldArgs* args, void* stream) {
  const int64_t G = args->layout.num_groups;
  if (G <= 0 || args->n_cols <= 0) return (int)cudaSuccess;
  const int64_t per_cta = 256 / fold_lanes(args->layout.nb, G);
  const dim3 grid((unsigned)((G + per_cta - 1) / per_cta), (unsigned)args->n_cols);
  blocked_fold_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
