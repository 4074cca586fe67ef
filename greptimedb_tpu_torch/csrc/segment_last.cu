// K4 segment_last: last_value(v ORDER BY ts) per group.
//
// Replaces greptimedb_tpu/ops/aggregate.py:792 `_segment_blocked_last`
// (blocked form) and the LAST part of :598 `_segment_scatter` (any id
// order).  The winner of a group is its row with the largest ts and, on a
// ts tie, the LATER row (aggregate.py:629-638, :839-851): on the engine's
// (pk, ts, seq) layout that is last-write-wins.  Both forms take the
// lexicographic max of (ts, row index), which is the reference's two
// passes (max ts, then max row at that ts) in one, and is independent of
// the order of reduction.  Then one [G] gather fetches the values.
//
// Bound on the H100: bytes — per row the id (4 B), mask (1 B) and ts (8 B)
// once; the value column is only gathered at G rows.
//
// Blocked form (the guard of K2 passed; it reuses K2's per-block bases):
// one CTA per 4096-row block keeps a 16-slot (ts, row) window in
// registers and marks its occupied slots; the last CTA finishes this
// call's block layout (block_layout.cuh) from K2's bases, so the fold
// kernel finds the blocks covering each group with no sort of the bases,
// combines them and gathers; both launches are predicated on K2's guard
// flag (Gate).
// Sorted-run form (the guard failed — predicated on the same flag — or
// under 2^16 rows):
// over K3's stable sort of the masked ids, one warp per group reduces its
// run and gathers.
#include "block_layout.cuh"

// Mirrored field for field by _LastBlockedArgs in ops/aggregate.py (ctypes).
struct LastBlockedArgs {
  int64_t n;
  const int32_t* gids;
  const uint8_t* mask;
  const int64_t* ts;
  BlockLayout layout;   // base: [nb] from K2's guard pass; occ, keys, mode: this call's
  int64_t* pts;         // [nb, kSpan]
  int32_t* prow;        // [nb, kSpan]
  Gate gate;            // runs when K2's guard passed
};

// Mirrored field for field by _LastFoldArgs in ops/aggregate.py (ctypes).
struct LastFoldArgs {
  BlockLayout layout;
  const int64_t* pts;
  const int32_t* prow;
  const double* values;  // [n]
  int64_t* last_ts;      // [G]
  double* last_val;      // [G]
  int64_t n;
  Gate gate;             // runs when K2's guard passed
};

struct LastSortedArgs {
  int64_t n;
  const int32_t* skeys;  // [n] sorted ids; masked rows carry G
  const int64_t* perm;
  const int64_t* ts;
  const double* values;
  int64_t* last_ts;
  double* last_val;
  int32_t num_groups;
  int32_t reserved;
  Gate gate;             // behind K2's guard: runs when it failed
};

__device__ __forceinline__ double gather_value(const double* values, int64_t n, int32_t r) {
  int64_t i = r < 0 ? 0 : (int64_t)r;  // clip(pick, 0, n - 1)
  if (i > n - 1) i = n - 1;
  return values[i];
}

__global__ void __launch_bounds__(kBlockThreads) last_partials_kernel(const LastBlockedArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int64_t sh_t[kBlockThreads / 32][kSpan];
  __shared__ int32_t sh_r[kBlockThreads / 32][kSpan];
  const BlockLayout& L = a.layout;
  const int32_t base = L.base[b];
  int64_t bt[kSpan];
  int32_t br[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    bt[j] = kInt64Min;
    br[j] = -1;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = row0 + t + (int64_t)i * kBlockThreads;
    if (r >= a.n || a.mask[r] == 0) continue;
    const int32_t k = a.gids[r] - base;
    const int64_t tr = a.ts[r];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (k == j) lex_max(bt[j], br[j], tr, (int32_t)r);
    }
  }
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    int64_t tt = bt[j];
    int32_t rr = br[j];
    warp_lex_max(tt, rr);
    if (lane == 0) {
      sh_t[warp][j] = tt;
      sh_r[warp][j] = rr;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int64_t tt = kInt64Min;
    int32_t rr = -1;
    if (t < kSpan) {
      tt = sh_t[0][t];
      rr = sh_r[0][t];
      for (int w = 1; w < kBlockThreads / 32; ++w) lex_max(tt, rr, sh_t[w][t], sh_r[w][t]);
      a.pts[b * kSpan + t] = tt;
      a.prow[b * kSpan + t] = rr;
    }
    const uint32_t occ = __ballot_sync(0xffffffffu, t < kSpan && rr >= 0);
    if (t == 0) L.occ[b] = occ;
  }
  finish_layout(L, false);
}

// a thread or a warp (fold_lanes) per group; lex_max is order-free
__global__ void __launch_bounds__(256) last_fold_kernel(const LastFoldArgs a) {
  if (gate_shut(a.gate)) return;
  const BlockLayout& L = a.layout;
  const int64_t G = L.num_groups;
  const int lanes = fold_lanes(L.nb, G);
  const int64_t g = (int64_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (g >= G) return;  // uniform per warp when a warp folds a group
  int64_t tt = kInt64Min;
  int32_t rr = -1;
  auto load = [&](int64_t blk, int slot) { return blk * kSpan + slot; };
  if (lanes == 1) {
    fold_blocks<4, int64_t>(L, g, load, [&](int64_t p) { lex_max(tt, rr, a.pts[p], a.prow[p]); });
  } else {
    // lex_max is order-free: each lane takes every 32nd block of the
    // range, then a shuffle tree
    const int lane = threadIdx.x & 31;
    int64_t lo, hi;
    covering_range(L, g, lo, hi);
    for (int64_t blk = lo + lane; blk < hi; blk += 32) {
      const int s = covered_slot(L, blk, g);
      if (s >= 0) lex_max(tt, rr, a.pts[blk * kSpan + s], a.prow[blk * kSpan + s]);
    }
    warp_lex_max(tt, rr);
    if (lane != 0) return;
  }
  a.last_ts[g] = tt;
  a.last_val[g] = gather_value(a.values, a.n, rr);
}

// a capped grid of warps striding over the groups: a launch whose gate is
// shut costs one wave of empty CTAs
__global__ void __launch_bounds__(256) last_sorted_kernel(const LastSortedArgs a) {
  if (gate_shut(a.gate)) return;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; gw < a.num_groups;
       gw += warps) {  // uniform per warp
    const int64_t start = lower_bound_i32(a.skeys, a.n, gw);
    const int64_t end = lower_bound_i32(a.skeys, a.n, gw + 1);
    int64_t tt = kInt64Min;
    int32_t rr = -1;
    for (int64_t j = start + lane; j < end; j += 32) {
      const int64_t r = a.perm[j];
      lex_max(tt, rr, a.ts[r], (int32_t)r);
    }
    warp_lex_max(tt, rr);
    if (lane == 0) {
      a.last_ts[gw] = tt;
      a.last_val[gw] = gather_value(a.values, a.n, rr);
    }
  }
}

GT_EXPORT int gt_last_partials(const LastBlockedArgs* args, void* stream) {
  if (args->layout.nb <= 0) return (int)cudaSuccess;
  last_partials_kernel<<<(unsigned)args->layout.nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_fold(const LastFoldArgs* args, void* stream) {
  const int64_t G = args->layout.num_groups;
  if (G <= 0) return (int)cudaSuccess;
  const int64_t per_cta = 256 / fold_lanes(args->layout.nb, G);
  last_fold_kernel<<<(unsigned)((G + per_cta - 1) / per_cta), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_sorted(const LastSortedArgs* args, void* stream) {
  const int64_t threads = (int64_t)args->num_groups * 32;
  if (threads <= 0) return (int)cudaSuccess;
  const int64_t blocks = (threads + 255) / 256;
  last_sorted_kernel<<<(unsigned)(blocks < kCapBlocks ? blocks : kCapBlocks), 256, 0,
                       (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
