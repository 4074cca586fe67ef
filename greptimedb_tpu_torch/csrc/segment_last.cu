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
// registers, then a fold kernel combines the blocks covering each group
// and gathers.  Sorted-run form (the guard failed, or under 2^16 rows):
// over K3's stable sort of the masked ids, one warp per group reduces its
// run and gathers.
#include "common.cuh"

struct LastBlockedArgs {
  int64_t n;
  int64_t nb;
  const int32_t* gids;
  const uint8_t* mask;
  const int64_t* ts;
  const int32_t* base;  // [nb] from K2's guard pass
  int64_t* pts;         // [nb, kSpan]
  int32_t* prow;        // [nb, kSpan]
};

struct LastFoldArgs {
  const int32_t* sbase;  // [nb] sorted bases
  const int64_t* order;  // [nb]
  const int64_t* pts;
  const int32_t* prow;
  const double* values;  // [n]
  int64_t* last_ts;      // [G]
  double* last_val;      // [G]
  int64_t nb;
  int64_t n;
  int32_t num_groups;
  int32_t reserved;
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
};

__device__ __forceinline__ double gather_value(const double* values, int64_t n, int32_t r) {
  int64_t i = r < 0 ? 0 : (int64_t)r;  // clip(pick, 0, n - 1)
  if (i > n - 1) i = n - 1;
  return values[i];
}

__global__ void __launch_bounds__(kBlockThreads) last_partials_kernel(const LastBlockedArgs a) {
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int64_t sh_t[kBlockThreads / 32][kSpan];
  __shared__ int32_t sh_r[kBlockThreads / 32][kSpan];
  const int32_t base = a.base[b];
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
  if (t < kSpan) {
    int64_t tt = sh_t[0][t];
    int32_t rr = sh_r[0][t];
    for (int w = 1; w < kBlockThreads / 32; ++w) lex_max(tt, rr, sh_t[w][t], sh_r[w][t]);
    a.pts[b * kSpan + t] = tt;
    a.prow[b * kSpan + t] = rr;
  }
}

__global__ void __launch_bounds__(256) last_fold_kernel(const LastFoldArgs a) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.num_groups) return;
  const int64_t lo = lower_bound_i32(a.sbase, a.nb, g - kSpan + 1);
  const int64_t hi = lower_bound_i32(a.sbase, a.nb, g + 1);
  int64_t tt = kInt64Min;
  int32_t rr = -1;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t p = a.order[i] * kSpan + (g - a.sbase[i]);
    lex_max(tt, rr, a.pts[p], a.prow[p]);
  }
  a.last_ts[g] = tt;
  a.last_val[g] = gather_value(a.values, a.n, rr);
}

__global__ void __launch_bounds__(256) last_sorted_kernel(const LastSortedArgs a) {
  const int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= a.num_groups) return;  // uniform per warp
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

GT_EXPORT int gt_last_partials(const LastBlockedArgs* args, void* stream) {
  if (args->nb <= 0) return (int)cudaSuccess;
  last_partials_kernel<<<(unsigned)args->nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_fold(const LastFoldArgs* args, void* stream) {
  if (args->num_groups <= 0) return (int)cudaSuccess;
  last_fold_kernel<<<(unsigned)((args->num_groups + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_sorted(const LastSortedArgs* args, void* stream) {
  const int64_t threads = (int64_t)args->num_groups * 32;
  if (threads <= 0) return (int)cudaSuccess;
  last_sorted_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
