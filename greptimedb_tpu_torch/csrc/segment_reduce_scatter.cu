// K3 segment_reduce_scatter: sum / count / min / max per group for any id
// order (shuffled ids, unclustered layouts, scans under 2^16 rows).
//
// Replaces greptimedb_tpu/ops/aggregate.py:598 `_segment_scatter` (XLA
// segment_sum/min/max with an overflow slot G for masked rows).
//
// Bound on the H100: bytes — the ids (4 B), mask (1 B) and values (8 B per
// column) of every row once, plus the index plumbing below.  A scatter
// with f64 atomicAdd would be faster but adds in a different order on
// every run; this kernel is deterministic instead.  The caller sorts the
// masked ids with a stable torch.sort (index plumbing: rows of one group
// end up in one run, in row order); one warp per group then binary-
// searches its run, its lanes gather the run's rows in a strided order
// and a fixed shuffle tree combines them.  The order of every f64
// addition is thus fixed by the data alone.
#include <math.h>

#include "common.cuh"

struct ScatterArgs {
  int64_t n;
  const int32_t* skeys;         // [n] sorted ids; masked rows carry G
  const int64_t* perm;          // [n] row of each sorted id
  const double* const* values;  // device array [C]
  const uint8_t* const* masks;  // device array [C]; nullptr entry = base mask
  double* sums;                 // [C, G] or nullptr
  int32_t* counts;
  double* mins;
  double* maxs;
  int32_t num_groups;
  int32_t n_cols;
};

__global__ void __launch_bounds__(256) scatter_reduce_kernel(const ScatterArgs a) {
  const int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= a.num_groups) return;  // uniform per warp
  const int64_t start = lower_bound_i32(a.skeys, a.n, gw);
  const int64_t end = lower_bound_i32(a.skeys, a.n, gw + 1);
  const int64_t G = a.num_groups;
  for (int c = 0; c < a.n_cols; ++c) {
    const double* v = a.values[c];
    const uint8_t* cm = a.masks[c];
    // empty groups keep the identities of XLA's segment_min/max: +-inf
    double s = 0.0, mn = INFINITY, mx = -INFINITY;
    int32_t cnt = 0;
    for (int64_t j = start + lane; j < end; j += 32) {
      const int64_t r = a.perm[j];
      if (cm != nullptr && cm[r] == 0) continue;
      const double x = v[r];
      s += x;
      cnt += 1;
      mn = nan_min(mn, x);
      mx = nan_max(mx, x);
    }
    const int64_t o = c * G + gw;
    if (a.sums != nullptr) {
      s = warp_sum(s);
      if (lane == 0) a.sums[o] = s;
    }
    if (a.counts != nullptr) {
      cnt = warp_sum_i(cnt);
      if (lane == 0) a.counts[o] = cnt;
    }
    if (a.mins != nullptr) {
      mn = warp_min(mn);
      if (lane == 0) a.mins[o] = mn;
    }
    if (a.maxs != nullptr) {
      mx = warp_max(mx);
      if (lane == 0) a.maxs[o] = mx;
    }
  }
}

GT_EXPORT int gt_scatter_reduce(const ScatterArgs* args, void* stream) {
  const int64_t threads = (int64_t)args->num_groups * 32;
  if (threads <= 0) return (int)cudaSuccess;
  scatter_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
