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
// One warp walks each run: its lanes gather the run's rows in a strided
// order and a fixed shuffle tree combines them, so the order of every f64
// addition is fixed by the data alone.  Two ways to hand out the runs,
// whichever launches fewer warps; both give the same bytes:
//   - dense ids (G <= n / 32, runs of 32 rows or more on average): a warp
//     per group binary-searches its run and writes empty groups itself;
//   - sparse ids (the slot ids of a hash plan fill a few percent of G): a
//     first launch writes every group's identities, then each warp takes
//     32 sorted positions and walks every run that starts among them, so
//     the work follows the occupied groups, not G.
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
  Gate gate;                    // behind K2's or K6's guard: runs when it failed
};

// One warp reduces the run [start, end) of group g into every column.
__device__ __forceinline__ void reduce_run(const ScatterArgs& a, int64_t g, int64_t start,
                                           int64_t end, int lane) {
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
    const int64_t o = c * G + g;
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

// dense ids: a warp per group, its run found by two binary searches
__global__ void __launch_bounds__(256) scatter_group_kernel(const ScatterArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (gw >= a.num_groups) return;  // uniform per warp
  reduce_run(a, gw, lower_bound_i32(a.skeys, a.n, gw), lower_bound_i32(a.skeys, a.n, gw + 1),
             threadIdx.x & 31);
}

// sparse ids, first launch: the identities of every group (0, 0, +-inf)
__global__ void __launch_bounds__(256) scatter_identity_kernel(const ScatterArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t total = (int64_t)a.n_cols * a.num_groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    if (a.sums != nullptr) a.sums[i] = 0.0;
    if (a.counts != nullptr) a.counts[i] = 0;
    if (a.mins != nullptr) a.mins[i] = INFINITY;
    if (a.maxs != nullptr) a.maxs[i] = -INFINITY;
  }
}

// sparse ids, second launch: a warp per 32 sorted positions walks each run
// that starts there
__global__ void __launch_bounds__(256) scatter_run_kernel(const ScatterArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t base = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) << 5;
  const int lane = threadIdx.x & 31;
  if (base >= a.n) return;  // uniform per warp
  const int64_t G = a.num_groups;
  const int64_t j = base + lane;
  const int32_t key = j < a.n ? a.skeys[j] : (int32_t)G;
  const bool starts = key < G && (j == 0 || a.skeys[j - 1] != key);
  unsigned runs = __ballot_sync(0xffffffffu, starts);
  while (runs != 0u) {
    const int src = __ffs(runs) - 1;
    runs &= runs - 1u;
    const int64_t start = base + src;
    const int32_t g = __shfl_sync(0xffffffffu, key, src);
    // the run ends at the first later position holding another id
    int64_t end = start;
    for (int64_t p = start;; p += 32) {
      const int64_t q = p + lane;
      const unsigned in = __ballot_sync(0xffffffffu, q < a.n && a.skeys[q] == g);
      if (in != 0xffffffffu) {
        end = p + __ffs(~in) - 1;
        break;
      }
    }
    reduce_run(a, g, start, end, lane);
  }
}

GT_EXPORT int gt_scatter_reduce(const ScatterArgs* args, void* stream) {
  const int64_t G = args->num_groups, n = args->n;
  if ((int64_t)args->n_cols * G <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (G <= n / 32) {
    scatter_group_kernel<<<(unsigned)((G * 32 + 255) / 256), 256, 0, s>>>(*args);
    return (int)cudaGetLastError();
  }
  const int64_t fill_blocks = ((int64_t)args->n_cols * G + 255) / 256;
  scatter_identity_kernel<<<(unsigned)(fill_blocks < 65536 ? fill_blocks : 65536), 256, 0, s>>>(
      *args);
  if (n > 0) scatter_run_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(*args);
  return (int)cudaGetLastError();
}
