// K12 series_fold: the by-label fold of a PromQL aggregation on the card.
//
// Replaces the fold of greptimedb_tpu/query/promql/tile_exec.py:180
// `_finalize` (B17): [S, W] per-series values (NaN = absent) to [G, W]
// sum / avg / count / min / max over each group's present cells; a group
// with none is NaN.  avg is sum / max(count, 1), count an f64.
//
// Bound on the H100: bytes — the [S, W] matrix read once, [G, W] written.
// One thread owns a (group, step) cell and adds the group's series in the
// CSR order the host built from `_gid_map` (ascending series id), the
// order of the reference's segment sum and of the legacy host fold on a
// one-region table; absent cells are skipped (adding 0.0 changes nothing).
// Threads of a warp take neighbouring steps, so each member row is read
// coalesced.  No float atomics.
#include "common.cuh"

struct FoldArgs {
  const double* mat;        // [S, W]
  const int64_t* offsets;   // [G + 1]
  const int64_t* members;   // [S] series ids grouped by group
  double* out;              // [G, W]
  int64_t n_groups, n_steps;
  int32_t op, reserved;     // 0 sum, 1 avg, 2 count, 3 min, 4 max
};

__global__ void __launch_bounds__(256) fold_kernel(const FoldArgs a) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= a.n_groups * a.n_steps) return;
  const int64_t g = cell / a.n_steps, w = cell - g * a.n_steps;
  double sum = 0.0, cnt = 0.0;
  double ext = a.op == 3 ? (double)INFINITY : -(double)INFINITY;
  // unrolled so the loads of several members are in flight at once; the
  // adds stay in member order
#pragma unroll 8
  for (int64_t i = a.offsets[g]; i < a.offsets[g + 1]; ++i) {
    const double x = a.mat[a.members[i] * a.n_steps + w];
    if (x != x) continue;
    sum = __dadd_rn(sum, x);
    cnt = __dadd_rn(cnt, 1.0);
    if (a.op == 3) {
      if (x < ext) ext = x;
    } else if (a.op == 4) {
      if (x > ext) ext = x;
    }
  }
  double v;
  switch (a.op) {
    case 0: v = sum; break;
    case 1: v = __ddiv_rn(sum, cnt > 1.0 ? cnt : 1.0); break;
    case 2: v = cnt; break;
    default: v = ext; break;
  }
  a.out[cell] = cnt > 0 ? v : __longlong_as_double(0x7ff8000000000000LL);
}

GT_EXPORT int gt_series_fold(const FoldArgs* args, void* stream) {
  const int64_t cells = args->n_groups * args->n_steps;
  if (cells <= 0) return (int)cudaSuccess;
  fold_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
