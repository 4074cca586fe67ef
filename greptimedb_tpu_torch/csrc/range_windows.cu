// K10 range_windows: per (series, eval step) window statistics.
//
// Replaces greptimedb_tpu/ops/rate.py:145 `range_windows_dyn` (and :123
// `range_windows`), B15, with the tile path's row prologue
// (greptimedb_tpu/query/promql/tile_exec.py:115 `_region_stats`) fused in
// through rate_rows.cuh.  Cell (s, w) of the [S * W] layout covers the
// fetched samples of series s with ts in (t_w - range, t_w],
// t_w = start + w * step; steps at or past n_steps_actual stay empty.
//
// Bound on the H100: bytes — ts, value and in_fetch read once per row and
// eight statistics written once per cell.  One thread owns a cell: two
// binary searches over its series' rows (sorted by ts) find the window,
// and the walk reproduces the reference's arithmetic: a sample's first
// window is w0 = ceil(f64(ts - start) / f64(step)) clamped at 0 (a float
// division, as in JAX); pass j = w - w0 (0 <= j < k) sums its samples in
// row order from 0.0 and the passes are added newest first (j = 0 first);
// first/last_val are the largest value at the first/last ts; min/max
// propagate NaN.  Threads of a warp take neighbouring steps of one series,
// so the rows they re-read come from L1/L2.  No float atomics.
#include "rate_rows.cuh"

struct WindowArgs {
  RowPlanes rows;
  SeriesLayout layout;
  const double* adj;  // [n] K9's adjusted values, or nullptr (read the planes)
  int32_t* count;
  int64_t* first_ts;
  int64_t* last_ts;
  double* first_val;
  double* last_val;
  double* sum;
  double* mn;
  double* mx;
  int64_t n_steps, n_steps_actual, k;
  int64_t start, step, range;
};

// First row r in [lo, hi) with ts_ms(r) > key (hi if none).
__device__ __forceinline__ int64_t upper_row(const RowPlanes& p, int64_t lo, int64_t hi, int64_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ts_ms_of(p, mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t first_window(const WindowArgs& a, int64_t t) {
  const double q = ceil(__ddiv_rn((double)(t - a.start), (double)a.step));
  const int64_t w0 = (int64_t)q;
  return w0 < 0 ? 0 : w0;
}

__global__ void __launch_bounds__(256) windows_kernel(const WindowArgs a) {
  const int64_t cells = a.layout.num_series * a.n_steps;
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const int64_t s = cell / a.n_steps, w = cell - s * a.n_steps;
  int32_t cnt = 0;
  int64_t fts = kInt64Max, lts = kInt64Min;
  double fv = -kDblMax, lv = -kDblMax, sum = 0.0, mn = kDblMax, mx = -kDblMax;
  const int64_t r_last = a.layout.last[s];
  if (w < a.n_steps_actual && r_last >= 0) {
    const int64_t t_w = a.start + w * a.step;
    const int64_t beg_all = upper_row(a.rows, a.layout.first[s], r_last + 1, t_w - a.range);
    int64_t end = upper_row(a.rows, beg_all, r_last + 1, t_w);
    // slices of equal first window, newest first; each summed forward
    while (end > beg_all) {
      const int64_t w0 = first_window(a, ts_ms_of(a.rows, end - 1));
      int64_t beg = end - 1;
      while (beg > beg_all && first_window(a, ts_ms_of(a.rows, beg - 1)) == w0) --beg;
      const int64_t j = w - w0;
      if (j >= 0 && j < a.k) {
        double part = 0.0;
        bool any = false;
        for (int64_t r = beg; r < end; ++r) {
          if (a.layout.in_fetch[r] == 0) continue;
          const double v = a.adj != nullptr ? a.adj[r] : value_of(a.rows, r);
          const int64_t t = ts_ms_of(a.rows, r);
          part = __dadd_rn(part, v);
          any = true;
          cnt += 1;
          mn = nan_min(mn, v);
          mx = nan_max(mx, v);
          if (t < fts) {
            fts = t;
            fv = nan_max(-kDblMax, v);
          } else if (t == fts) {
            fv = nan_max(fv, v);
          }
          if (t > lts) {
            lts = t;
            lv = nan_max(-kDblMax, v);
          } else if (t == lts) {
            lv = nan_max(lv, v);
          }
        }
        if (any) sum = __dadd_rn(sum, part);
      }
      end = beg;
    }
  }
  a.count[cell] = cnt;
  a.first_ts[cell] = fts;
  a.last_ts[cell] = lts;
  a.first_val[cell] = fv;
  a.last_val[cell] = lv;
  a.sum[cell] = sum;
  a.mn[cell] = mn;
  a.mx[cell] = mx;
}

GT_EXPORT int gt_range_layout(const LayoutArgs* args, void* stream) {
  return launch_series_layout(args, (cudaStream_t)stream);
}

GT_EXPORT int gt_range_windows(const WindowArgs* args, void* stream) {
  const int64_t cells = args->layout.num_series * args->n_steps;
  if (cells <= 0) return (int)cudaSuccess;
  windows_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
