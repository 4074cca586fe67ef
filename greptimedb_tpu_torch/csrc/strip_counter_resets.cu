// K9 strip_counter_resets: per-series counter-reset re-accumulation.
//
// Replaces greptimedb_tpu/ops/rate.py:46 `strip_counter_resets_segmented`
// and :82 `strip_counter_resets` (B14): after a reset (a value below the
// previous fetched value of the same series) the pre-reset value is added
// to the series' running correction, so adjusted values never decrease.
//
// Bound on the H100: bytes — in_fetch, the value (and its present mask)
// read once per row, the adjusted value written once.  The reference
// takes a global prefix sum of the corrections and subtracts a per-series
// baseline; here one warp owns a series (the row prologue of rate_rows.cuh
// gives each series' first and last fetched row) and walks its rows 32 at
// a time: each lane loads one row (coalesced), then every lane replays
// the 32 rows in order through shuffles, so the running correction is a
// plain sequential f64 sum in row order — equal to the reference on
// series without a reset (both add exactly 0.0), within the last ulp on
// series with one.  Outputs of rows that are not fetched are left
// unwritten.
#include "rate_rows.cuh"

struct StripArgs {
  RowPlanes rows;
  SeriesLayout layout;
  double* out;  // [n]
};

__global__ void __launch_bounds__(256) strip_kernel(const StripArgs a) {
  const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= a.layout.num_series) return;  // uniform per warp
  const int64_t lo = a.layout.first[s], hi = a.layout.last[s];
  if (hi < 0) return;
  double acc = 0.0, pv = 0.0;
  bool have = false;
  for (int64_t base = lo; base <= hi; base += 32) {
    const int64_t r = base + lane;
    const int fetched = (r <= hi && a.layout.in_fetch[r] != 0) ? 1 : 0;
    const double v = fetched ? value_of(a.rows, r) : 0.0;
    double mine = 0.0;
    for (int l = 0; l < 32; ++l) {
      const int f = __shfl_sync(0xffffffffu, fetched, l);
      const double x = __shfl_sync(0xffffffffu, v, l);
      if (f) {
        if (have && x < pv) acc = __dadd_rn(acc, pv);
        if (lane == l) mine = __dadd_rn(x, acc);
        pv = x;
        have = true;
      }
    }
    if (fetched) a.out[r] = mine;
  }
}

GT_EXPORT int gt_strip_layout(const LayoutArgs* args, void* stream) {
  return launch_series_layout(args, (cudaStream_t)stream);
}

GT_EXPORT int gt_strip_counter_resets(const StripArgs* args, void* stream) {
  const int64_t S = args->layout.num_series;
  if (S <= 0 || args->rows.n <= 0) return (int)cudaSuccess;
  const int64_t threads = S * 32;  // one warp per series
  strip_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
