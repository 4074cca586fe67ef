// K10 range_windows: per (series, eval step) window statistics.
//
// Replaces greptimedb_tpu/ops/rate.py:145 `range_windows_dyn` (and :123
// `range_windows`), B15, with the tile path's row prologue
// (greptimedb_tpu/query/promql/tile_exec.py:115 `_region_stats`) fused in
// through rate_rows.cuh.  Cell (s, w) of the [S * W] layout covers the
// fetched samples of series s with ts in (t_w - range, t_w],
// t_w = start + w * step; steps at or past n_steps_actual stay empty.
//
// The reference's arithmetic.  A sample's first window is
// w0 = ceil(f64(ts - start) / f64(step)) clamped at 0 (a float division,
// as in JAX); pass j adds, in row order from 0.0, the samples whose first
// window is w - j, and the passes are added newest first (j = 0 first).
// first/last_val are the largest value at the first/last ts; min/max
// propagate NaN.  No float atomics: every run gives the same bytes.
//
// Slices.  Slice (s, m) is the run of series s's rows whose w0 is m (the
// plain version's slices, ops/rate.py::range_windows_plain).  Cell w adds
// slices w, w - 1, ..., w - k + 1 newest first, each restricted to the
// window.  w0 grows with ts, so the slices older than wl = w0(t_w - range)
// hold only rows at or before t_w - range, the slices newer than it only
// later rows, and the slices older than wt = w0(t_w) only rows at or
// before t_w: only slice wl (the clamp slice w0 = 0, or the oldest slice
// of every window when range is not a multiple of step) and slices wt ..
// w can be cut by the window.  A cut slice keeps its rows in the window,
// found by bisection inside the slice and summed from the rows in row
// order from 0.0.
//
// Design: two kernels.
// * slices_kernel, one thread per slice: a search on ts, started where a
//   steady scrape interval would put the row, finds the slice's first row
//   (checked against w0 at the boundary, so an inexact division cannot
//   move it); then the thread walks the slice's rows once, computing w0
//   once per row to find its end, and stores count, first/last ts and
//   value, sum, min, max and its row range into a [S * n_steps_actual]
//   slice table.
// * cells_kernel, one block per (series, kTile steps): the block loads
//   the kTile + k - 1 slices its cells read (in batches of kSlices,
//   newest first) into shared memory, and each thread adds its cell's
//   slices from there newest first and writes the cell's eight statistics
//   once.  Series with no fetched row, padded steps and padded series are
//   written empty.
//
// Bound on the H100: bytes — each row's valid, ts, code, value and
// present planes read once (22 B) and each cell's 60 B of statistics
// written once: 17.28 M rows and 4096 x 1024 cells are 0.38 GB + 0.25 GB,
// 0.189 ms at 3.35 TB/s.  Beyond it: the prologue (rate_rows.cuh) and the
// slices each read ts, and the slice table (68 B a slice, 0.20 GB at
// 4000 series x 721 steps) is written once and read about once more
// (k - 1 slices of overlap a tile); each cell reads its k slices from
// shared memory, which bounds the cells at k = 64.
#include "rate_rows.cuh"

constexpr int kThreads = 256;  // slices_kernel
constexpr int kTile = 256;     // cells (steps) per block of cells_kernel, one thread each
constexpr int kSlices = 320;   // slices in shared memory: kTile + k - 1 up to k = 65

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// The slice table: [n] entries, slice (s, m) at s * n_steps_actual + m;
// beg/end are rows from the series' first fetched row.  Carved by
// gt_range_windows from one buffer of 68 * n bytes.
struct Slices {
  int64_t* fts;
  int64_t* lts;
  double* fv;
  double* lv;
  double* sum;
  double* mn;
  double* mx;
  int32_t* cnt;
  int32_t* beg;
  int32_t* end;
};

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
  uint8_t* slices;  // [68 * num_series * n_steps_actual] the slice table
  int64_t n_steps, n_steps_actual, k;
  int64_t start, step, range;
};

// Statistics of a run of rows, with the reference's per-row updates.
struct Part {
  int32_t cnt;
  int64_t fts, lts;
  double fv, lv, sum, mn, mx;
};

__device__ __forceinline__ Part empty_part() {
  return Part{0, kInt64Max, kInt64Min, -kDblMax, -kDblMax, 0.0, kDblMax, -kDblMax};
}

__device__ __forceinline__ void add_row(Part& p, int64_t t, double v) {
  p.cnt += 1;
  p.sum = __dadd_rn(p.sum, v);
  p.mn = nan_min(p.mn, v);
  p.mx = nan_max(p.mx, v);
  if (t < p.fts) {
    p.fts = t;
    p.fv = nan_max(-kDblMax, v);
  } else if (t == p.fts) {
    p.fv = nan_max(p.fv, v);
  }
  if (t > p.lts) {
    p.lts = t;
    p.lv = nan_max(-kDblMax, v);
  } else if (t == p.lts) {
    p.lv = nan_max(p.lv, v);
  }
}

__device__ __forceinline__ double value_at(const WindowArgs& a, int64_t r) {
  return a.adj != nullptr ? a.adj[r] : value_of(a.rows, r);
}

__device__ __forceinline__ int64_t first_window(const WindowArgs& a, int64_t t) {
  const double q = ceil(__ddiv_rn((double)(t - a.start), (double)a.step));
  const int64_t w0 = (int64_t)q;
  return w0 < 0 ? 0 : w0;
}

// First row r in [lo, hi) with ts_ms(r) > key (hi if none).
__device__ __forceinline__ int64_t upper_row(const RowPlanes& p, int64_t lo, int64_t hi, int64_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ts_ms_of(p, mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// upper_row over a series' rows [f, e), starting where ts would put the
// key if the rows were evenly spaced in time, then doubling the step
// until the key is bracketed (a few probes at a steady scrape interval).
__device__ int64_t upper_row_near(const RowPlanes& p, int64_t f, int64_t e, int64_t key) {
  const int64_t t_f = ts_ms_of(p, f), t_l = ts_ms_of(p, e - 1);
  if (t_f > key) return f;
  if (t_l <= key) return e;
  const double frac = (double)(key - t_f) / (double)(t_l - t_f);
  const int64_t g = min64(max64(f + (int64_t)(frac * (double)(e - 1 - f)), f), e - 1);
  int64_t lo = f - 1, hi = e;  // ts(lo) <= key < ts(hi), lo = f - 1 and hi = e unread
  if (ts_ms_of(p, g) <= key) {
    lo = g;
    for (int64_t d = 1; lo + d < e; d <<= 1) {
      if (ts_ms_of(p, lo + d) > key) {
        hi = lo + d;
        break;
      }
      lo += d;
    }
  } else {
    hi = g;
    for (int64_t d = 1; hi - d >= f; d <<= 1) {
      if (ts_ms_of(p, hi - d) <= key) {
        lo = hi - d;
        break;
      }
      hi -= d;
    }
  }
  return upper_row(p, lo + 1, hi, key);
}

__device__ __forceinline__ Slices carve(const WindowArgs& a) {
  const int64_t n = a.layout.num_series * a.n_steps_actual;
  uint8_t* b = a.slices;
  Slices t;
  t.fts = (int64_t*)b;
  t.lts = t.fts + n;
  t.fv = (double*)(t.lts + n);
  t.lv = t.fv + n;
  t.sum = t.lv + n;
  t.mn = t.sum + n;
  t.mx = t.mn + n;
  t.cnt = (int32_t*)(t.mx + n);
  t.beg = t.cnt + n;
  t.end = t.beg + n;
  return t;
}

// ---- the slice table ----

__global__ void __launch_bounds__(kThreads) slices_kernel(const WindowArgs a) {
  const int64_t n_sl = a.n_steps_actual;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= a.layout.num_series * n_sl) return;
  const int64_t s = idx / n_sl, m = idx - s * n_sl;
  const int64_t last = a.layout.last[s];
  if (last < 0) return;  // cells_kernel writes the series empty without reading it
  const int64_t f = a.layout.first[s], e = last + 1;
  // the first row whose w0 is >= m: the first row after t_{m-1} is found
  // on ts, then moved back while w0 disagrees (it does not where the
  // division is exact; the walk below moves it forward)
  int64_t r = f;
  if (m > 0) {
    r = upper_row_near(a.rows, f, e, a.start + (m - 1) * a.step);
    while (r > f && first_window(a, ts_ms_of(a.rows, r - 1)) >= m) --r;
  }
  Part p = empty_part();
  int64_t beg = r;
  // the next row's ts and this row's fetched flag and value are loaded
  // before this row's w0 is known
  int64_t t = r < e ? ts_ms_of(a.rows, r) : 0;
  for (; r < e; ++r) {
    const int64_t t_next = r + 1 < e ? ts_ms_of(a.rows, r + 1) : 0;
    const bool fetched = a.layout.in_fetch[r] != 0;
    const double v = value_at(a, r);
    const int64_t w0 = first_window(a, t);  // once a row
    if (w0 > m) break;
    if (w0 < m) {
      beg = r + 1;  // not yet the slice (only where the division is inexact)
    } else if (fetched) {
      add_row(p, t, v);
    }
    t = t_next;
  }
  const Slices sl = carve(a);
  sl.fts[idx] = p.fts;
  sl.lts[idx] = p.lts;
  sl.fv[idx] = p.fv;
  sl.lv[idx] = p.lv;
  sl.sum[idx] = p.sum;
  sl.mn[idx] = p.mn;
  sl.mx[idx] = p.mx;
  sl.cnt[idx] = p.cnt;
  sl.beg[idx] = (int32_t)(beg - f);
  sl.end[idx] = (int32_t)(r - f);
}

// ---- the cells ----

struct Shared {
  int64_t fts[kSlices], lts[kSlices];
  double fv[kSlices], lv[kSlices], sum[kSlices], mn[kSlices], mx[kSlices];
  int32_t cnt[kSlices], beg[kSlices], end[kSlices];
};

// A cell's running statistics: `c` so far, whether it has its newest
// sample (last ts and value), and the oldest whole slice of this batch it
// added (its first ts and value are read once, after the batch).
struct Cell {
  Part c;
  bool have;
  int old_i;
};

__device__ __forceinline__ void add_part(Cell& x, const Part& p) {
  x.c.cnt += p.cnt;
  x.c.sum = __dadd_rn(x.c.sum, p.sum);
  x.c.mn = nan_min(x.c.mn, p.mn);
  x.c.mx = nan_max(x.c.mx, p.mx);
  if (!x.have) {
    x.c.lts = p.lts;
    x.c.lv = p.lv;
    x.have = true;
  }
}

// Slice i (rows from row f) at a window edge: whole when its samples lie
// in (lo, t_w], else cut to its rows there, in row order.
__device__ __forceinline__ void add_edge_slice(const WindowArgs& a, const Shared& sh, Cell& x,
                                               int i, int64_t f, int64_t lo, int64_t t_w) {
  if (sh.cnt[i] == 0 || sh.lts[i] <= lo || sh.fts[i] > t_w) return;  // none in the window
  if (sh.fts[i] > lo && sh.lts[i] <= t_w) {
    add_part(x, Part{sh.cnt[i], sh.fts[i], sh.lts[i], sh.fv[i], sh.lv[i], sh.sum[i], sh.mn[i],
                     sh.mx[i]});
    x.old_i = i;
    return;
  }
  const int64_t end = f + sh.end[i];
  Part p = empty_part();
  for (int64_t r = upper_row(a.rows, f + sh.beg[i], end, lo); r < end; ++r) {
    const int64_t t = ts_ms_of(a.rows, r);
    if (t > t_w) break;
    if (a.layout.in_fetch[r] != 0) add_row(p, t, value_at(a, r));
  }
  if (p.cnt == 0) return;
  add_part(x, p);
  x.old_i = -1;
  x.c.fts = p.fts;
  x.c.fv = p.fv;
}

__global__ void __launch_bounds__(kTile) cells_kernel(const WindowArgs a, int64_t tiles) {
  __shared__ Shared sh;
  const int64_t s = blockIdx.x / tiles;
  const int64_t wa = (blockIdx.x - s * tiles) * kTile;
  const int64_t w = wa + threadIdx.x;
  const int64_t r_last = a.layout.last[s];
  Cell x{empty_part(), false, -1};
  if (r_last >= 0 && wa < a.n_steps_actual && a.k > 0) {
    const Slices sl = carve(a);
    const int64_t f = a.layout.first[s];
    const int64_t base = s * a.n_steps_actual;
    const bool mine = w < a.n_steps_actual;
    const int64_t t_w = a.start + w * a.step, lo = t_w - a.range;
    const int64_t wl = first_window(a, lo), wt = first_window(a, t_w);
    const int64_t oldest = max64(w - a.k + 1, wl);
    const int64_t tile_oldest = max64(wa - a.k + 1, first_window(a, a.start + wa * a.step - a.range));
    for (int64_t j_hi = min64(wa + kTile, a.n_steps_actual) - 1; j_hi >= tile_oldest; j_hi -= kSlices) {
      const int64_t j_lo = max64(j_hi - kSlices + 1, tile_oldest);
      for (int i = threadIdx.x; i <= j_hi - j_lo; i += kTile) {
        // every field loaded before any is stored
        const int64_t g = base + j_lo + i;
        const int32_t cnt = sl.cnt[g], beg = sl.beg[g], end = sl.end[g];
        const int64_t fts = sl.fts[g], lts = sl.lts[g];
        const double fv = sl.fv[g], lv = sl.lv[g], sum = sl.sum[g], mn = sl.mn[g], mx = sl.mx[g];
        sh.cnt[i] = cnt;
        sh.beg[i] = beg;
        sh.end[i] = end;
        sh.fts[i] = fts;
        sh.lts[i] = lts;
        sh.fv[i] = fv;
        sh.lv[i] = lv;
        sh.sum[i] = sum;
        sh.mn[i] = mn;
        sh.mx[i] = mx;
      }
      __syncthreads();
      x.old_i = -1;
      // newest first: the reference's order of passes
      const int64_t bottom = mine ? max64(oldest, j_lo) : j_hi + 1;
      int64_t m = min64(w, j_hi);
      for (; m >= bottom && m >= wt; --m) add_edge_slice(a, sh, x, (int)(m - j_lo), f, lo, t_w);
      for (const int64_t whole_lo = max64(bottom, wl + 1); m >= whole_lo; --m) {
        const int i = (int)(m - j_lo);
        const int32_t n_i = sh.cnt[i];
        if (n_i == 0) continue;
        x.c.cnt += n_i;
        x.c.sum = __dadd_rn(x.c.sum, sh.sum[i]);
        x.c.mn = nan_min(x.c.mn, sh.mn[i]);
        x.c.mx = nan_max(x.c.mx, sh.mx[i]);
        if (!x.have) {
          x.c.lts = sh.lts[i];
          x.c.lv = sh.lv[i];
          x.have = true;
        }
        x.old_i = i;
      }
      for (; m >= bottom; --m) add_edge_slice(a, sh, x, (int)(m - j_lo), f, lo, t_w);
      if (x.old_i >= 0) {
        x.c.fts = sh.fts[x.old_i];
        x.c.fv = sh.fv[x.old_i];
      }
      __syncthreads();  // the next batch overwrites shared memory
    }
  }
  if (w < a.n_steps) {
    const int64_t cell = s * a.n_steps + w;
    a.count[cell] = x.c.cnt;
    a.first_ts[cell] = x.c.fts;
    a.last_ts[cell] = x.c.lts;
    a.first_val[cell] = x.c.fv;
    a.last_val[cell] = x.c.lv;
    a.sum[cell] = x.c.sum;
    a.mn[cell] = x.c.mn;
    a.mx[cell] = x.c.mx;
  }
}

GT_EXPORT int gt_range_layout(const LayoutArgs* args, void* stream) {
  return launch_series_layout(args, (cudaStream_t)stream);
}

GT_EXPORT int gt_range_windows(const WindowArgs* args, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_sl = args->layout.num_series * args->n_steps_actual;
  if (n_sl > 0) slices_kernel<<<(unsigned)((n_sl + kThreads - 1) / kThreads), kThreads, 0, s>>>(*args);
  const int64_t tiles = (args->n_steps + kTile - 1) / kTile;
  const int64_t blocks = args->layout.num_series * tiles;
  if (blocks > 0) cells_kernel<<<(unsigned)blocks, kTile, 0, s>>>(*args, tiles);
  return (int)cudaGetLastError();
}
