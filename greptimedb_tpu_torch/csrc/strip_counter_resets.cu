// K9 strip_counter_resets: per-series counter-reset re-accumulation.
//
// Replaces greptimedb_tpu/ops/rate.py:46 `strip_counter_resets_segmented`
// and :82 `strip_counter_resets` (B14): after a reset (a value below the
// previous fetched value of the same series) the pre-reset value is added
// to the series' running correction, so adjusted values never decrease.
//
// Bound on the H100: bytes — the row prologue's valid, ts and code planes
// and the strip's in_fetch, value and present mask read once per row, the
// adjusted value written once (30 B a row).  The reference takes a global
// prefix sum of the corrections and subtracts a per-series baseline; here
// one warp owns a series (the row prologue of rate_rows.cuh gives each
// series' first and last fetched row) and keeps a plain sequential f64
// sum in row order: equal to the reference on series without a reset
// (both add exactly 0.0), within the last ulp on series with one.
//
// Design.  Resets are rare (one host in 16 restarts), so a warp does not
// replay its rows one lane at a time.  Per group of 32 rows (lane l holds
// row base + l):
//   * a ballot of the fetched lanes gives each fetched lane the value of
//     the previous fetched row (one shuffle from the highest fetched lane
//     below it, else the value carried from the group before) and
//     whether there is one;
//   * resets = ballot(fetched && have && x < prev);
//   * the warp walks the set bits of `resets` in lane order: each adds
//     that lane's previous value to the running correction (__dadd_rn),
//     and the lanes at or above it take the new correction;
//   * each fetched lane writes __dadd_rn(x, its correction).
// The adds are the pre-reset values in row order, from 0.0, as in the
// replay of each row in turn: the same bytes.  A NaN compares false either
// side of `<`, and a fetched NaN is the next row's previous value, as in
// the replay.  A group without a reset takes no step; a reset on every row
// takes 32, as the replay did.
//
// Loads ahead.  A window of kStripGroups groups (32 * kStripGroups rows)
// has every in_fetch byte, value and present byte loaded before the first
// group is computed, so a warp keeps kStripGroups loads a plane in flight
// instead of one.  A window inside one chunk reads the chunk's pointers
// once (kept in registers while the window stays in that chunk), and its
// rows at offsets from them; a window across a chunk boundary looks each
// row up.  Outputs of rows that are not fetched are left unwritten.
//
// One entry point launches the layout's identities, the row prologue and
// the strip on the stream: one host call a K9 call.
#include "rate_rows.cuh"

// Groups of 32 rows a warp loads before it computes any: 8 keeps the
// strip at or under 64 registers, so the 4096 warps of 4096 series are
// resident at once (four 256-thread CTAs an SM).
constexpr int kStripGroups = 8;
constexpr unsigned kFull = 0xffffffffu;

struct StripArgs {
  RowPlanes rows;
  SeriesLayout layout;
  double* out;  // [n]
  int32_t kernels;  // out: the kernels this call launched
};

__global__ void __launch_bounds__(256, 4) strip_kernel(const StripArgs a) {
  const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= a.layout.num_series) return;  // uniform per warp
  const int64_t lo = a.layout.first[s], hi = a.layout.last[s];
  if (hi < 0) return;
  const RowPlanes& p = a.rows;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double acc = 0.0, pv = 0.0;
  bool have = false;
  int64_t cur = -1;  // the chunk whose pointers are held
  const double* vals = nullptr;
  const uint8_t* nulls = nullptr;
  for (int64_t base = lo; base <= hi; base += 32 * kStripGroups) {
    const int64_t end = base + 32 * kStripGroups - 1 < hi ? base + 32 * kStripGroups - 1 : hi;
    int64_t c0, o0, c1, o1;
    row_at(p, base, c0, o0);
    row_at(p, end, c1, o1);
    double x[kStripGroups];
    unsigned fetched = 0;  // bit u: this lane's row of group u is fetched
    if (c0 == c1) {
      if (c0 != cur) {
        cur = c0;
        vals = p.vals[c0];
        nulls = p.nulls != nullptr ? p.nulls[c0] : nullptr;
      }
      uint8_t f[kStripGroups], present[kStripGroups];
#pragma unroll
      for (int u = 0; u < kStripGroups; ++u) {
        const int64_t r = base + 32 * u + lane;
        const bool in = r <= hi;
        const int64_t o = o0 + 32 * u + lane;
        f[u] = in ? a.layout.in_fetch[r] : 0;
        x[u] = in ? vals[o] : 0.0;
        present[u] = in && nulls != nullptr ? nulls[o] : 1;
      }
#pragma unroll
      for (int u = 0; u < kStripGroups; ++u) {
        if (present[u] == 0) x[u] = nan;
        if (f[u] != 0) fetched |= 1u << u;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kStripGroups; ++u) {
        const int64_t r = base + 32 * u + lane;
        const bool f = r <= hi && a.layout.in_fetch[r] != 0;
        x[u] = f ? value_of(p, r) : 0.0;
        if (f) fetched |= 1u << u;
      }
    }
#pragma unroll
    for (int u = 0; u < kStripGroups; ++u) {
      const bool f = (fetched >> u) & 1u;
      const unsigned fm = __ballot_sync(kFull, f);
      if (fm == 0) continue;  // uniform per warp
      const unsigned below = fm & ((1u << lane) - 1u);
      const double from_below = __shfl_sync(kFull, x[u], below ? 31 - __clz(below) : 0);
      const double prev = below ? from_below : pv;
      const bool has_prev = below != 0 || have;
      unsigned resets = __ballot_sync(kFull, f && has_prev && x[u] < prev);
      double mine = acc;
      while (resets != 0) {  // uniform per warp: the reset lanes in order
        const int b = __ffs(resets) - 1;
        resets &= resets - 1u;
        acc = __dadd_rn(acc, __shfl_sync(kFull, prev, b));
        if (lane >= b) mine = acc;
      }
      if (f) a.out[base + 32 * u + lane] = __dadd_rn(x[u], mine);
      pv = __shfl_sync(kFull, x[u], 31 - __clz(fm));
      have = true;
    }
  }
}

GT_EXPORT int gt_strip_counter_resets(StripArgs* args, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const LayoutArgs layout = {args->rows, args->layout};
  args->kernels = 0;
  const int err = launch_series_layout(&layout, st, &args->kernels);
  if (err != 0) return err;
  const int64_t S = args->layout.num_series;
  if (S <= 0 || args->rows.n <= 0) return (int)cudaSuccess;
  const int64_t threads = S * 32;  // one warp per series
  strip_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(*args);
  ++args->kernels;
  return (int)cudaGetLastError();
}
