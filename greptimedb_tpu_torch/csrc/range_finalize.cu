// K11 range_finalize: merge the regions' window statistics, then the
// range function, per cell.
//
// Replaces greptimedb_tpu/ops/rate.py:307 `merge_disjoint_stats`, :263
// `extrapolated_rate_dyn` (Prometheus extrapolatedRate for rate, increase
// and delta), :331 `over_time` and the `__last_ts` branch of
// query/promql/tile_exec.py:180 `_finalize` (B16).  Elementwise over the
// [S * W] cells: the first region (in region order) with a sample in the
// cell owns it — regions hold disjoint series, so the merge is pure
// selection — then the function; NaN where it is undefined (fewer than 2
// samples for the rate family, none for the rest).
//
// Bound on the H100: bytes — one region's stats (60 B) read and 8 B
// written per cell.  Every product, quotient, sum and difference goes
// through a round-to-nearest intrinsic, so nvcc cannot contract a*b+c
// into an FMA: each f64 operation rounds on its own, as XLA's does, and
// the kernel equals its plain version byte for byte on equal stats.
#include "common.cuh"

struct RegionStats {
  const int32_t* count;
  const int64_t* first_ts;
  const int64_t* last_ts;
  const double* first_val;
  const double* last_val;
  const double* sum;
  const double* mn;
  const double* mx;
};

struct FinalizeArgs {
  const RegionStats* regions;  // device table [n_regions]
  double* out;                 // [n_cells]
  int64_t n_cells, n_steps;
  int64_t start, step, range;
  int32_t n_regions, func;
};

// ops/rate.py FUNC_CODES
enum Func {
  kRate = 0, kIncrease, kDelta, kAvg, kSum, kMin, kMax, kCount, kLast, kLastTs,
};

__device__ __forceinline__ int64_t wrap_sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

__global__ void __launch_bounds__(256) finalize_kernel(const FinalizeArgs a) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= a.n_cells) return;
  int owner = a.n_regions - 1;
  for (int i = 0; i < a.n_regions - 1; ++i) {
    if (a.regions[i].count[cell] > 0) {
      owner = i;
      break;
    }
  }
  const RegionStats st = a.regions[owner];
  const int32_t cnt = st.count[cell];
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  double value;
  bool defined;
  if (a.func <= kDelta) {
    const int64_t fts = st.first_ts[cell], lts = st.last_ts[cell];
    const double fv = st.first_val[cell], lv = st.last_val[cell];
    const int64_t w = cell % a.n_steps;
    const int64_t t_end = a.start + w * a.step;
    const int64_t t_start = t_end - a.range;
    defined = cnt >= 2;
    const double si = (double)wrap_sub(lts, fts);
    const int32_t safe_count = cnt > 2 ? cnt : 2;
    const double avg_between = __ddiv_rn(si, (double)(safe_count - 1));
    const double dur_to_start = (double)wrap_sub(fts, t_start);
    const double dur_to_end = (double)wrap_sub(t_end, lts);
    const double threshold = __dmul_rn(avg_between, 1.1);
    const double half = __ddiv_rn(avg_between, 2.0);
    double extend_start = dur_to_start < threshold ? dur_to_start : half;
    const double extend_end = dur_to_end < threshold ? dur_to_end : half;
    const double result = __dsub_rn(lv, fv);
    if (a.func != kDelta) {
      // a counter cannot extrapolate below zero at the window start
      const double zero_dur = result > 0
          ? __dmul_rn(si, __ddiv_rn(fv, result == 0 ? 1.0 : result))
          : (double)INFINITY;
      extend_start = nan_min(extend_start, zero_dur < 0 ? extend_start : zero_dur);
    }
    const double extrapolate_to = __dadd_rn(__dadd_rn(si, extend_start), extend_end);
    const double safe_si = si == 0 ? 1.0 : si;
    value = __dmul_rn(result, __ddiv_rn(extrapolate_to, safe_si));
    if (a.func == kRate) value = __ddiv_rn(value, __ddiv_rn((double)a.range, 1000.0));
  } else {
    defined = cnt >= 1;
    switch (a.func) {
      case kAvg: value = __ddiv_rn(st.sum[cell], (double)(cnt > 1 ? cnt : 1)); break;
      case kSum: value = st.sum[cell]; break;
      case kMin: value = st.mn[cell]; break;
      case kMax: value = st.mx[cell]; break;
      case kCount: value = (double)cnt; break;
      case kLast: value = st.last_val[cell]; break;
      default: value = __ddiv_rn((double)st.last_ts[cell], 1000.0); break;
    }
  }
  a.out[cell] = defined ? value : nan;
}

GT_EXPORT int gt_range_finalize(const FinalizeArgs* args, void* stream) {
  if (args->n_cells <= 0) return (int)cudaSuccess;
  finalize_kernel<<<(unsigned)((args->n_cells + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
