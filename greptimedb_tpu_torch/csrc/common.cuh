// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel file exports plain C entry points (loaded with ctypes by
// kernels/_build.py).  An entry point launches on the stream it is given,
// allocates nothing, never synchronises, and returns cudaGetLastError()
// right after its launches so a refused launch is reported at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GT_EXPORT extern "C" __attribute__((visibility("default")))

// Rows per block of the blocked kernels (ops/aggregate.py BLOCK_ROWS).
constexpr int kBlockRows = 4096;
// Threads per CTA of the per-block kernels: 16 rows per thread.
constexpr int kBlockThreads = 256;
constexpr int kRowsPerThread = kBlockRows / kBlockThreads;
// Window of consecutive group ids one block may touch (BLOCK_SPAN).
constexpr int kSpan = 16;

constexpr double kDblMax = 1.7976931348623157e308;  // finfo(float64).max
constexpr int64_t kInt64Min = (-0x7fffffffffffffffLL - 1);

// min/max that propagate NaN, as XLA's min/max (and torch.amin/amax) do.
__device__ __forceinline__ double nan_min(double a, double b) {
  if (a != a || b != b) return __longlong_as_double(0x7ff8000000000000LL);
  return b < a ? b : a;
}
__device__ __forceinline__ double nan_max(double a, double b) {
  if (a != a || b != b) return __longlong_as_double(0x7ff8000000000000LL);
  return b > a ? b : a;
}

// Lexicographic max of (ts, row): the later timestamp wins, and on a tie
// the later row.  Order-independent, so any reduction tree gives the same
// answer.
__device__ __forceinline__ void lex_max(int64_t& t, int32_t& r, int64_t t2, int32_t r2) {
  if (t2 > t || (t2 == t && r2 > r)) {
    t = t2;
    r = r2;
  }
}

// Deterministic warp reductions: a fixed shuffle tree, so the order of
// every f64 addition is the same on every run.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int32_t warp_sum_i(int32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ void warp_lex_max(int64_t& t, int32_t& r) {
  for (int o = 16; o > 0; o >>= 1) {
    int64_t t2 = __shfl_down_sync(0xffffffffu, t, o);
    int32_t r2 = __shfl_down_sync(0xffffffffu, r, o);
    lex_max(t, r, t2, r2);
  }
}

// First index i in [0, n) with a[i] >= key (n if none).
__device__ __forceinline__ int64_t lower_bound_i32(const int32_t* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if ((int64_t)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}
