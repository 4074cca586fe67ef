// K5 quantize_limbs: per-block fixed-point encode of one value column into
// four base-256 digits stored as bfloat16, one CTA per 4096-row block.
//
// Replaces greptimedb_tpu/ops/aggregate.py:259 `quantize_limbs`.  For each
// block: v <- nan_to_num(v) (NaN -> 0, +-inf -> +-1e308), amax = max |v|,
// e = ceil(log2(max(amax, 1e-30))), q = rint(v * 2^(29 - e)) + 2^29, and
// the digits (q >> 8j) & 255, j = 0..3; scale = 2^(e - 29).
//
// Bound on the H100: bytes.  Each value is read once (8 B) and four
// bfloat16 digits are written (8 B); the two passes of a block (amax,
// then encode) read the same 32 KB, the second time from L1/L2.  A thread
// owns 16 rows (rows t, t + 256, ...: coalesced), keeps them in
// registers between the two passes, and writes its four digits with one
// 8-byte store per row.
//
// Matching the reference bit for bit: XLA computes log2(x) as
// log(x) * (1 / log 2) and exp2(x) as exp(log 2 * x), and neither is
// exact at the edges.  The exponent is therefore computed as the
// reference's arithmetic gives it: away from a power of two (|amax / 2^k
// - 1| >= 2^-30) the rounding cannot reach an integer and
// e = the frexp exponent; near 2^k the correctly rounded log is formed as
// k * ln2_hi + (k * ln2_lo + log1p(d)) and multiplied by the rounded
// 1 / log 2, with every operation rounded on its own (no FMA
// contraction).  The factors 2^(29 - e) and 2^(e - 29) come from the
// caller's table of exp(log 2 * x), one entry per possible e.
#include "common.cuh"

constexpr int kLimbQExp = 29;
// e ranges over ceil(log2(1e-30)) .. ceil(log2(DBL_MAX))
constexpr int kEMin = -99;
constexpr int kEMax = 1024;

struct QuantizeArgs {
  int64_t nb;
  const double* values;     // [nb * 4096]
  const double* inv_tab;    // [kEMax - kEMin + 1]: exp(ln2 * (29 - e))
  const double* scale_tab;  // [kEMax - kEMin + 1]: exp(ln2 * (e - 29))
  uint2* limbs;             // [nb, 4096] x 4 bfloat16 digits
  double* scale;            // [nb]
};

// The reference's ceil(log(a) * (1 / log 2)) for a >= 1e-30.
__device__ __forceinline__ int limb_exponent(double a) {
  int E;
  const double m = frexp(a, &E);  // a = m * 2^E, m in [0.5, 1)
  const bool near_lo = m < 0.75;
  const int k = near_lo ? E - 1 : E;
  // a / 2^k - 1, exact: the ratio lies in [0.75, 1.5)
  const double d = near_lo ? __dsub_rn(__dmul_rn(2.0, m), 1.0) : __dsub_rn(m, 1.0);
  if (fabs(d) >= 0x1p-30) return E;
  const double kd = (double)k;
  const double ln2_hi = 6.93147180369123816490e-01;  // 32 significant bits
  const double ln2_lo = 1.90821492927058770002e-10;
  const double l1p = __dsub_rn(d, __dmul_rn(__dmul_rn(0.5, d), d));
  const double lo = __dadd_rn(__dmul_rn(kd, ln2_lo), l1p);
  const double L = __dadd_rn(__dmul_rn(kd, ln2_hi), lo);  // k * ln2_hi is exact
  const double inv_ln2 = 1.0 / 0.6931471805599453;
  return (int)ceil(__dmul_rn(L, inv_ln2));
}

__device__ __forceinline__ double nan_to_num(double v) {
  if (v != v) return 0.0;
  if (isinf(v)) return v > 0 ? 1e308 : -1e308;
  return v;
}

__device__ __forceinline__ uint32_t bf16_digit(int32_t d) {
  return __float_as_uint((float)d) >> 16;  // d in [0, 255]: exact
}

__global__ void __launch_bounds__(kBlockThreads) quantize_kernel(const QuantizeArgs a) {
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const double* v = a.values + b * kBlockRows;
  __shared__ double s_max[kBlockThreads / 32];
  __shared__ int s_e;
  double x[kRowsPerThread];
  double amax = 0.0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    x[i] = nan_to_num(v[t + i * kBlockThreads]);
    amax = fmax(amax, fabs(x[i]));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmax(amax, __shfl_down_sync(0xffffffffu, amax, o));
  if (lane == 0) s_max[warp] = amax;
  __syncthreads();
  if (t == 0) {
    double m = s_max[0];
    for (int w = 1; w < kBlockThreads / 32; ++w) m = fmax(m, s_max[w]);
    const int e = min(max(limb_exponent(fmax(m, 1e-30)), kEMin), kEMax);
    s_e = e;
    a.scale[b] = a.scale_tab[e - kEMin];
  }
  __syncthreads();
  const double inv = a.inv_tab[s_e - kEMin];
  uint2* out = a.limbs + b * kBlockRows;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int32_t q = (int32_t)rint(__dmul_rn(x[i], inv)) + (1 << kLimbQExp);
    uint2 w;
    w.x = bf16_digit(q & 0xFF) | (bf16_digit((q >> 8) & 0xFF) << 16);
    w.y = bf16_digit((q >> 16) & 0xFF) | (bf16_digit((q >> 24) & 0xFF) << 16);
    out[t + i * kBlockThreads] = w;
  }
}

GT_EXPORT int gt_quantize_limbs(const QuantizeArgs* args, void* stream) {
  if (args->nb <= 0) return (int)cudaSuccess;
  quantize_kernel<<<(unsigned)args->nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
