// K19 topk_distances: the k best rows of an [N, d] f32 matrix by distance
// to a query vector,
//   dots = mat @ q
//   dot:  d = dots
//   l2sq: d = sum(mat * mat, 1) - 2 * dots + dot(q, q)
//   cos:  d = 1 - where(denom > 0, dots / max(denom, 1e-30), 0),
//         denom = sqrt(sum(mat * mat, 1)) * sqrt(dot(q, q))
//   d = where(valid, d, ascending ? +inf : -inf);  score = ascending ? -d : d
//   (top, idx) = lax.top_k(score, k);  dist = ascending ? -top : top
// -> dist f32 [k], idx int64 [k].
//
// Replaces greptimedb_tpu/ops/vector.py:25 `topk_distances` (the jitted
// matvec + epilogue + lax.top_k behind `topk_host` at 100,000 rows and
// more: the `ORDER BY vec_*_distance(col, literal) LIMIT k` route).
//
// Order.  lax.top_k is a total order over the score's bits, ties to the
// lower index.  Each row gets one u64 key: the score's bits under the
// total-order flip (sign set: invert all; else set the sign) in the high
// half, the inverted row in the low half.  Every key differs, so the k
// largest keys are one set and one order.
//
// NaN.  The reference ranks on x86: an operation that makes a NaN from
// non-NaN operands gives the sign-set default NaN 0xFFC00000, and one on a
// NaN passes that NaN on; the card's NaN is positive.  A NaN distance is
// therefore replaced by the bits of the row's first NaN component
// (quieted), else of the query's, else by 0xFFC00000 (ops/vector.py).
// The epilogue uses the IEEE intrinsics, so nvcc contracts nothing into
// an FMA where the reference rounds twice.
//
// Bound on the H100: bytes.  The matrix is read once, N * d * 4 bytes
// (512 MB at SIFT1M's 1,000,000 x 128: 0.153 ms at 3.35 TB/s); the
// operations (4 * N * d flops) are 0.008 ms at 67 TFLOP/s.
//
// Design: select on the score.  A row's key is (hi << 32 | ~row),
// hi the score's flipped bits, and the low half only breaks ties at the
// k-th score; so the select works on hi and reads the matrix-sized data
// once.  Three kernels and a memset of the state at k <= 2048:
//   1. distance_hist_kernel: a warp per 32 consecutive rows, kRowsAhead
//      rows' loads (16 B a lane where d is a multiple of 4) issued before
//      any is added; each row's dots and sum(mat * mat) accumulated per
//      lane in the same order and added over the warp with the same pairs
//      as the fixed shuffle tree before (the distances keep their bits),
//      four rows reduce-scattered at once (7 shuffles, not 20), the
//      epilogue of lane l's row on lane l.  Only a row whose sum(mat *
//      mat) is NaN has a NaN component, so only such rows read their
//      components again for the first NaN's tag.  The warp writes its 32 hi
//      words at once and counts their first digit (hi's top kDigit1 bits:
//      the sign, the exponent and 3 mantissa bits) in a shared histogram,
//      one atomic per distinct digit of the warp; the CTA adds its
//      histogram to the state's, and the last CTA to finish picks the
//      digit D1 at which the count from the top reaches k.
//   2. candidates_kernel: every row whose hi has a first digit >= D1
//      goes, as its 64-bit key, into the candidate buffer (warp-aggregated
//      atomics, in no fixed order); those at D1 count their next kDigit2
//      bits into the second histogram.
//   3. final_kernel, one CTA: the second digit's pick, then 8-bit passes
//      over the candidates (the rest of hi, then the row) only while the
//      bin reached holds more keys than are still wanted: the k-th key's
//      prefix T, and the keys >= T are exactly the k largest.  It gathers
//      them into shared memory and sorts them (bitonic, largest first).
// Past k = 2048 the last kernel writes T instead, a compaction takes the
// keys >= T into `sel`, and the one-sweep radix sort of radix.cuh (shared
// with K14 and K18) orders them over the inverted keys, its last pass
// writing the outputs.  The order is the keys' alone, so the output is
// the same on every run, and the same set and order as a select over the
// whole 64-bit keys.  Few rows fall in the candidates on real scores; a
// tie-heavy or all-invalid input sends up to every row there, and the
// last CTA's passes then read them all (a path for the rare input, not a
// fallback).
#include "radix.cuh"

constexpr int kRowWarps = 8;    // warps of a CTA of pass 1, 32 rows each
constexpr int kRowsAhead = 4;   // rows whose loads a warp issues at once
constexpr int kSelThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr int kSmallK = 2048;   // ops/vector.py SMALL_K
constexpr int kDigit1 = 12;     // hi's bits of the first digit
constexpr int kDigit2 = 12;     // and of the second
constexpr int kBins = 1 << 12;  // both digits' bins
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSignBit = 0x80000000u;
constexpr uint32_t kQuietBit = 0x00400000u;
constexpr uint32_t kDefaultNaN = 0xFFC00000u;
constexpr u64 kNoNaN = ~0ull;

// The select's state on the card, zeroed by one memset a call (the
// wrapper sizes it: ops/vector.py STATE_WORDS int64 words).
struct TopkState {
  int32_t hist1[kBins];   // first digits of every row
  int32_t hist2[kBins];   // second digits of the rows at D1
  uint32_t done;          // CTAs of pass 1 finished
  uint32_t d1;            // the first digit of the k-th key
  uint32_t above1;        // rows whose first digit is above d1
  uint32_t n_cand;        // keys in the candidate buffer
  uint32_t n_sel;         // keys compacted into sel (k > kSmallK)
  uint32_t pad;
  u64 kth;                // T: the keys >= T are the k largest
};

// Mirrored field for field by _TopkArgs in ops/vector.py (ctypes).
struct TopkArgs {
  int64_t n;
  int64_t k;
  const float* mat;       // [n, d]
  const uint8_t* valid;   // [n]
  const float* q;         // [d]
  uint32_t* hi;           // [n] scratch: each row's flipped score
  u64* cand;              // [n] scratch: the candidates' keys
  u64* sel;               // [k] scratch (k > kSmallK): the k largest keys
  TopkState* state;       // scratch, zeroed here
  float* dist;            // [k] out
  int64_t* idx;           // [k] out
  int32_t d;
  int32_t metric;         // 0 dot, 1 l2sq, 2 cos
  int32_t ascending;
  int32_t vec4;           // d % 4 == 0 and both pointers 16-byte aligned
  int32_t kernels;        // out: kernels launched (memsets apart)
  int32_t memsets;        // out: memsets launched
  RadixPlan sort_plan;    // k > kSmallK: radix_plan(2^64 - 1)
  RadixScratch sort;      // k > kSmallK: its scratch
};

// (index << 32 | quieted bits) of a NaN component, or kNoNaN: the smallest
// tag of a row is its first NaN.
__device__ __forceinline__ u64 nan_tag(float v, int j) {
  return v != v ? (((u64)(uint32_t)j << 32) | (__float_as_uint(v) | kQuietBit)) : kNoNaN;
}

__device__ __forceinline__ u64 min_u64(u64 a, u64 b) { return a < b ? a : b; }

__device__ __forceinline__ void accumulate(float x, float y, float& dot, float& ss) {
  dot = fmaf(x, y, dot);
  ss = fmaf(x, x, ss);
}

// The warp sums of kRowsAhead (4) rows' per-lane values by the pairs of the
// butterfly v += shfl_xor(v, o), o = 16, 8, 4, 2, 1 (each row's sum has the
// same adds, so the same bits), reduce-scattered: at o = 16 a lane keeps
// rows {0, 1} or {2, 3} and trades the other two, at o = 8 one of those,
// then the butterfly on it.  Returns the sum of row (lane & 16 ? 2 : 0) +
// (lane & 8 ? 1 : 0): 7 shuffles for 4 rows in place of 20.
__device__ __forceinline__ float reduce_rows(const float (&v)[kRowsAhead], bool hi16, bool hi8) {
  static_assert(kRowsAhead == 4, "reduce_rows scatters four rows");
  float k0 = hi16 ? v[2] : v[0], k1 = hi16 ? v[3] : v[1];
  const float s0 = hi16 ? v[0] : v[2], s1 = hi16 ? v[1] : v[3];
  k0 += __shfl_xor_sync(kFull, s0, 16);
  k1 += __shfl_xor_sync(kFull, s1, 16);
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(kFull, k, o);
  return k;
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_min_u64(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v = min_u64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The row's flipped score: larger is better, ties to the lower row.
__device__ __forceinline__ uint32_t score_hi(int metric, int ascending, float dot, float ss,
                                             u64 nan, float qq, u64 qnan, bool valid) {
  float dd;
  if (metric == 0) {
    dd = dot;
  } else if (metric == 1) {
    dd = __fadd_rn(__fsub_rn(ss, __fmul_rn(2.0f, dot)), qq);
  } else {
    const float denom = __fmul_rn(__fsqrt_rn(ss), __fsqrt_rn(qq));
    const float sim = denom > 0.f ? __fdiv_rn(dot, fmaxf(denom, 1e-30f)) : 0.f;
    dd = __fsub_rn(1.0f, sim);
  }
  uint32_t bits = __float_as_uint(dd);
  if (dd != dd) {
    const u64 tag = nan != kNoNaN ? nan : qnan;
    bits = tag != kNoNaN ? (uint32_t)tag : kDefaultNaN;
  }
  if (!valid) bits = ascending ? 0x7F800000u : 0xFF800000u;
  const uint32_t s = ascending ? bits ^ kSignBit : bits;
  return (s & kSignBit) ? ~s : (s | kSignBit);
}

// The digit at which the count from the top of `h` (`bins` counts in
// shared memory) reaches `wanted`: writes it, the count above it and its
// own count to out[0..2].  Every thread of the CTA calls it; `scan` holds
// blockDim.x ints.
__device__ void pick_digit(const int32_t* h, int bins, int64_t wanted, int32_t* scan,
                           int64_t* out) {
  const int t = threadIdx.x, T = blockDim.x;
  const int chunk = bins > T ? bins / T : 1;
  const int owners = bins / chunk;
  // thread t owns bins [top - chunk, top), top = bins - t * chunk
  const int top = bins - t * chunk;
  int32_t own = 0;
  if (t < owners) {
    for (int b = top - chunk; b < top; ++b) own += h[b];
  }
  scan[t] = own;
  __syncthreads();
  for (int o = 1; o < T; o <<= 1) {  // inclusive scan from the top
    const int32_t add = t >= o ? scan[t - o] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const int64_t before = scan[t] - own;
  if (t < owners && own > 0 && before < wanted && wanted <= before + own) {
    int64_t above = before;
    for (int b = top - 1; b >= top - chunk; --b) {
      if (above + h[b] >= wanted) {
        out[0] = b;
        out[1] = above;
        out[2] = h[b];
        break;
      }
      above += h[b];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRowWarps * 32) distance_hist_kernel(const TopkArgs a) {
  __shared__ int32_t s_hist[kBins];
  __shared__ int32_t s_scan[kRowWarps * 32];
  __shared__ int64_t s_pick[3];
  __shared__ float s_qq;
  __shared__ u64 s_qnan;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d;
  for (int b = threadIdx.x; b < kBins; b += kRowWarps * 32) s_hist[b] = 0;
  if (warp == 0) {
    float qq = 0.f, unused = 0.f;
    u64 qnan = kNoNaN;
    for (int j = lane; j < d; j += 32) {
      accumulate(a.q[j], a.q[j], unused, qq);
      qnan = min_u64(qnan, nan_tag(a.q[j], j));
    }
    qq = warp_sum_f(qq);
    qnan = warp_min_u64(qnan);
    if (lane == 0) {
      s_qq = qq;
      s_qnan = qnan;
    }
  }
  __syncthreads();
  const float qq = s_qq;
  const u64 qnan = s_qnan;
  const float4* q4 = reinterpret_cast<const float4*>(a.q);
  // the lanes holding row u's sums after reduce_rows: (u >> 1) << 4 | (u & 1) << 3
  const bool hi16 = (lane & 16) != 0, hi8 = (lane & 8) != 0;
  for (int64_t row0 = ((int64_t)blockIdx.x * kRowWarps + warp) * 32; row0 < a.n;
       row0 += (int64_t)gridDim.x * kRowWarps * 32) {
    // lane l ends with the sums of row row0 + l
    float my_dot = 0.f, my_ss = 0.f;
    for (int r = 0; r < 32; r += kRowsAhead) {
      // XLA's dot of one component is the product itself (a -0 stays -0);
      // longer dots add onto +0.  Adding onto -0 keeps any sum unchanged.
      float dot[kRowsAhead], ss[kRowsAhead];
      const float* m[kRowsAhead];
      bool in[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        dot[u] = d == 1 ? -0.f : 0.f;
        ss[u] = 0.f;
        const int64_t row = row0 + r + u;
        in[u] = row < a.n;
        m[u] = a.mat + (in[u] ? row : 0) * d;
      }
      if (a.vec4) {
        for (int j = lane; j < (d >> 2); j += 32) {
          float4 x[kRowsAhead];
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) {  // streamed: each row is read once
            x[u] = in[u] ? __ldcs(reinterpret_cast<const float4*>(m[u]) + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          const float4 y = __ldg(q4 + j);
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) {
            accumulate(x[u].x, y.x, dot[u], ss[u]);
            accumulate(x[u].y, y.y, dot[u], ss[u]);
            accumulate(x[u].z, y.z, dot[u], ss[u]);
            accumulate(x[u].w, y.w, dot[u], ss[u]);
          }
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          float x[kRowsAhead];
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) x[u] = in[u] ? __ldcs(m[u] + j) : 0.f;
          const float y = __ldg(a.q + j);
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) accumulate(x[u], y, dot[u], ss[u]);
        }
      }
      const float rd = reduce_rows(dot, hi16, hi8), rs = reduce_rows(ss, hi16, hi8);
      // row r + u's sums to lane r + u
      const int u = lane - r;
      const int src = ((u >> 1) << 4 | (u & 1) << 3) & 31;
      const float gd = __shfl_sync(kFull, rd, src), gs = __shfl_sync(kFull, rs, src);
      if (u >= 0 && u < kRowsAhead) {
        my_dot = gd;
        my_ss = gs;
      }
    }
    // sum(mat * mat) is NaN exactly where a component is (its terms are
    // >= 0 or +inf): those rows, rare, read their components again for the
    // first NaN's tag
    u64 my_nan = kNoNaN;
    unsigned bad = __ballot_sync(kFull, row0 + lane < a.n && my_ss != my_ss);
    while (bad) {
      const int r = __ffs(bad) - 1;
      bad &= bad - 1;
      const float* m = a.mat + (row0 + r) * d;
      u64 nan = kNoNaN;
      for (int j = lane; j < d; j += 32) nan = min_u64(nan, nan_tag(m[j], j));
      nan = warp_min_u64(nan);
      if (lane == r) my_nan = nan;
    }
    const int64_t row = row0 + lane;
    const bool in = row < a.n;
    const uint32_t hi = score_hi(a.metric, a.ascending, my_dot, my_ss, my_nan, qq, qnan,
                                 in && a.valid[row] != 0);
    if (in) a.hi[row] = hi;
    const int digit = in ? (int)(hi >> (32 - kDigit1)) : kBins;
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < kBins && lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kRowWarps * 32) {
    if (s_hist[b]) atomicAdd(&a.state->hist1[b], s_hist[b]);
  }
  // the last CTA to finish picks the first digit of the k-th key
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&a.state->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int b = threadIdx.x; b < kBins; b += kRowWarps * 32) s_hist[b] = __ldcg(&a.state->hist1[b]);
  __syncthreads();
  pick_digit(s_hist, kBins, a.k, s_scan, s_pick);
  if (threadIdx.x == 0) {
    a.state->d1 = (uint32_t)s_pick[0];
    a.state->above1 = (uint32_t)s_pick[1];
  }
}

// Keys of the rows whose first digit is >= d1 into the candidate buffer;
// those at d1 count their second digit.
__global__ void __launch_bounds__(kSelThreads) candidates_kernel(const TopkArgs a) {
  __shared__ int32_t s_hist[kBins];
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) s_hist[b] = 0;
  __syncthreads();
  const uint32_t d1 = a.state->d1;
  const int lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kSelThreads; base < a.n;
       base += (int64_t)gridDim.x * kSelThreads) {
    const int64_t i = base + threadIdx.x;
    const uint32_t hi = i < a.n ? a.hi[i] : 0u;
    const uint32_t first = hi >> (32 - kDigit1);
    const bool take = i < a.n && first >= d1;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot == 0) continue;
    unsigned int at = 0;
    if (lane == 0) at = atomicAdd(&a.state->n_cand, (unsigned)__popc(ballot));
    at = __shfl_sync(kFull, at, 0);
    if (take) {
      a.cand[at + __popc(ballot & ((1u << lane) - 1u))] = ((u64)hi << 32) | (u64)(~(uint32_t)i);
    }
    const int digit = take && first == d1 ? (int)((hi >> (32 - kDigit1 - kDigit2)) & (kBins - 1))
                                          : kBins;
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < kBins && lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) {
    if (s_hist[b]) atomicAdd(&a.state->hist2[b], s_hist[b]);
  }
}

__device__ __forceinline__ void emit(float* dist, int64_t* idx, int ascending, int64_t i,
                                     u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  const uint32_t s = (hi & kSignBit) ? (hi & ~kSignBit) : ~hi;
  dist[i] = __uint_as_float(ascending ? s ^ kSignBit : s);
  idx[i] = (int64_t)(~(uint32_t)key);
}

// One CTA: the k-th key's prefix T from the second digit and, while the bin
// reached holds more keys than are still wanted, 8-bit passes over the
// candidates; then (k <= kSmallK) the keys >= T sorted largest first, or
// (k > kSmallK) T for the compaction.
__global__ void __launch_bounds__(kFinalThreads) final_kernel(const TopkArgs a) {
  __shared__ int32_t s_hist[kBins];
  __shared__ int32_t s_scan[kFinalThreads];
  __shared__ int64_t s_pick[3];
  __shared__ u64 s_keys[kSmallK];
  __shared__ uint32_t s_n;
  const int t = threadIdx.x, lane = t & 31;
  const TopkState* st = a.state;
  const int64_t n_cand = st->n_cand;
  for (int b = t; b < kBins; b += kFinalThreads) s_hist[b] = st->hist2[b];
  __syncthreads();
  int64_t wanted = a.k - (int64_t)st->above1;
  pick_digit(s_hist, kBins, wanted, s_scan, s_pick);
  u64 prefix = ((u64)st->d1 << kDigit2) | (u64)s_pick[0];
  int bits = kDigit1 + kDigit2;  // of the key, from the top, fixed so far
  wanted -= s_pick[1];
  int64_t count = s_pick[2];
  while (wanted != count && bits < 64) {  // uniform: every thread reads s_pick
    const int shift = 64 - bits - 8;
    __syncthreads();
    for (int b = t; b < 256; b += kFinalThreads) s_hist[b] = 0;
    __syncthreads();
    for (int64_t base = 0; base < n_cand; base += kFinalThreads) {
      const int64_t i = base + t;
      int digit = 256;
      if (i < n_cand) {
        const u64 key = a.cand[i];
        if ((key >> (shift + 8)) == prefix) digit = (int)((key >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], __popc(peers));
    }
    __syncthreads();
    pick_digit(s_hist, 256, wanted, s_scan, s_pick);
    prefix = (prefix << 8) | (u64)s_pick[0];
    bits += 8;
    wanted -= s_pick[1];
    count = s_pick[2];
  }
  const u64 kth = bits >= 64 ? prefix : prefix << (64 - bits);
  if (a.k > kSmallK) {
    if (t == 0) a.state->kth = kth;
    return;
  }
  // the k largest keys, all >= kth, into shared memory (any order), then
  // a bitonic sort of the next power of two, padded with 0 (every key is
  // above 0: its low half is an inverted row < 2^31)
  if (t == 0) s_n = 0;
  __syncthreads();
  for (int64_t base = 0; base < n_cand; base += kFinalThreads) {
    const int64_t i = base + t;
    const u64 key = i < n_cand ? a.cand[i] : 0ull;
    const bool take = i < n_cand && key >= kth;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot == 0) continue;
    uint32_t at = 0;
    if (lane == 0) at = atomicAdd(&s_n, (uint32_t)__popc(ballot));
    at = __shfl_sync(kFull, at, 0);
    const uint32_t pos = at + __popc(ballot & ((1u << lane) - 1u));
    if (take && pos < kSmallK) s_keys[pos] = key;
  }
  __syncthreads();
  int size = 2;
  while (size < a.k) size <<= 1;
  for (int i = (int)a.k + t; i < size; i += kFinalThreads) s_keys[i] = 0ull;
  __syncthreads();
  for (int span = 2; span <= size; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      for (int u = t; u < size / 2; u += kFinalThreads) {
        const int i = 2 * u - (u & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & span) == 0;
        const u64 x = s_keys[i], y = s_keys[j];
        if ((x < y) == desc) {
          s_keys[i] = y;
          s_keys[j] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = t; i < a.k; i += kFinalThreads) emit(a.dist, a.idx, a.ascending, i, s_keys[i]);
}

// k > kSmallK: every candidate key >= kth (exactly k of them) into sel.
__global__ void __launch_bounds__(kSelThreads) select_compact_kernel(const TopkArgs a) {
  const u64 kth = a.state->kth;
  const int64_t n_cand = a.state->n_cand;
  const int lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kSelThreads; base < n_cand;
       base += (int64_t)gridDim.x * kSelThreads) {
    const int64_t i = base + threadIdx.x;
    const u64 key = i < n_cand ? a.cand[i] : 0;
    const bool take = i < n_cand && key >= kth;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot == 0) continue;
    unsigned int at = 0;
    if (lane == 0) at = atomicAdd(&a.state->n_sel, (unsigned)__popc(ballot));
    at = __shfl_sync(kFull, at, 0);
    if (take) a.sel[at + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
}

// k > kSmallK: the survivors sorted by their inverted keys (largest
// first), the last pass emitting each.
struct SurvivorSrc {
  const u64* sel;
  __device__ __forceinline__ void load_items(int64_t base, int64_t n, u64 (&key)[kItems],
                                             int32_t (&row)[kItems]) const {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)k * 32;
      if (i < n) {
        key[k] = ~sel[i];
        row[k] = (int32_t)i;
      }
    }
  }
};

struct SurvivorDst {
  TopkArgs a;
  __device__ __forceinline__ void put(int64_t pos, u64 key, int32_t) const {
    emit(a.dist, a.idx, a.ascending, pos, ~key);
  }
};

// CTAs of a grid that strides over its rows: as many as the card holds at
// once (kernel `id`'s occupancy, asked once per device).
template <typename K>
static int resident_grid(int id, K kernel, int threads, int64_t work, int per_cta) {
  static int resident[3][64];
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < 64 ? dev : 0;
  if (resident[id][slot] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[id][slot] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const int64_t need = (work + per_cta - 1) / per_cta;
  return (int)(need < 1 ? 1 : (need < resident[id][slot] ? need : resident[id][slot]));
}

GT_EXPORT int gt_topk_distances(TopkArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TopkArgs& a = *args;
  a.kernels = a.memsets = 0;
  if (a.n <= 0 || a.k <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(a.state, 0, sizeof(TopkState), s);
  if (err != cudaSuccess) return (int)err;
  ++a.memsets;
  distance_hist_kernel<<<resident_grid(0, distance_hist_kernel, kRowWarps * 32, a.n, kRowWarps * 32),
                         kRowWarps * 32, 0, s>>>(a);
  candidates_kernel<<<resident_grid(1, candidates_kernel, kSelThreads, a.n, kSelThreads), kSelThreads,
                      0, s>>>(a);
  final_kernel<<<1, kFinalThreads, 0, s>>>(a);
  a.kernels += 3;
  if (a.k <= kSmallK) return (int)cudaGetLastError();
  select_compact_kernel<<<resident_grid(2, select_compact_kernel, kSelThreads, a.n, kSelThreads),
                          kSelThreads, 0, s>>>(a);
  ++a.kernels;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const SurvivorSrc src = {a.sel};
  const SurvivorDst dst = {a};
  err = onesweep_sort<u64>(src, dst, a.k, a.sort_plan, a.sort, Gate{nullptr, 0, 0}, s);
  a.kernels += a.sort.kernels;
  ++a.memsets;  // the sort's control words
  return (int)err;
}
