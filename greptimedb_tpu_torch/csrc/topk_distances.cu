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
// Design.  Pass 1: a warp per row, 16-byte loads of the row and the query
// where d is a multiple of 4, dots and sum(mat * mat) accumulated per lane
// and added over the warp by a fixed shuffle tree, the epilogue, one key
// written per row (8 bytes, 1/64 of the row's bytes at d = 128).
// Pass 2: an MSB-first radix select of the k-th largest key: eight 8-bit
// digits, each a histogram pass over the keys still matching the chosen
// prefix (a shared histogram per block, one atomic per distinct digit of
// a warp) and a one-block pick of the digit where the count from the top
// reaches the k still wanted.  The state lives on the card, so no host
// read.  Then every key at or above the k-th is compacted (warp-aggregated
// atomics, in no fixed order) and the k survivors are sorted: one block's
// bitonic sort in shared memory up to 2048, else the one-sweep radix sort
// of radix.cuh (shared with K14 and K18) over the inverted keys, six
// passes whose last writes the outputs.  The order is the keys' alone,
// so the output is the same on every run.
#include "radix.cuh"

constexpr int kRowWarps = 8;  // rows in flight per block of pass 1
constexpr int kSelThreads = 256;
constexpr int kSmallK = 2048;  // ops/vector.py SMALL_K
constexpr int kSortThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSignBit = 0x80000000u;
constexpr uint32_t kQuietBit = 0x00400000u;
constexpr uint32_t kDefaultNaN = 0xFFC00000u;
constexpr u64 kNoNaN = ~0ull;

static int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  if (g > 132 * 32) g = 132 * 32;
  return g < 1 ? 1 : (int)g;
}

// Mirrored field for field by _TopkArgs in ops/vector.py (ctypes).
struct TopkArgs {
  int64_t n;
  int64_t k;
  const float* mat;       // [n, d]
  const uint8_t* valid;   // [n]
  const float* q;         // [d]
  u64* keys;              // [n] scratch: one key per row
  u64* sel;               // [k] scratch: the k largest keys
  u64* state;             // [4] scratch: prefix, mask, still wanted, survivors
  int32_t* hist;          // [256] scratch
  float* dist;            // [k] out
  int64_t* idx;           // [k] out
  int32_t d;
  int32_t metric;         // 0 dot, 1 l2sq, 2 cos
  int32_t ascending;
  int32_t vec4;           // d % 4 == 0 and both pointers 16-byte aligned
  RadixPlan sort_plan;    // k > kSmallK: radix_plan(2^64 - 1)
  RadixScratch sort;      // k > kSmallK: its scratch
};

// (index << 32 | quieted bits) of a NaN component, or kNoNaN: the smallest
// tag of a row is its first NaN.
__device__ __forceinline__ u64 nan_tag(float v, int j) {
  return v != v ? (((u64)(uint32_t)j << 32) | (__float_as_uint(v) | kQuietBit)) : kNoNaN;
}

__device__ __forceinline__ u64 min_u64(u64 a, u64 b) { return a < b ? a : b; }

__device__ __forceinline__ void accumulate(float x, float y, int j, float& dot, float& ss,
                                           u64& nan) {
  dot = fmaf(x, y, dot);
  ss = fmaf(x, x, ss);
  nan = min_u64(nan, nan_tag(x, j));
}

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ u64 warp_min_u64(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v = min_u64(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kRowWarps * 32) distance_keys_kernel(const TopkArgs a) {
  __shared__ float s_qq;
  __shared__ u64 s_qnan;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d;
  if (warp == 0) {
    float qq = 0.f, unused = 0.f;
    u64 qnan = kNoNaN;
    for (int j = lane; j < d; j += 32) accumulate(a.q[j], a.q[j], j, unused, qq, qnan);
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
  for (int64_t row = (int64_t)blockIdx.x * kRowWarps + warp; row < a.n;
       row += (int64_t)gridDim.x * kRowWarps) {
    const float* m = a.mat + row * d;
    // XLA's dot of one component is the product itself (a -0 stays -0);
    // longer dots add onto +0.  Adding onto -0 keeps any sum unchanged.
    float dot = d == 1 ? -0.f : 0.f, ss = 0.f;
    u64 nan = kNoNaN;
    if (a.vec4) {
      const float4* m4 = reinterpret_cast<const float4*>(m);
      const float4* q4 = reinterpret_cast<const float4*>(a.q);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 x = __ldcs(m4 + j);  // streamed: each row is read once
        const float4 y = __ldg(q4 + j);
        accumulate(x.x, y.x, 4 * j, dot, ss, nan);
        accumulate(x.y, y.y, 4 * j + 1, dot, ss, nan);
        accumulate(x.z, y.z, 4 * j + 2, dot, ss, nan);
        accumulate(x.w, y.w, 4 * j + 3, dot, ss, nan);
      }
    } else {
      for (int j = lane; j < d; j += 32) accumulate(__ldcs(m + j), __ldg(a.q + j), j, dot, ss, nan);
    }
    dot = warp_sum_f(dot);
    ss = warp_sum_f(ss);
    if (__any_sync(kFull, nan != kNoNaN)) nan = warp_min_u64(nan);
    if (lane == 0) {
      float dd;
      if (a.metric == 0) {
        dd = dot;
      } else if (a.metric == 1) {
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
      if (!a.valid[row]) bits = a.ascending ? 0x7F800000u : 0xFF800000u;
      const uint32_t s = a.ascending ? bits ^ kSignBit : bits;
      const uint32_t hi = (s & kSignBit) ? ~s : (s | kSignBit);
      a.keys[row] = ((u64)hi << 32) | (u64)(~(uint32_t)row);
    }
  }
}

__global__ void __launch_bounds__(kSelThreads) select_init_kernel(const TopkArgs a) {
  a.hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    a.state[0] = 0;  // prefix of the k-th key, digits chosen so far
    a.state[1] = 0;  // mask of those digits
    a.state[2] = (u64)a.k;  // keys still wanted among those matching the prefix
    a.state[3] = 0;  // survivors compacted
  }
}

// Digit counts of the keys matching the prefix so far.
__global__ void __launch_bounds__(kSelThreads) select_hist_kernel(const TopkArgs a, int shift) {
  __shared__ int32_t h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const u64 prefix = a.state[0], mask = a.state[1];
  const int lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kSelThreads; base < a.n;
       base += (int64_t)gridDim.x * kSelThreads) {
    const int64_t i = base + threadIdx.x;
    int digit = 256;  // past the end or off the prefix: counted nowhere
    if (i < a.n) {
      const u64 key = a.keys[i];
      if ((key & mask) == prefix) digit = (int)((key >> shift) & 255);
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
  }
  __syncthreads();
  if (h[threadIdx.x]) atomicAdd(&a.hist[threadIdx.x], h[threadIdx.x]);
}

// The digit where the count from the top reaches the keys still wanted;
// clears the histogram for the next digit.
__global__ void __launch_bounds__(256) select_pick_kernel(const TopkArgs a, int shift) {
  __shared__ int32_t at_or_above[256];
  const int t = threadIdx.x;
  const int64_t wanted = (int64_t)a.state[2];
  const int32_t c = a.hist[t];
  at_or_above[t] = c;
  __syncthreads();
  for (int o = 1; o < 256; o <<= 1) {
    const int32_t add = t + o < 256 ? at_or_above[t + o] : 0;
    __syncthreads();
    at_or_above[t] += add;
    __syncthreads();
  }
  const int64_t above = at_or_above[t] - c;
  if (c > 0 && above < wanted && wanted <= above + c) {
    a.state[0] |= (u64)t << shift;
    a.state[1] |= (u64)255 << shift;
    a.state[2] = (u64)(wanted - above);
  }
  a.hist[t] = 0;
}

// Every key at or above the k-th (exactly k of them) into sel.
__global__ void __launch_bounds__(kSelThreads) select_compact_kernel(const TopkArgs a) {
  const u64 kth = a.state[0];
  const int lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kSelThreads; base < a.n;
       base += (int64_t)gridDim.x * kSelThreads) {
    const int64_t i = base + threadIdx.x;
    const u64 key = i < a.n ? a.keys[i] : 0;
    const bool take = i < a.n && key >= kth;
    const unsigned ballot = __ballot_sync(kFull, take);
    if (ballot == 0) continue;
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd((unsigned long long*)&a.state[3], (unsigned long long)__popc(ballot));
    first = __shfl_sync(kFull, first, 0);
    if (take) a.sel[first + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
}

__device__ __forceinline__ void emit(const TopkArgs& a, int64_t i, u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  const uint32_t s = (hi & kSignBit) ? (hi & ~kSignBit) : ~hi;
  a.dist[i] = __uint_as_float(a.ascending ? s ^ kSignBit : s);
  a.idx[i] = (int64_t)(~(uint32_t)key);
}

// k <= kSmallK: a bitonic sort of the survivors, largest first, padded
// with 0 (every key is above 0: its low half is an inverted row < 2^31).
__global__ void __launch_bounds__(kSortThreads) small_sort_kernel(const TopkArgs a) {
  __shared__ u64 s[kSmallK];
  for (int i = threadIdx.x; i < kSmallK; i += kSortThreads) s[i] = i < a.k ? a.sel[i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= kSmallK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kSmallK / 2; t += kSortThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const u64 x = s[i], y = s[j];
        if ((x < y) == desc) {
          s[i] = y;
          s[j] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < a.k; i += kSortThreads) emit(a, i, s[i]);
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
  __device__ __forceinline__ void put(int64_t pos, u64 key, int32_t) const { emit(a, pos, ~key); }
};

GT_EXPORT int gt_topk_distances(TopkArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TopkArgs& a = *args;
  if (a.n <= 0 || a.k <= 0) return (int)cudaSuccess;
  int64_t rows_grid = (a.n + kRowWarps - 1) / kRowWarps;
  if (rows_grid > 132 * 16) rows_grid = 132 * 16;
  distance_keys_kernel<<<(unsigned)rows_grid, kRowWarps * 32, 0, s>>>(a);
  select_init_kernel<<<1, kSelThreads, 0, s>>>(a);
  const int sel_grid = grid_for(a.n, kSelThreads);
  for (int shift = 56; shift >= 0; shift -= 8) {
    select_hist_kernel<<<sel_grid, kSelThreads, 0, s>>>(a, shift);
    select_pick_kernel<<<1, 256, 0, s>>>(a, shift);
  }
  select_compact_kernel<<<sel_grid, kSelThreads, 0, s>>>(a);
  if (a.k <= kSmallK) {
    small_sort_kernel<<<1, kSortThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const SurvivorSrc src = {a.sel};
  const SurvivorDst dst = {a};
  return (int)onesweep_sort<u64>(src, dst, a.k, a.sort_plan, a.sort, Gate{nullptr, 0, 0}, s);
}
