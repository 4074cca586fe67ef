// K7 topk_select: the first `cap` groups of the total order
//   (survivor first, then per key: null bucket, value; then group id)
// over finalized [G] states: the device half of ORDER BY / LIMIT pushdown
// and, with no key, of empty-group compaction.
//
// Replaces greptimedb_tpu/ops/aggregate.py:1031 `topk_group_select` (B9),
// a multi-operand `lax.sort` over every group.  lax.sort compares floats
// in a total order after canonicalizing them (-0.0 equals 0.0, every NaN
// is one NaN above +inf); descending keys are sorted as -v, so NaN stays
// last both ways.  Here every key is mapped once to an int64 whose signed
// order is that order, and the group id breaks ties, so any correct sort
// gives the reference's bytes.
//
// Bound on the H100: bytes for the no-key form (one read of the [G] mask,
// `cap` ids written); the keyed form is bounded by its sorting network,
// O(G log^2 1024) compare-exchanges, which is small at the main path's
// shapes (G of a few thousand groups).  Design: with keys, each CTA sorts
// a chunk of 1024 candidates in shared memory (bitonic network) and keeps
// its first `cap`; rounds of the same kernel over the kept candidates
// merge them until one chunk is left, so `cap` must stay below the chunk
// (512 at most: larger keyed caps raise in the wrapper, and the planner
// never asks for them).  Without keys the order is survivors then the
// rest, each in group order: one CTA streams the mask in tiles of 1024
// with a block-wide prefix sum and writes the positions below `cap`.
#include "common.cuh"

constexpr int kChunk = 1024;
constexpr int kSortThreads = 512;
constexpr int kMaxKeys = 4;

struct TopkKeys {
  const uint8_t* mask;                 // [G] survivors
  const void* values[kMaxKeys];        // [G] float64 or int64
  const uint8_t* isnull[kMaxKeys];     // [G] or nullptr
  int32_t is_float[kMaxKeys];
  int32_t ascending[kMaxKeys];
  int32_t nulls_first[kMaxKeys];
  int32_t n_keys;
  int32_t num_groups;
};

struct TopkRound {
  TopkKeys keys;
  const int32_t* cand;  // [n_cand] group ids (-1: empty), or nullptr = 0..G-1
  int64_t n_cand;
  int32_t* out;         // [n_chunks * cap]
  int32_t* n_out;       // survivors counted here in the first round, or nullptr
  int32_t cap;
  int32_t reserved;
};

struct CompactArgs {
  const uint8_t* mask;
  int32_t* sel;    // [cap]
  int32_t* n_out;  // [1]
  int64_t num_groups;
  int32_t cap;
  int32_t reserved;
};

// A float's position in lax.sort's total order as a signed int64.
__device__ __forceinline__ int64_t float_order(double v) {
  if (v != v) return 0x7ff8000000000000LL;  // the one NaN, above +inf
  if (v == 0.0) return 0;                    // -0.0 == 0.0
  const int64_t b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

// (null bucket, value order) of key k for group g.
__device__ __forceinline__ void key_of(const TopkKeys& K, int k, int32_t g, int32_t& nb, int64_t& v) {
  const bool null = K.isnull[k] != nullptr && K.isnull[k][g] != 0;
  nb = null ? (K.nulls_first[k] ? -1 : 1) : 0;
  if (K.is_float[k]) {
    double x = null ? 0.0 : ((const double*)K.values[k])[g];
    v = float_order(K.ascending[k] ? x : -x);
  } else {
    const int64_t x = null ? 0 : ((const int64_t*)K.values[k])[g];
    v = K.ascending[k] ? x : (int64_t)(0ULL - (uint64_t)x);  // wrapping negation
  }
}

__global__ void __launch_bounds__(kSortThreads) topk_round_kernel(const TopkRound a) {
  __shared__ int32_t s_gid[kChunk];
  __shared__ uint8_t s_surv[kChunk];
  __shared__ int8_t s_nb[kMaxKeys][kChunk];
  __shared__ int64_t s_val[kMaxKeys][kChunk];
  __shared__ int16_t s_perm[kChunk];
  __shared__ int32_t s_count;
  const int t = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const TopkKeys& K = a.keys;
  if (t == 0) s_count = 0;
  __syncthreads();
  int32_t local = 0;
  for (int i = t; i < kChunk; i += kSortThreads) {
    const int64_t ci = c0 + i;
    int32_t g = -1;
    if (ci < a.n_cand) g = a.cand == nullptr ? (int32_t)ci : a.cand[ci];
    s_gid[i] = g;
    s_perm[i] = (int16_t)i;
    if (g >= 0) {
      const bool surv = K.mask[g] != 0;
      s_surv[i] = surv ? 0 : 1;
      local += surv ? 1 : 0;
      for (int k = 0; k < K.n_keys; ++k) {
        int32_t nb;
        int64_t v;
        key_of(K, k, g, nb, v);
        s_nb[k][i] = (int8_t)nb;
        s_val[k][i] = v;
      }
    }
  }
  if (a.n_out != nullptr && local) atomicAdd(&s_count, local);
  __syncthreads();
  if (a.n_out != nullptr && t == 0 && s_count) atomicAdd(a.n_out, s_count);

  // less(x, y) over chunk slots; empty slots (-1) are the largest
  auto less = [&](int x, int y) -> bool {
    const int32_t gx = s_gid[x], gy = s_gid[y];
    if (gx < 0 || gy < 0) return gx >= 0 && gy < 0;
    if (s_surv[x] != s_surv[y]) return s_surv[x] < s_surv[y];
    for (int k = 0; k < K.n_keys; ++k) {
      if (s_nb[k][x] != s_nb[k][y]) return s_nb[k][x] < s_nb[k][y];
      if (s_val[k][x] != s_val[k][y]) return s_val[k][x] < s_val[k][y];
    }
    return gx < gy;
  };
  // bitonic sort of s_perm by less()
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = t; i < kChunk / 2; i += kSortThreads) {
        const int lo = (i / stride) * stride * 2 + (i % stride);
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int px = s_perm[lo], py = s_perm[hi];
        if (less(py, px) == up) {
          s_perm[lo] = (int16_t)py;
          s_perm[hi] = (int16_t)px;
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < a.cap; i += kSortThreads) {
    a.out[(int64_t)blockIdx.x * a.cap + i] = s_gid[s_perm[i]];
  }
}

__global__ void __launch_bounds__(1024) topk_compact_kernel(const CompactArgs a) {
  __shared__ int32_t s_warp[32];
  __shared__ int32_t s_total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // pass 1: the survivor count
  int32_t cnt = 0;
  for (int64_t g = t; g < a.num_groups; g += 1024) cnt += a.mask[g] != 0 ? 1 : 0;
  cnt = warp_sum_i(cnt);
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (t == 0) {
    int32_t s = 0;
    for (int w = 0; w < 32; ++w) s += s_warp[w];
    s_total = s;
    *a.n_out = s;
  }
  __syncthreads();
  const int32_t total = s_total;
  // pass 2: survivors at [0, total), the others after them, each in group order
  int32_t surv_off = 0, rest_off = total;
  for (int64_t g0 = 0; g0 < a.num_groups && (surv_off < a.cap || rest_off < a.cap); g0 += 1024) {
    const int64_t g = g0 + t;
    const int32_t s = (g < a.num_groups && a.mask[g] != 0) ? 1 : 0;
    const int32_t r = (g < a.num_groups && s == 0) ? 1 : 0;
    // inclusive warp scans of s and r
    int32_t ss = s, rr = r;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t x = __shfl_up_sync(0xffffffffu, ss, o);
      const int32_t y = __shfl_up_sync(0xffffffffu, rr, o);
      if (lane >= o) {
        ss += x;
        rr += y;
      }
    }
    __syncthreads();
    if (lane == 31) s_warp[warp] = (ss << 16) | rr;  // each at most 1024
    __syncthreads();
    int32_t ps = 0, pr = 0, ts = 0, tr = 0;
    for (int w = 0; w < 32; ++w) {
      const int32_t sw = s_warp[w] >> 16, rw = s_warp[w] & 0xFFFF;
      if (w < warp) {
        ps += sw;
        pr += rw;
      }
      ts += sw;
      tr += rw;
    }
    if (s) {
      const int32_t pos = surv_off + ps + ss - 1;
      if (pos < a.cap) a.sel[pos] = (int32_t)g;
    } else if (r) {
      const int32_t pos = rest_off + pr + rr - 1;
      if (pos < a.cap) a.sel[pos] = (int32_t)g;
    }
    surv_off += ts;
    rest_off += tr;
  }
}

GT_EXPORT int gt_topk_round(const TopkRound* args, void* stream) {
  const int64_t chunks = (args->n_cand + kChunk - 1) / kChunk;
  if (chunks <= 0) return (int)cudaSuccess;
  topk_round_kernel<<<(unsigned)chunks, kSortThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_topk_compact(const CompactArgs* args, void* stream) {
  topk_compact_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
