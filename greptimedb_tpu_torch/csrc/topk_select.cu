// K7 topk_select: the first `cap` groups of the total order
//   (survivor first, then per key: null bucket, value; then group id)
// over finalized [G] states: the device half of ORDER BY / LIMIT pushdown
// and, with no key, of empty-group compaction.
//
// Replaces greptimedb_tpu/ops/aggregate.py:1031 `topk_group_select` (B9),
// a multi-operand `lax.sort` over every group.  lax.sort compares floats
// in a total order after canonicalizing them (-0.0 equals 0.0, every NaN
// is one NaN above +inf); descending keys are sorted as -v, so NaN stays
// last both ways.  Here every key is mapped to an int64 whose signed order
// is that order (group_ref.cuh `group_order_key`), and the group id breaks
// ties, so any correct selection gives the reference's bytes.
//
// The keys and the survivor gate are read from the states as they lie
// (group_ref.cuh: a value plane with a count plane NULL where 0 or NaN as
// NULL, an explicit NULL plane, or a dim coordinate of the group id; the
// gate a mask, or a count plane read as > 0), so no torch op runs before
// this kernel.  Every launch writes its outputs whole: `sel`, and `n_out`
// (the survivor count) from a sum of its own, with no zeroed buffer and no
// atomic.
//
// Bound on the H100: bytes (the gate and each key's planes read once,
// `cap` ids and the count written); at the main path's shapes (G of a few
// hundred to a few tens of thousands) the launch dominates.  Design:
//  * cap <= 32 (the LIMITs of dashboards and TSBS): a select, not a sort.
//    One launch of a cluster of kClusterCtas CTAs.  Each warp walks
//    batches of 32 consecutive groups (coalesced loads, kAhead batches'
//    loads issued before any is used) and keeps its best 32 sorted across
//    its lanes (lane i the i-th).  A batch none of whose groups beats the
//    warp's cap-th best drops at one ballot; up to kInsertMax that do are
//    inserted one by one (a ballot finds the place, the entries after it
//    move one lane up); more are sorted in the warp (bitonic, shuffles)
//    and merged with the list (the lower half of a bitonic merge).  The
//    compares and exchanges are selects, never branches on the outcome:
//    a warp's lanes compare different entries.  The warps' lists merge
//    pairwise in shared memory, then the CTAs' through distributed shared
//    memory on the cluster's first CTA, which writes `sel` and `n_out`.
//    Past TOPK_ONE_LAUNCH_GROUPS groups (ops/aggregate.py
//    `topk_launch_plan`; tools/select_variants.py times the constants and
//    the threshold) a grid of clusters writes each its top `cap` and its
//    survivor count, and one more cluster merges those lists: two
//    launches, no counter shared between them.
//  * 32 < cap <= 512: each CTA sorts a chunk of 1024 candidates in shared
//    memory (bitonic network) and keeps its first `cap`; rounds of the same
//    kernel over the kept candidates merge them until one chunk is left,
//    which writes `sel`.  Larger keyed caps raise in the wrapper, and the
//    planner never asks for them.
//  * no key: the order is survivors then the rest, each in group order:
//    one launch of a cluster, each CTA a contiguous range of the gate,
//    the ranges' survivor counts exchanged in distributed shared memory,
//    then one block-wide prefix sum a tile; positions below `cap` written.
#include <cooperative_groups.h>

#include "common.cuh"
#include "group_ref.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxKeys = 4;
constexpr int kSelectThreads = 512;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kClusterCtas = 8;
constexpr int kChunk = 1024;
constexpr int kSortThreads = 512;

// Mirrored field for field by _TopkArgs in ops/aggregate.py (ctypes).
struct TopkArgs {
  GroupRef keys[kMaxKeys];
  const void* gate;           // [G] survivors: kU8 mask (nonzero) or a kI32/kI64 count (> 0)
  const int32_t* cand;        // [n_cand] group ids (-1: none) of a merge, or nullptr: 0..n_cand-1
  int32_t* out;               // [grid units * cap]: sel, or one list per unit before a merge
  int32_t* n_out;             // [1], written by the launch that ends the call, or nullptr
  int32_t* counts_out;        // [grid units] survivors seen by each unit, or nullptr
  const int32_t* counts_in;   // [n_counts_in] an earlier launch's counts, summed into n_out
  int32_t gate_type;
  int32_t n_keys;
  int32_t ascending;          // bit k: key k ascending
  int32_t nulls_first;        // bit k: key k puts NULLs first
  int32_t n_cand;
  int32_t cap;
  int32_t n_counts_in;
  int32_t units;              // clusters of a select launch
  int32_t num_groups;         // G of the call (the first launch's n_cand)
  int32_t reserved;
};

__device__ __forceinline__ bool gate_open(const TopkArgs& a, uint32_t g) {
  switch (a.gate_type) {
    case kI32: return __ldg((const int32_t*)a.gate + g) > 0;
    case kI64: return __ldg((const long long*)a.gate + g) > 0;
    default: return __ldg((const uint8_t*)a.gate + g) != 0;
  }
}

template <int U>
__device__ __forceinline__ void gate_rows(const TopkArgs& a, const uint32_t (&g)[U],
                                          bool (&open)[U]) {
  switch (a.gate_type) {
    case kI32:
#pragma unroll
      for (int u = 0; u < U; ++u) open[u] = __ldg((const int32_t*)a.gate + g[u]) > 0;
      return;
    case kI64:
#pragma unroll
      for (int u = 0; u < U; ++u) open[u] = __ldg((const long long*)a.gate + g[u]) > 0;
      return;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u) open[u] = __ldg((const uint8_t*)a.gate + g[u]) != 0;
      return;
  }
}

// n_out of a launch that merges earlier launches' lists
__device__ __forceinline__ int32_t summed_counts(const TopkArgs& a) {
  int32_t s = 0;
  for (int i = 0; i < a.n_counts_in; ++i) s += a.counts_in[i];
  return s;
}

// ---- the select (cap <= 32) ----------------------------------------------------------

// One candidate of the order: h = (not a survivor) << 2 | (null bucket of
// key 0) + 1, all ones for no candidate (after every group); v[k] key k's
// value order; nbs the null buckets (+1) of keys 1.. two bits each.
template <int NK>
struct Ent {
  int64_t v[NK];
  uint32_t h;
  uint32_t nbs;
  int32_t gid;
};

template <int NK>
__device__ __forceinline__ Ent<NK> no_ent() {
  Ent<NK> e;
#pragma unroll
  for (int k = 0; k < NK; ++k) e.v[k] = 0;
  e.h = 0xffffffffu;
  e.nbs = 0;
  e.gid = -1;
  return e;
}

// a < b in the order, without a branch: the lanes of a warp compare
// different entries, and a branch on the outcome would split them
template <int NK>
__device__ __forceinline__ bool ent_less(const Ent<NK>& a, const Ent<NK>& b) {
  bool lt = a.h < b.h, eq = a.h == b.h;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    if (k > 0) {
      const uint32_t na = (a.nbs >> (2 * (k - 1))) & 3u, nb = (b.nbs >> (2 * (k - 1))) & 3u;
      lt |= eq & (na < nb);
      eq &= na == nb;
    }
    lt |= eq & (a.v[k] < b.v[k]);
    eq &= a.v[k] == b.v[k];
  }
  return lt | (eq & (a.gid < b.gid));
}

// take ? b : a, field by field (selects, no branch)
template <int NK>
__device__ __forceinline__ Ent<NK> ent_pick(bool take, const Ent<NK>& a, const Ent<NK>& b) {
  Ent<NK> o;
#pragma unroll
  for (int k = 0; k < NK; ++k) o.v[k] = take ? b.v[k] : a.v[k];
  o.h = take ? b.h : a.h;
  o.nbs = take ? b.nbs : a.nbs;
  o.gid = take ? b.gid : a.gid;
  return o;
}

// The entries of U candidates (gid < 0: none); every plane's loads for
// all U issue before any entry is built.  Adds the survivors among them
// to *surv_count.
template <int NK, int U>
__device__ __forceinline__ void load_ents(const TopkArgs& a, const int32_t (&gid)[U],
                                          Ent<NK> (&e)[U], int32_t& surv_count) {
  uint32_t g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) g[u] = gid[u] >= 0 ? (uint32_t)gid[u] : 0u;
  bool surv[U];
  gate_rows<U>(a, g, surv);
  int64_t raw[NK][U];
  bool null[NK][U];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    group_raw<U>(a.keys[k], g, raw[k]);
    group_nulls<U>(a.keys[k], g, null[k]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    e[u].nbs = 0;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      int32_t nb;
      e[u].v[k] = order_of_raw(a.keys[k], raw[k][u], null[k][u], (a.ascending >> k) & 1,
                               (a.nulls_first >> k) & 1, nb);
      if (k == 0) {
        e[u].h = ((surv[u] ? 0u : 1u) << 2) | (uint32_t)(nb + 1);
      } else {
        e[u].nbs |= (uint32_t)(nb + 1) << (2 * (k - 1));
      }
    }
    e[u].gid = gid[u];
    e[u] = ent_pick(gid[u] < 0, e[u], no_ent<NK>());
    surv_count += gid[u] >= 0 && surv[u];
  }
}

template <int NK>
__device__ __forceinline__ Ent<NK> shfl_ent(const Ent<NK>& e, int src) {
  Ent<NK> o;
#pragma unroll
  for (int k = 0; k < NK; ++k) o.v[k] = __shfl_sync(0xffffffffu, e.v[k], src);
  o.h = __shfl_sync(0xffffffffu, e.h, src);
  if (NK > 1) o.nbs = __shfl_sync(0xffffffffu, e.nbs, src);
  else o.nbs = 0;
  o.gid = __shfl_sync(0xffffffffu, e.gid, src);
  return o;
}

template <int NK>
__device__ __forceinline__ Ent<NK> shfl_xor_ent(const Ent<NK>& e, int mask) {
  Ent<NK> o;
#pragma unroll
  for (int k = 0; k < NK; ++k) o.v[k] = __shfl_xor_sync(0xffffffffu, e.v[k], mask);
  o.h = __shfl_xor_sync(0xffffffffu, e.h, mask);
  if (NK > 1) o.nbs = __shfl_xor_sync(0xffffffffu, e.nbs, mask);
  else o.nbs = 0;
  o.gid = __shfl_xor_sync(0xffffffffu, e.gid, mask);
  return o;
}

template <int NK>
__device__ __forceinline__ Ent<NK> shfl_up_ent(const Ent<NK>& e) {
  Ent<NK> o;
#pragma unroll
  for (int k = 0; k < NK; ++k) o.v[k] = __shfl_up_sync(0xffffffffu, e.v[k], 1);
  o.h = __shfl_up_sync(0xffffffffu, e.h, 1);
  if (NK > 1) o.nbs = __shfl_up_sync(0xffffffffu, e.nbs, 1);
  else o.nbs = 0;
  o.gid = __shfl_up_sync(0xffffffffu, e.gid, 1);
  return o;
}

// One compare-exchange stage of a bitonic network across the warp: lane
// `lane` and lane ^ stride, the run of `size` ascending where lane & size
// is 0 (size 64: every run ascending).
template <int NK>
__device__ __forceinline__ void warp_cx(Ent<NK>& e, int lane, int size, int stride) {
  const Ent<NK> o = shfl_xor_ent(e, stride);
  const bool up = (lane & size) == 0;
  const bool lower = (lane & stride) == 0;
  const bool o_first = ent_less(o, e), e_first = ent_less(e, o);
  e = ent_pick(lower == up ? o_first : e_first, e, o);
}

// Sorts the warp's 32 entries ascending across the lanes.
template <int NK>
__device__ __forceinline__ void warp_sort(Ent<NK>& e, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) warp_cx(e, lane, size, stride);
  }
}

// The 32 least of two ascending lists (lane i holds a[i]; b reversed,
// lane i holds b[31 - i]), ascending across the lanes.
template <int NK>
__device__ __forceinline__ Ent<NK> warp_merge_rev(const Ent<NK>& a, const Ent<NK>& b_rev, int lane) {
  Ent<NK> m = ent_pick(ent_less(b_rev, a), a, b_rev);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) warp_cx(m, lane, 64, stride);
  return m;
}

__device__ __forceinline__ int32_t load_gid(const TopkArgs& a, int64_t i) {
  if (i >= a.n_cand) return -1;
  return a.cand == nullptr ? (int32_t)i : __ldg(a.cand + i);
}

// kAhead batches of 32 candidates a warp loads before it compares any
template <int NK>
struct Ahead {
  static constexpr int value = NK == 1 ? 8 : 4;
};
// a batch with more candidates below the warp's cap-th best than this is
// sorted and merged; fewer are inserted one by one
constexpr int kInsertMax = 8;

template <int NK>
__global__ void __cluster_dims__(kClusterCtas, 1, 1) __launch_bounds__(kSelectThreads, 1)
    topk_select_kernel(const __grid_constant__ TopkArgs a) {
  constexpr int kAhead = Ahead<NK>::value;
  __shared__ Ent<NK> s_list[kSelectWarps][32];
  __shared__ int32_t s_count[kSelectWarps];
  __shared__ int32_t s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / kClusterCtas;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_warps = (int64_t)gridDim.x * kSelectWarps;
  const int64_t first = (int64_t)unit * kClusterCtas * kSelectWarps + rank * kSelectWarps + warp;
  const bool counting = a.cand == nullptr;

  Ent<NK> best = no_ent<NK>();  // lane i: this warp's i-th best, ascending
  Ent<NK> thr = best;           // its cap-th best, on every lane
  int32_t surv_count = 0;
  for (int64_t b0 = first; b0 * 32 < a.n_cand; b0 += kAhead * n_warps) {
    int32_t gid[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) gid[u] = load_gid(a, (b0 + u * n_warps) * 32 + lane);
    Ent<NK> e[kAhead];
    int32_t seen = 0;
    load_ents<NK, kAhead>(a, gid, e, seen);
    surv_count += counting ? seen : 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool in = e[u].gid >= 0 && ent_less(e[u], thr);
      uint32_t m = __ballot_sync(0xffffffffu, in);
      if (m == 0) continue;
      if (__popc(m) > kInsertMax) {
        Ent<NK> x = ent_pick(in, no_ent<NK>(), e[u]);
        warp_sort(x, lane);
        best = warp_merge_rev(best, shfl_ent(x, 31 - lane), lane);
      } else {
        // a few: each into the sorted list at its place, the entries
        // after it one lane up (the last drops off)
        do {
          const Ent<NK> c = shfl_ent(e[u], __ffs(m) - 1);
          m &= m - 1;
          const int pos = __popc(__ballot_sync(0xffffffffu, ent_less(best, c)));
          const Ent<NK> up = shfl_up_ent(best);
          best = ent_pick(lane == pos, ent_pick(lane > pos, best, up), c);
        } while (m);
      }
      thr = shfl_ent(best, a.cap - 1);
    }
  }

  // the warps' lists, merged pairwise in shared memory
  surv_count = warp_sum_i(surv_count);
  s_list[warp][lane] = best;
  if (lane == 0) s_count[warp] = surv_count;
  __syncthreads();
  for (int n = kSelectWarps; n > 1; n >>= 1) {
    Ent<NK> m;
    if (warp < n / 2) m = warp_merge_rev(s_list[2 * warp][lane], s_list[2 * warp + 1][31 - lane], lane);
    __syncthreads();
    if (warp < n / 2) s_list[warp][lane] = m;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int w = 0; w < kSelectWarps; ++w) s += s_count[w];
    s_total = s;
  }

  // the CTAs' lists, merged on the cluster's first CTA (rows 1.. of its
  // s_list are free now); the others wait until it has read theirs
  cluster.sync();
  if (rank == 0) {
    if (warp < kClusterCtas / 2) {
      const Ent<NK>* x = cluster.map_shared_rank(&s_list[0][0], 2 * warp);
      const Ent<NK>* y = cluster.map_shared_rank(&s_list[0][0], 2 * warp + 1);
      const Ent<NK> m = warp_merge_rev(x[lane], y[31 - lane], lane);
      s_list[1 + warp][lane] = m;
    }
    if (threadIdx.x == 0) {
      int32_t s = 0;
      for (int r = 0; r < kClusterCtas; ++r) s += *cluster.map_shared_rank(&s_total, r);
      s_total = s;
    }
  }
  cluster.sync();
  if (rank != 0) return;
  // rows 1..4, then 5..6, then the last merge in registers
  int row = 1;
  for (int n = kClusterCtas / 2; n > 1; n >>= 1) {
    __syncthreads();
    if (warp < n / 2) {
      const Ent<NK> m = warp_merge_rev(s_list[row + 2 * warp][lane],
                                       s_list[row + 2 * warp + 1][31 - lane], lane);
      s_list[row + n + warp][lane] = m;
    }
    row += n;
  }
  __syncthreads();
  if (warp == 0 && lane < a.cap) a.out[(int64_t)unit * a.cap + lane] = s_list[row][lane].gid;
  if (threadIdx.x == 0) {
    if (a.counts_out != nullptr) a.counts_out[unit] = s_total;
    if (a.n_out != nullptr) *a.n_out = counting ? s_total : summed_counts(a);
  }
}

// ---- the bitonic rounds (32 < cap <= 512) ----------------------------------------------

__global__ void __launch_bounds__(kSortThreads) topk_round_kernel(const __grid_constant__ TopkArgs a) {
  __shared__ int32_t s_gid[kChunk];
  __shared__ uint8_t s_surv[kChunk];
  __shared__ int8_t s_nb[kMaxKeys][kChunk];
  __shared__ int64_t s_val[kMaxKeys][kChunk];
  __shared__ int16_t s_perm[kChunk];
  __shared__ int32_t s_count[kSortThreads / 32];
  const int t = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const bool counting = a.cand == nullptr;
  int32_t local = 0;
  for (int i = t; i < kChunk; i += kSortThreads) {
    const int64_t ci = c0 + i;
    int32_t g = -1;
    if (ci < a.n_cand) g = a.cand == nullptr ? (int32_t)ci : a.cand[ci];
    s_gid[i] = g;
    s_perm[i] = (int16_t)i;
    if (g >= 0) {
      const bool surv = gate_open(a, (uint32_t)g);
      s_surv[i] = surv ? 0 : 1;
      local += counting && surv;
      for (int k = 0; k < a.n_keys; ++k) {
        int32_t nb;
        s_val[k][i] = group_order_key(a.keys[k], (uint32_t)g, (a.ascending >> k) & 1,
                                      (a.nulls_first >> k) & 1, nb);
        s_nb[k][i] = (int8_t)nb;
      }
    }
  }
  local = warp_sum_i(local);
  if ((t & 31) == 0) s_count[t >> 5] = local;

  // less(x, y) over chunk slots; empty slots (-1) are the largest
  auto less = [&](int x, int y) -> bool {
    const int32_t gx = s_gid[x], gy = s_gid[y];
    if (gx < 0 || gy < 0) return gx >= 0 && gy < 0;
    if (s_surv[x] != s_surv[y]) return s_surv[x] < s_surv[y];
    for (int k = 0; k < a.n_keys; ++k) {
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
  if (t == 0) {
    int32_t s = 0;
    for (int w = 0; w < kSortThreads / 32; ++w) s += s_count[w];
    if (a.counts_out != nullptr) a.counts_out[blockIdx.x] = s;
    if (a.n_out != nullptr) *a.n_out = counting ? s : summed_counts(a);
  }
}

// ---- no key: survivors, then the rest -------------------------------------------------

constexpr int kCompactThreads = 1024;
constexpr int kCompactPer = 8;  // consecutive groups a thread holds in a tile
constexpr int kCompactTile = kCompactThreads * kCompactPer;

// Block-wide exclusive prefix of c (every thread's), and the block's total;
// s_warp holds 32 words and is free again when this returns.
__device__ __forceinline__ int32_t block_exclusive(int32_t c, int32_t* s_warp, int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;  // inclusive prefix of the warps' totals
  }
  __syncthreads();
  const int32_t before = (warp > 0 ? s_warp[warp - 1] : 0) + x - c;
  total = s_warp[31];
  __syncthreads();
  return before;
}

// No key: group g goes to position sb(g), the survivors before it, if it
// survives, else to total + g - sb(g).  One cluster: each CTA takes a
// contiguous range of the groups, counts its survivors, learns the counts
// of the CTAs before it through distributed shared memory, then walks its
// range in tiles of kCompactTile (kCompactPer consecutive groups a thread,
// one block-wide scan a tile) until no position below `cap` is left.
__global__ void __cluster_dims__(kClusterCtas, 1, 1) __launch_bounds__(kCompactThreads)
    topk_compact_kernel(const __grid_constant__ TopkArgs a) {
  __shared__ int32_t s_warp[32];
  __shared__ int32_t s_cta;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int64_t G = a.n_cand;
  const int64_t per_cta = ((G + kClusterCtas - 1) / kClusterCtas + kCompactPer - 1) /
                          kCompactPer * kCompactPer;
  const int64_t lo = min(G, rank * per_cta), hi = min(G, lo + per_cta);
  int32_t cnt = 0;
  for (int64_t g = lo + t; g < hi; g += kCompactThreads) cnt += gate_open(a, (uint32_t)g);
  int32_t mine;
  block_exclusive(cnt, s_warp, mine);
  if (t == 0) s_cta = mine;
  cluster.sync();
  int32_t base = 0, total = 0;
  for (int r = 0; r < kClusterCtas; ++r) {
    const int32_t n = *cluster.map_shared_rank(&s_cta, r);
    base += r < rank ? n : 0;
    total += n;
  }
  cluster.sync();  // every CTA has read the others' counts
  if (rank == 0 && t == 0) *a.n_out = total;
  int32_t run = base;  // survivors before the tile
  for (int64_t t0 = lo; t0 < hi && (run < a.cap || total + (t0 - run) < a.cap);
       t0 += kCompactTile) {
    const int64_t g0 = t0 + (int64_t)t * kCompactPer;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < kCompactPer; ++j) {
      const int64_t g = g0 + j;
      bits |= (uint32_t)(g < hi && gate_open(a, (uint32_t)g)) << j;
    }
    int32_t tile_total;
    const int32_t before = run + block_exclusive(__popc(bits), s_warp, tile_total);
#pragma unroll
    for (int j = 0; j < kCompactPer; ++j) {
      const int64_t g = g0 + j;
      if (g >= hi) break;
      const int32_t sb = before + __popc(bits & ((1u << j) - 1));
      const int64_t pos = (bits >> j) & 1 ? sb : total + (g - sb);
      if (pos < a.cap) a.out[pos] = (int32_t)g;
    }
    run += tile_total;
  }
}

// args->units clusters of the select (cap <= 32)
GT_EXPORT int gt_topk_select(const TopkArgs* args, void* stream) {
  const dim3 grid((unsigned)(args->units * kClusterCtas));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (args->n_keys) {
    case 1: topk_select_kernel<1><<<grid, kSelectThreads, 0, s>>>(*args); break;
    case 2: topk_select_kernel<2><<<grid, kSelectThreads, 0, s>>>(*args); break;
    case 3: topk_select_kernel<3><<<grid, kSelectThreads, 0, s>>>(*args); break;
    default: topk_select_kernel<4><<<grid, kSelectThreads, 0, s>>>(*args); break;
  }
  return (int)cudaGetLastError();
}

// one bitonic round over args->n_cand candidates, a CTA a chunk of 1024
GT_EXPORT int gt_topk_round(const TopkArgs* args, void* stream) {
  const int64_t chunks = (args->n_cand + kChunk - 1) / kChunk;
  if (chunks <= 0) return (int)cudaSuccess;
  topk_round_kernel<<<(unsigned)chunks, kSortThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_topk_compact(const TopkArgs* args, void* stream) {
  topk_compact_kernel<<<kClusterCtas, kCompactThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
