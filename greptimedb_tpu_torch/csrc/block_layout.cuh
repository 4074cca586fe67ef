// The block layout of the blocked kernels K2 (segment_reduce_blocked.cu),
// K4's blocked form (segment_last.cu) and K6 (limb_segment_sums.cu): what
// their fold needs to add each group's block partials in BLOCK ORDER, as
// the reference's windowed scatter (greptimedb_tpu/ops/aggregate.py:190-234,
// one scatter-add over the [nb, 16] partials, applied block after block)
// and the plain versions do, with no sort.
//
// A per-block kernel (one CTA per 4096-row block) writes for its block b
// base[b] (the least masked id, G when every row is masked) and occ[b]
// (bit j: slot base + j holds a masked row; 0 for a block failing the
// guard).  The CTA that finishes last scans the nb blocks once, in block
// order, and writes
//   keylo[b]  the largest base of the occupied blocks up to b,
//   keyhi[b]  the largest base + top occupied slot of the same,
//             (both INT32_MIN before the first occupied block: never
//             reached by a group id),
//   mode      1 when some occupied block's base is below keylo of the
//             block before it (the bases fall somewhere), else 0,
//   verdict   1 when some block failed the layout guard (K2, K6).
// Both keys are running maxima, so they never fall.  No block before lo =
// the first b with keyhi[b] >= g reaches group g; while the bases do not
// fall, no block from hi = the first b with keylo[b] > g starts at or
// below g.  So the fold of g walks blocks [lo, hi) in block order (hi = nb
// when the bases fall) and adds block b where slot g - base[b] is
// occupied.  An empty slot's partial is the identity of its fold (+0.0, 0,
// +-DBL_MAX, (INT64_MIN, -1)): a sum that starts at +0.0 and adds partials
// that are never -0.0 is never -0.0, and s + 0.0 = s, so skipping it
// changes no byte.  On the host-major main path (bases rise) [lo, hi) is
// the one or two blocks a group's rows lie in; on a time-major plan it is
// the blocks of the group's bucket.
//
// One ticket counter and one failure word per loaded library and device
// (every kernel source is a library of its own): the CTA that takes the
// last ticket finishes the layout and resets both, so a call starts from
// zero with no memset and a CUDA graph replays clean.  Two per-block
// kernels of one library must not run at once on one device; the port
// launches every kernel on the device's current stream, in order.
#pragma once

#include "common.cuh"

// Mirrored field for field by _BlockLayout in ops/aggregate.py (ctypes).
struct BlockLayout {
  int32_t* base;     // [nb]
  int32_t* keylo;    // [nb]
  int32_t* keyhi;    // [nb]
  uint32_t* occ;     // [nb]
  int32_t* verdict;  // [1] or nullptr (K4: the guard is K2's)
  int32_t* mode;     // [1]
  int64_t nb;
  int32_t num_groups;
  int32_t reserved;
};

static __device__ uint32_t g_layout_ticket;
static __device__ int32_t g_layout_bad;

constexpr int32_t kNoKey = (-0x7fffffff - 1);

// Called once by every thread of every CTA of a per-block kernel of
// kBlockThreads threads, after thread 0 stored the block's base and occ;
// `failed` is thread 0's guard verdict for its block.  Returns at once
// in every CTA but the last, which first writes keylo, keyhi, mode and
// the verdict.  Starts with a barrier, so it also publishes what thread 0
// put in shared memory before the call.
__device__ void finish_layout(const BlockLayout& L, bool failed) {
  constexpr int kWarpsL = kBlockThreads / 32;
  constexpr int kPer = 4;  // consecutive blocks a thread scans
  __shared__ int32_t s_last;
  __shared__ int32_t s_wlo[kWarpsL], s_whi[kWarpsL];
  __shared__ int32_t s_carry_lo, s_carry_hi;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    if (failed) atomicOr(&g_layout_bad, 1);
    __threadfence();
    s_last = atomicAdd(&g_layout_ticket, 1u) == (uint32_t)(L.nb - 1) ? 1 : 0;
    s_carry_lo = kNoKey;
    s_carry_hi = kNoKey;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  bool fall = false;
  for (int64_t c0 = 0; c0 < L.nb; c0 += (int64_t)kBlockThreads * kPer) {
    const int32_t carry_lo = s_carry_lo, carry_hi = s_carry_hi;
    int32_t bs[kPer], hs[kPer];
    bool on[kPer];
    int32_t mlo = kNoKey, mhi = kNoKey;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t b = c0 + (int64_t)t * kPer + k;
      const uint32_t oc = b < L.nb ? __ldcg(L.occ + b) : 0u;
      on[k] = oc != 0u;
      bs[k] = on[k] ? __ldcg(L.base + b) : kNoKey;
      hs[k] = on[k] ? bs[k] + 31 - __clz(oc) : kNoKey;
      mlo = max(mlo, bs[k]);
      mhi = max(mhi, hs[k]);
    }
    // inclusive max scan over the warp, then the warps before this one
    int32_t ilo = mlo, ihi = mhi;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t ylo = __shfl_up_sync(0xffffffffu, ilo, o);
      const int32_t yhi = __shfl_up_sync(0xffffffffu, ihi, o);
      if (lane >= o) {
        ilo = max(ilo, ylo);
        ihi = max(ihi, yhi);
      }
    }
    if (lane == 31) {
      s_wlo[warp] = ilo;
      s_whi[warp] = ihi;
    }
    const int32_t plo = __shfl_up_sync(0xffffffffu, ilo, 1);
    const int32_t phi = __shfl_up_sync(0xffffffffu, ihi, 1);
    __syncthreads();
    int32_t elo = carry_lo, ehi = carry_hi;  // running maxima before this thread's blocks
    for (int w = 0; w < warp; ++w) {
      elo = max(elo, s_wlo[w]);
      ehi = max(ehi, s_whi[w]);
    }
    if (lane > 0) {
      elo = max(elo, plo);
      ehi = max(ehi, phi);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t b = c0 + (int64_t)t * kPer + k;
      if (on[k]) {
        fall |= bs[k] < elo;
        elo = max(elo, bs[k]);
        ehi = max(ehi, hs[k]);
      }
      if (b < L.nb) {
        L.keylo[b] = elo;
        L.keyhi[b] = ehi;
      }
    }
    __syncthreads();  // every thread has read the carry
    if (t == kBlockThreads - 1) {
      s_carry_lo = elo;
      s_carry_hi = ehi;
    }
    __syncthreads();
  }
  fall = __syncthreads_or(fall) != 0;
  if (t == 0) {
    *L.mode = fall ? 1 : 0;
    if (L.verdict != nullptr) *L.verdict = g_layout_bad;
    g_layout_bad = 0;
    g_layout_ticket = 0u;
  }
}

// The blocks [lo, hi) whose window may hold group g, in block order.
__device__ __forceinline__ void covering_range(const BlockLayout& L, int64_t g, int64_t& lo,
                                               int64_t& hi) {
  lo = lower_bound_i32(L.keyhi, L.nb, g);
  hi = *L.mode != 0 ? L.nb : lower_bound_i32(L.keylo, L.nb, g + 1);
}

// Slot of group g in block b when that slot is occupied, else -1.
__device__ __forceinline__ int covered_slot(const BlockLayout& L, int64_t b, int64_t g) {
  const int64_t s = g - (int64_t)L.base[b];
  return (s >= 0 && s < kSpan && ((L.occ[b] >> s) & 1u)) ? (int)s : -1;
}

// The fold of group g by one thread: for every block of [lo, hi) that
// holds g, in block order, add(load(b, slot)).  kUnroll blocks' loads are
// issued before their adds.  For short ranges (the main path's one or two
// blocks a group).
template <int kUnroll, typename T, typename Load, typename Add>
__device__ __forceinline__ void fold_blocks(const BlockLayout& L, int64_t g, Load load, Add add) {
  int64_t lo, hi;
  covering_range(L, g, lo, hi);
  for (int64_t b0 = lo; b0 < hi; b0 += kUnroll) {
    T v[kUnroll];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = b0 + u < hi ? covered_slot(L, b0 + u, g) : -1;
      on[u] = s >= 0;
      if (on[u]) v[u] = load(b0 + u, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (on[u]) add(v[u]);
    }
  }
}

// The fold of group g by the 32 lanes of a warp (every lane calls it with
// the same g): the lanes take 32 consecutive blocks of [lo, hi) at a time,
// each loads its block's value, and take(mine, l) runs on every lane for
// each lane l whose block holds g, in block order (it shuffles lane l's
// value in and adds it, so every lane ends with the same sum).  For long
// ranges: a small G, where every block may hold every group.
template <typename T, typename Load, typename Take>
__device__ __forceinline__ void fold_blocks_warp(const BlockLayout& L, int64_t g, int lane,
                                                 Load load, Take take) {
  int64_t lo, hi;
  covering_range(L, g, lo, hi);
  for (int64_t b0 = lo; b0 < hi; b0 += 32) {
    const int64_t b = b0 + lane;
    const int s = b < hi ? covered_slot(L, b, g) : -1;
    T mine{};
    if (s >= 0) mine = load(b, s);
    unsigned on = __ballot_sync(0xffffffffu, s >= 0);
    while (on != 0u) {
      const int l = __ffs(on) - 1;
      on &= on - 1u;
      take(mine, l);
    }
  }
}

// Lanes per group of a fold launch (both its launcher and its kernel ask):
// a warp when the groups are few against the blocks (long covering
// ranges), else a thread.
__host__ __device__ __forceinline__ int fold_lanes(int64_t nb, int64_t num_groups) {
  return nb > 4 * num_groups ? 32 : 1;
}
