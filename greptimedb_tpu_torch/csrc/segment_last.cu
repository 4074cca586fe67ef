// K4 segment_last: last_value(v ORDER BY ts) per group.
//
// Replaces greptimedb_tpu/ops/aggregate.py:792 `_segment_blocked_last`
// (blocked form) and the LAST part of :598 `_segment_scatter` (any id
// order).  The winner of a group is its row with the largest ts and, on a
// ts tie, the LATER row (aggregate.py:629-638, :839-851): on the engine's
// (pk, ts, seq) layout that is last-write-wins.  Both forms take the
// lexicographic max of (ts, row index), which is the reference's two
// passes (max ts, then max row at that ts) in one, and is independent of
// the order of reduction.  Then one [G] gather fetches the values.
//
// Bound on the H100: bytes — per row the id (4 B), mask (1 B) and ts (8 B)
// once; the value column is only gathered at G rows.
//
// Blocked form (the guard of K2 passed; it reuses K2's per-block bases):
// one CTA per 4096-row block reduces each warp's rows over the slots of
// its id range only and marks the block's occupied slots; the last CTA
// finishes this call's block layout (block_layout.cuh) from K2's bases,
// so the fold kernel finds the blocks covering each group with no sort of
// the bases, combines them and gathers; both launches are predicated on
// K2's guard flag (Gate).
// Sorted-run form (the guard failed — predicated on the same flag — or
// under 2^16 rows):
// over K3's stable sort of the masked ids, one warp per group reduces its
// run and gathers.
#include "block_layout.cuh"

// Mirrored field for field by _LastBlockedArgs in ops/aggregate.py (ctypes).
struct LastBlockedArgs {
  int64_t n;
  const int32_t* gids;
  const uint8_t* mask;
  const int64_t* ts;
  BlockLayout layout;   // base: [nb] from K2's guard pass; occ, keys, mode: this call's
  int64_t* pts;         // [nb, kSpan]
  int32_t* prow;        // [nb, kSpan]
  Gate gate;            // runs when K2's guard passed
  int32_t vec;          // 1: gids and ts 16 B aligned, mask 4 B
  int32_t reserved;
};

// Mirrored field for field by _LastFoldArgs in ops/aggregate.py (ctypes).
struct LastFoldArgs {
  BlockLayout layout;
  const int64_t* pts;
  const int32_t* prow;
  const double* values;  // [n]
  int64_t* last_ts;      // [G]
  double* last_val;      // [G]
  int64_t n;
  Gate gate;             // runs when K2's guard passed
};

struct LastSortedArgs {
  int64_t n;
  const int32_t* skeys;  // [n] sorted ids; masked rows carry G
  const int64_t* perm;
  const int64_t* ts;
  const double* values;
  int64_t* last_ts;
  double* last_val;
  int32_t num_groups;
  int32_t reserved;
  Gate gate;             // behind K2's guard: runs when it failed
};

__device__ __forceinline__ double gather_value(const double* values, int64_t n, int32_t r) {
  int64_t i = r < 0 ? 0 : (int64_t)r;  // clip(pick, 0, n - 1)
  if (i > n - 1) i = n - 1;
  return values[i];
}

// The partials kernel has the shape of K2's: a warp owns 512
// consecutive rows, lane l the quads of rows 4l..4l+3 of each 128-row
// stretch (a 16 B load of ids, a 4 B load of masks and two 16 B loads of
// ts a quad, scalar where the block's tail or an unaligned plane asks for
// it), every row's id, mask and ts loaded before any is compared.  A row
// counts where it is masked in and its slot k = id - base lies in [0, 16)
// (the parent's compare against the 16 slots); the warp's slot range
// [klo, khi] comes from two warp reductions, and only its slots are
// compared and reduced (one or two on the host-major main path), each by
// one warp_lex_max.  The warps' partials meet in shared memory, each
// taken only inside its warp's range.  lex_max is order-free, so the
// partials are the parent's bytes.
__global__ void __launch_bounds__(kBlockThreads, 4) last_partials_kernel(const LastBlockedArgs a) {
  if (gate_shut(a.gate)) return;
  constexpr int kWarps = kBlockThreads / 32;
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int64_t sh_t[kWarps][kSpan];
  __shared__ int32_t sh_r[kWarps][kSpan];
  __shared__ int32_t s_klo[kWarps], s_khi[kWarps];
  const BlockLayout& L = a.layout;
  const int32_t base = L.base[b];
  const int64_t wrow0 = b * kBlockRows + (int64_t)warp * 32 * kRowsPerThread + 4 * lane;
  int32_t id[kRowsPerThread];
  uint32_t mq[kRowsPerThread / 4];  // byte e of word q: mask of row 4q + e
  int64_t tv[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread / 4; ++q) {
    const int64_t r = wrow0 + q * 128;
    if (a.vec && r + 4 <= a.n) {
      const int4 g = __ldg((const int4*)(a.gids + r));
      const longlong2 t0 = __ldg((const longlong2*)(a.ts + r));
      const longlong2 t1 = __ldg((const longlong2*)(a.ts + r + 2));
      mq[q] = __ldg((const unsigned int*)(a.mask + r));
      id[4 * q] = g.x;
      id[4 * q + 1] = g.y;
      id[4 * q + 2] = g.z;
      id[4 * q + 3] = g.w;
      tv[4 * q] = t0.x;
      tv[4 * q + 1] = t0.y;
      tv[4 * q + 2] = t1.x;
      tv[4 * q + 3] = t1.y;
    } else {
      mq[q] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = r + e < a.n;
        id[4 * q + e] = in ? a.gids[r + e] : 0;
        tv[4 * q + e] = in ? a.ts[r + e] : 0;
        mq[q] |= (in && a.mask[r + e] != 0 ? 1u : 0u) << (8 * e);
      }
    }
  }
  // bit i of `live`: row i counts; its slot k as four bit planes (bit i of
  // plane j is bit j of row i's slot)
  uint32_t live = 0u;
  uint32_t plane[4] = {0u, 0u, 0u, 0u};
  int32_t lo = kSpan, hi = -1;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const uint32_t k = (uint32_t)id[i] - (uint32_t)base;
    if (((mq[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0u && k < (uint32_t)kSpan) {
      live |= 1u << i;
      lo = min(lo, (int32_t)k);
      hi = max(hi, (int32_t)k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) plane[j] |= ((k >> j) & 1u) << i;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    s_klo[warp] = lo;
    s_khi[warp] = hi;
  }
  const int32_t row0 = (int32_t)wrow0;
  for (int j = lo; j <= hi; ++j) {  // warp-uniform; empty when no row counts
    uint32_t rows = live;
#pragma unroll
    for (int k = 0; k < 4; ++k) rows &= ((j >> k) & 1) ? plane[k] : ~plane[k];
    int64_t tt = kInt64Min;
    int32_t rr = -1;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if ((rows >> i) & 1u) lex_max(tt, rr, tv[i], row0 + (i >> 2) * 128 + (i & 3));
    }
    warp_lex_max(tt, rr);
    if (lane == 0) {
      sh_t[warp][j] = tt;
      sh_r[warp][j] = rr;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int64_t tt = kInt64Min;
    int32_t rr = -1;
    if (t < kSpan) {
      for (int w = 0; w < kWarps; ++w) {
        if (t >= s_klo[w] && t <= s_khi[w]) lex_max(tt, rr, sh_t[w][t], sh_r[w][t]);
      }
      a.pts[b * kSpan + t] = tt;
      a.prow[b * kSpan + t] = rr;
    }
    const uint32_t occ = __ballot_sync(0xffffffffu, t < kSpan && rr >= 0);
    if (t == 0) L.occ[b] = occ;
  }
  finish_layout(L, false);
}

// a thread per group where the groups are many against the blocks; where
// fold_lanes asks for a warp (few groups, long covering ranges: every
// block may hold every group on falling bases) a whole CTA per group, its
// threads taking every 256th block of the range, four loads in flight,
// then a shuffle tree and the warps in shared memory.  lex_max is
// order-free, so any split of the range gives the same bytes.
constexpr int kFoldUnroll = 4;

__global__ void __launch_bounds__(256) last_fold_kernel(const LastFoldArgs a) {
  if (gate_shut(a.gate)) return;
  const BlockLayout& L = a.layout;
  const int64_t G = L.num_groups;
  int64_t tt = kInt64Min;
  int32_t rr = -1;
  if (fold_lanes(L.nb, G) == 1) {
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    auto load = [&](int64_t blk, int slot) { return blk * kSpan + slot; };
    fold_blocks<4, int64_t>(L, g, load, [&](int64_t p) { lex_max(tt, rr, a.pts[p], a.prow[p]); });
    a.last_ts[g] = tt;
    a.last_val[g] = gather_value(a.values, a.n, rr);
    return;
  }
  __shared__ int64_t s_t[8];
  __shared__ int32_t s_r[8];
  const int64_t g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int64_t lo, hi;
  covering_range(L, g, lo, hi);
  for (int64_t b0 = lo + t; b0 < hi; b0 += 256 * kFoldUnroll) {
    int64_t pt[kFoldUnroll];
    int32_t pr[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      const int64_t blk = b0 + u * 256;
      const int s = blk < hi ? covered_slot(L, blk, g) : -1;
      pt[u] = s >= 0 ? a.pts[blk * kSpan + s] : kInt64Min;
      pr[u] = s >= 0 ? a.prow[blk * kSpan + s] : -1;
    }
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) lex_max(tt, rr, pt[u], pr[u]);
  }
  warp_lex_max(tt, rr);
  if (lane == 0) {
    s_t[warp] = tt;
    s_r[warp] = rr;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < 8; ++w) lex_max(tt, rr, s_t[w], s_r[w]);
    a.last_ts[g] = tt;
    a.last_val[g] = gather_value(a.values, a.n, rr);
  }
}

// a capped grid of warps striding over the groups: a launch whose gate is
// shut costs one wave of empty CTAs
__global__ void __launch_bounds__(256) last_sorted_kernel(const LastSortedArgs a) {
  if (gate_shut(a.gate)) return;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; gw < a.num_groups;
       gw += warps) {  // uniform per warp
    const int64_t start = lower_bound_i32(a.skeys, a.n, gw);
    const int64_t end = lower_bound_i32(a.skeys, a.n, gw + 1);
    int64_t tt = kInt64Min;
    int32_t rr = -1;
    for (int64_t j = start + lane; j < end; j += 32) {
      const int64_t r = a.perm[j];
      lex_max(tt, rr, a.ts[r], (int32_t)r);
    }
    warp_lex_max(tt, rr);
    if (lane == 0) {
      a.last_ts[gw] = tt;
      a.last_val[gw] = gather_value(a.values, a.n, rr);
    }
  }
}

GT_EXPORT int gt_last_partials(const LastBlockedArgs* args, void* stream) {
  if (args->layout.nb <= 0) return (int)cudaSuccess;
  last_partials_kernel<<<(unsigned)args->layout.nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_fold(const LastFoldArgs* args, void* stream) {
  const int64_t G = args->layout.num_groups;
  if (G <= 0) return (int)cudaSuccess;
  const int64_t per_cta = fold_lanes(args->layout.nb, G) == 1 ? 256 : 1;
  last_fold_kernel<<<(unsigned)((G + per_cta - 1) / per_cta), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_last_sorted(const LastSortedArgs* args, void* stream) {
  const int64_t threads = (int64_t)args->num_groups * 32;
  if (threads <= 0) return (int)cudaSuccess;
  const int64_t blocks = (threads + 255) / 256;
  last_sorted_kernel<<<(unsigned)(blocks < kCapBlocks ? blocks : kCapBlocks), 256, 0,
                       (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
