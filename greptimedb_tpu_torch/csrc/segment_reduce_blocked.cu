// K2 segment_reduce_blocked: sum / count / min / max per group for C value
// columns whose masked rows are clustered, one CTA per 4096-row block.
//
// Replaces greptimedb_tpu/ops/aggregate.py:642 `_segment_blocked` and the
// layout guard of :511 `segment_aggregate` / :729 `segment_aggregate_multi`
// (per-block masked bmin/bmax, span < 16, ids in range), plus the windowed
// fold of :190 `windowed_slot_sum` / :206 `windowed_slot_reduce`.
//
// Bound on the H100: bytes.  Each row's id (4 B), base mask (1 B) and
// value (8 B per column) are read once; the [nb, C, 16] partials and the
// [C, G] states are small.  The TPU version built a [block, 4096, 16]
// one-hot for the vector unit; here each warp owns 512 consecutive rows of
// its block (a lane reads rows lane, lane + 32, ...: coalesced), keeps its
// 16 in registers and folds them into the slots of its block's window, so
// no one-hot and no scatter ever touches device memory.  A warp visits
// only the slots its own rows touch (on a clustered layout one or two of
// the 16), folds sum, count, min and max in one pass over its rows, and
// keeps its per-slot results in shared memory for a chunk of up to 8
// columns: one barrier per chunk, not one per column and aggregate.
//
// Pass 1 (`blocked_partials_kernel`) computes the block's masked id
// range, writes its base (= min(bmin, G); an all-masked block gets the
// overflow slot G) and ORs a failing verdict into one flag; a failing
// block stops before reading any value.  No host reads the flag: pass 2
// and the scatter branch (the flag-reading sort and K3) are all launched,
// each predicated on the flag (Gate in common.cuh), so a CUDA graph can
// hold the whole choice.
// Pass 2 (`blocked_fold_kernel`) folds the partials into [C, G]: each
// (column, group) thread visits, in (base, block) order, the blocks whose
// window covers its group (found by binary search in the bases, sorted
// by the caller).
//
// Determinism: no atomics on values.  Within a warp every lane adds its
// rows in row order and a fixed shuffle tree combines the lanes; the
// block combines its warps in warp order and the fold adds the blocks in
// a fixed order, so the same input gives the same bytes on every run.
#include "common.cuh"

struct BlockedArgs {
  int64_t n;
  int64_t nb;
  const int32_t* gids;
  const uint8_t* base_mask;
  const double* const* values;  // device array [C] of column pointers
  const uint8_t* const* masks;  // device array [C]; nullptr entry = base mask
  int32_t* base_out;            // [nb]
  int32_t* verdict;             // [1]: 1 when some block fails the guard
  double* psum;                 // [nb, C, kSpan] or nullptr
  int32_t* pcnt;
  double* pmin;
  double* pmax;
  int32_t num_groups;
  int32_t n_cols;
};

struct FoldArgs {
  const int32_t* sbase;  // [nb] bases sorted ascending
  const int64_t* order;  // [nb] block index of each sorted base
  const double* psum;
  const int32_t* pcnt;
  const double* pmin;
  const double* pmax;
  double* sums;  // [C, G] or nullptr
  int32_t* counts;
  double* mins;
  double* maxs;
  int64_t nb;
  int32_t num_groups;
  int32_t n_cols;
  Gate gate;             // runs when the guard passed
};

constexpr int kWarps = kBlockThreads / 32;
// columns whose per-warp slot results share memory between two barriers
constexpr int kColChunk = 8;

__global__ void __launch_bounds__(kBlockThreads) blocked_partials_kernel(const BlockedArgs a) {
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int32_t s_lo[kWarps], s_hi[kWarps], s_bad[kWarps];
  __shared__ int32_t s_base, s_ok;
  // per warp, column of the chunk and slot: sum, count, min, max; a warp
  // writes only the slots in its range [s_klo, s_khi]
  __shared__ double w_sum[kWarps][kColChunk][kSpan];
  __shared__ int32_t w_cnt[kWarps][kColChunk][kSpan];
  __shared__ double w_min[kWarps][kColChunk][kSpan];
  __shared__ double w_max[kWarps][kColChunk][kSpan];
  __shared__ int32_t s_klo[kWarps], s_khi[kWarps];

  // warp w owns rows [w * 512, (w + 1) * 512) of the block; lane l holds
  // rows l, l + 32, ... of them
  const int64_t wrow0 = row0 + (int64_t)warp * 32 * kRowsPerThread + lane;
  int32_t k[kRowsPerThread];  // the row's group id, then its slot (-1: masked)
  int32_t lo = 0x7fffffff, hi = -1, bad = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = wrow0 + (int64_t)i * 32;
    const bool m = r < a.n && a.base_mask[r] != 0;
    k[i] = m ? a.gids[r] : -1;
    if (m) {
      lo = min(lo, k[i]);
      hi = max(hi, k[i]);
      bad |= (k[i] < 0 || k[i] >= a.num_groups) ? 1 : 0;
    }
  }
  // every lane gets the warp's masked id range
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  bad = (int32_t)__reduce_or_sync(0xffffffffu, (unsigned)bad);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (t == 0) {
    int32_t blo = s_lo[0], bhi = s_hi[0], bbad = s_bad[0];
    for (int w = 1; w < kWarps; ++w) {
      blo = min(blo, s_lo[w]);
      bhi = max(bhi, s_hi[w]);
      bbad |= s_bad[w];
    }
    // empty block: -1 - INT32_MAX < span, as in the reference guard
    const bool span_ok = ((int64_t)bhi - (int64_t)blo) < kSpan;
    const bool ok = span_ok && !bbad;
    const int32_t base = min(blo, a.num_groups);
    a.base_out[b] = base;
    if (!ok) atomicOr(a.verdict, 1);
    s_base = base;
    s_ok = ok ? 1 : 0;
  }
  __syncthreads();
  if (!s_ok) return;
  const int32_t base = s_base;
  // the guard passed: every masked id lies in [base, base + 16)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) k[i] = k[i] >= 0 ? k[i] - base : -1;
  // the slots this warp's rows touch (none: an empty range)
  const int klo = hi < 0 ? kSpan : lo - base;
  const int khi = hi < 0 ? -1 : hi - base;
  if (lane == 0) {
    s_klo[warp] = klo;
    s_khi[warp] = khi;
  }
  const bool w_s = a.psum != nullptr, w_c = a.pcnt != nullptr;
  const bool w_mn = a.pmin != nullptr, w_mx = a.pmax != nullptr;

  for (int c0 = 0; c0 < a.n_cols; c0 += kColChunk) {
    const int cc = min(kColChunk, a.n_cols - c0);
    for (int ci = 0; ci < cc; ++ci) {
      const double* v = a.values[c0 + ci];
      const uint8_t* cm = a.masks[c0 + ci];
      double x[kRowsPerThread];
      int32_t kc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int64_t r = wrow0 + (int64_t)i * 32;
        kc[i] = (k[i] >= 0 && (cm == nullptr || cm[r] != 0)) ? k[i] : -1;
        x[i] = kc[i] >= 0 ? v[r] : 0.0;
      }
      for (int j = klo; j <= khi; ++j) {  // warp-uniform
        double s = 0.0, mn = kDblMax, mx = -kDblMax;
        int32_t cnt = 0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (kc[i] != j) continue;
          const bool nan = x[i] != x[i];  // NaN wins min and max, as in XLA
          s += x[i];
          cnt += 1;
          mn = (nan || x[i] < mn) ? x[i] : mn;
          mx = (nan || x[i] > mx) ? x[i] : mx;
        }
        if (w_s) s = warp_sum(s);
        if (w_c) cnt = warp_sum_i(cnt);
        if (w_mn) mn = warp_min(mn);
        if (w_mx) mx = warp_max(mx);
        if (lane == 0) {
          w_sum[warp][ci][j] = s;
          w_cnt[warp][ci][j] = cnt;
          w_min[warp][ci][j] = mn;
          w_max[warp][ci][j] = mx;
        }
      }
    }
    __syncthreads();
    // one thread per (column of the chunk, slot): the warps in warp order
    if (t < cc * kSpan) {
      const int ci = t / kSpan, j = t % kSpan;
      double s = 0.0, mn = kDblMax, mx = -kDblMax;
      int32_t cnt = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (j < s_klo[w] || j > s_khi[w]) continue;
        s += w_sum[w][ci][j];
        cnt += w_cnt[w][ci][j];
        mn = nan_min(mn, w_min[w][ci][j]);
        mx = nan_max(mx, w_max[w][ci][j]);
      }
      const int64_t off = (b * a.n_cols + c0 + ci) * kSpan + j;
      if (w_s) a.psum[off] = s;
      if (w_c) a.pcnt[off] = cnt;
      if (w_mn) a.pmin[off] = mn;
      if (w_mx) a.pmax[off] = mx;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256) blocked_fold_kernel(const FoldArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t G = a.num_groups;
  if (idx >= G * a.n_cols) return;
  const int64_t c = idx / G, g = idx % G;
  const int64_t lo = lower_bound_i32(a.sbase, a.nb, g - kSpan + 1);
  const int64_t hi = lower_bound_i32(a.sbase, a.nb, g + 1);
  double s = 0.0, mn = kDblMax, mx = -kDblMax;
  int32_t cnt = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t p = (a.order[i] * a.n_cols + c) * kSpan + (g - a.sbase[i]);
    if (a.psum != nullptr) s += a.psum[p];
    if (a.pcnt != nullptr) cnt += a.pcnt[p];
    if (a.pmin != nullptr) mn = nan_min(mn, a.pmin[p]);
    if (a.pmax != nullptr) mx = nan_max(mx, a.pmax[p]);
  }
  const int64_t o = c * G + g;
  if (a.sums != nullptr) a.sums[o] = s;
  if (a.counts != nullptr) a.counts[o] = cnt;
  if (a.mins != nullptr) a.mins[o] = mn;
  if (a.maxs != nullptr) a.maxs[o] = mx;
}

GT_EXPORT int gt_blocked_partials(const BlockedArgs* args, void* stream) {
  if (args->nb <= 0) return (int)cudaSuccess;
  blocked_partials_kernel<<<(unsigned)args->nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_blocked_fold(const FoldArgs* args, void* stream) {
  const int64_t total = (int64_t)args->num_groups * args->n_cols;
  if (total <= 0) return (int)cudaSuccess;
  blocked_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
