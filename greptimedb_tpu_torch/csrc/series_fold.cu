// K12 series_fold: the by-label fold of a PromQL aggregation on the card.
//
// Replaces the fold of greptimedb_tpu/query/promql/tile_exec.py:180
// `_finalize` (B17): [S, W] per-series values (NaN = absent) to [G, W]
// sum / avg / count / min / max over each group's present cells; a group
// with none is NaN.  avg is sum / max(count, 1), count an f64.
//
// The order is the contract.  Each (group, step) cell adds its group's
// present cells in the CSR order the host built from `_gid_map` (ascending
// series id), starting from 0.0, with round-to-nearest adds: the left fold
// of the reference's segment sum and of the legacy host fold on a
// one-region table.  A tree would give other bytes, so the parallelism is
// found across cells, never inside one.  Absent cells are skipped (adding
// 0.0 changes nothing).  No float atomics.
//
// Bound on the H100: bytes — the [S, W] matrix read once, [G, W] written.
// Two forms, chosen on the host from (S, G, W) (ops/rate.py
// `series_fold_plan`):
//   cells   one thread per (group, step) cell walks its group's members;
//           threads of a warp take neighbouring steps, so each member row
//           is read coalesced.  Where the cells fill the card (G = S:
//           a few members a group) this is the faster form.
//   staged  where they do not (one group: W = 1024 threads, four SMs of
//           132, each thread bound by the latency of 4096 loads), a CTA
//           owns one group and a tile of TW steps (8, 16 or 32, so that the
//           CTAs fill the card).  Seven producer warps stream the members'
//           TW-wide row segments into a 4-stage ring in shared memory with
//           `cp.async`, each stage's copies completing an mbarrier; TW
//           lanes of warp 0 fold each staged chunk in member order,
//           branch-free, and release the stage through a second mbarrier,
//           while up to four chunks are in flight.  The chain of dependent
//           adds (4096 at one group) is then the floor, not the memory
//           latency.
#include "common.cuh"

struct FoldArgs {
  const double* mat;        // [S, W]
  const int64_t* offsets;   // [G + 1]
  const int64_t* members;   // [S] series ids grouped by group
  double* out;              // [G, W]
  int64_t n_groups, n_steps;
  int32_t op;               // 0 sum, 1 avg, 2 count, 3 min, 4 max
  int32_t tw;               // 0: the cell form; 8, 16 or 32: the staged form's steps a CTA
};

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kStageDoubles = 1504;  // 11.75 KB a stage: 47 KB of shared memory

__device__ __forceinline__ double finish(double sum, double cnt, double ext, int op) {
  double v;
  switch (op) {
    case 0: v = sum; break;
    case 1: v = __ddiv_rn(sum, cnt > 1.0 ? cnt : 1.0); break;
    case 2: v = cnt; break;
    default: v = ext; break;
  }
  return cnt > 0 ? v : __longlong_as_double(0x7ff8000000000000LL);
}

__global__ void __launch_bounds__(kThreads) cells_kernel(const FoldArgs a) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= a.n_groups * a.n_steps) return;
  const int64_t g = cell / a.n_steps, w = cell - g * a.n_steps;
  double sum = 0.0, cnt = 0.0;
  double ext = a.op == 3 ? (double)INFINITY : -(double)INFINITY;
  // unrolled so the loads of several members are in flight at once; the
  // adds stay in member order
#pragma unroll 8
  for (int64_t i = a.offsets[g]; i < a.offsets[g + 1]; ++i) {
    const double x = a.mat[a.members[i] * a.n_steps + w];
    if (x != x) continue;
    sum = __dadd_rn(sum, x);
    cnt = __dadd_rn(cnt, 1.0);
    if (a.op == 3) {
      if (x < ext) ext = x;
    } else if (a.op == 4) {
      if (x > ext) ext = x;
    }
  }
  a.out[cell] = finish(sum, cnt, ext, a.op);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = pred ? 8 : 0;  // 0: the slot is zero-filled, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
// The mbarrier arrives once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(s) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(s), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(s) : "memory");
}
// Wait until the phase of parity `phase` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(s),
      "r"(phase)
      : "memory");
}

// Warp 0 folds; warps 1-7 produce.  Stage s of the ring is filled by the
// producers' cp.async copies (its `full` mbarrier completes when all of
// them have landed) and released by the folding warp (`empty`), so the
// fold never waits on a CTA-wide barrier and the producers run up to
// kStages chunks ahead of it.
template <int TW>
__global__ void __launch_bounds__(kThreads) staged_kernel(const FoldArgs a) {
  constexpr int kChunk = kStageDoubles / TW;  // members a stage
  constexpr int kProducers = kThreads - 32;
  __shared__ __align__(16) double ring[kStages][kStageDoubles];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int64_t tiles = (a.n_steps + TW - 1) / TW;
  const int64_t g = blockIdx.x / tiles;
  const int64_t w0 = (blockIdx.x - g * tiles) * TW;
  const int64_t lo = a.offsets[g];
  const int64_t n = a.offsets[g + 1] - lo;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], 1);
    }
  }
  __syncthreads();
  if (t >= 32) {
    // producers: element e of a stage is member e / TW, step w0 + e % TW
    constexpr int kPer = (kStageDoubles + kProducers - 1) / kProducers;
    const int pt = t - 32;
    for (int64_t c = 0; c < chunks; ++c) {
      const int s = (int)(c % kStages);
      int64_t ids[kPer];  // the member ids first, all in flight at once
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = pt + q * kProducers;
        const int64_t i = c * kChunk + e / TW;
        const bool ok = e < kStageDoubles && i < n && w0 + e % TW < a.n_steps;
        ids[q] = ok ? __ldg((const long long*)a.members + lo + i) : -1;
      }
      if (c >= kStages) mbar_wait(&empty[s], (int)((c / kStages - 1) & 1));
      double* stage = ring[s];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = pt + q * kProducers;
        if (e < kStageDoubles) {
          cp_async8(stage + e, a.mat + (ids[q] >= 0 ? ids[q] * a.n_steps + w0 + e % TW : 0),
                    ids[q] >= 0);
        }
      }
      cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  // warp 0: the fold, branch-free so that only the adds chain: an absent
  // cell adds -0.0, which leaves every sum as it was (+0.0 included), and
  // counts as an integer (exact, as the f64 count of the cell form)
  double sum = 0.0;
  double ext = a.op == 3 ? (double)INFINITY : -(double)INFINITY;
  int64_t cnt = 0;
  for (int64_t c = 0; c < chunks; ++c) {
    const int s = (int)(c % kStages);
    mbar_wait(&full[s], (int)((c / kStages) & 1));
    if (t < TW) {
      const double* stage = ring[s] + t;
      const int m = (int)min((int64_t)kChunk, n - c * kChunk);
#pragma unroll 8
      for (int i = 0; i < m; ++i) {
        const double x = stage[i * TW];
        const bool present = x == x;
        sum = __dadd_rn(sum, present ? x : -0.0);
        cnt += present;
        if (a.op == 3) ext = x < ext ? x : ext;
        else if (a.op == 4) ext = x > ext ? x : ext;
      }
    }
    __syncwarp();
    if (t == 0) mbar_arrive(&empty[s]);
  }
  if (t < TW && w0 + t < a.n_steps) {
    a.out[g * a.n_steps + w0 + t] = finish(sum, (double)cnt, ext, a.op);
  }
}

GT_EXPORT int gt_series_fold(const FoldArgs* args, void* stream) {
  const FoldArgs& a = *args;
  const int64_t cells = a.n_groups * a.n_steps;
  if (cells <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t blocks = a.tw > 0 ? a.n_groups * ((a.n_steps + a.tw - 1) / a.tw)
                                  : (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (a.tw) {
    case 0: cells_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a); break;
    case 8: staged_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(a); break;
    case 16: staged_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(a); break;
    case 32: staged_kernel<32><<<(unsigned)blocks, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
