// The stable LSD radix passes shared by K14 (csrc/ts_argsort.cu) and the
// flag-reading segment sort (csrc/segment_sort.cu): 8 bits a pass over
// u64 keys with int32 row indices, ping-pong buffers.  Per pass a
// per-tile digit histogram (tile = 4096 rows), one exclusive scan over
// (digit, tile) (three coalesced kernels) and a stable scatter.  Within a
// tile the rows are ranked in row order: 16 rounds of 256 rows, the rank
// among equal digits of a warp from __match_any_sync, across the warps of
// a round from per-warp counts in shared memory, across rounds from a
// running count per digit.  No atomics decide an order, so the output is
// the same on every run.  Every kernel takes a Gate (common.cuh): a
// predicated sort returns at once when its branch is not taken.
#pragma once

#include "common.cuh"

constexpr int kTileRows = 4096;
constexpr int kThreads = 256;
constexpr int kRounds = kTileRows / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kScanThreads = 1024;

typedef unsigned long long u64;

// Per-tile digit counts.  Rows of one scrape share their ts, so a warp's
// digits are mostly equal: one shared atomic per distinct digit of a warp.
__global__ void __launch_bounds__(kThreads) hist_kernel(const u64* keys, int64_t n, int shift,
                                                        int32_t* hist, int64_t n_tiles,
                                                        const Gate g) {
  if (gate_shut(g)) return;
  __shared__ int32_t h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t t0 = (int64_t)blockIdx.x * kTileRows;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = t0 + r * kThreads + threadIdx.x;
    const int digit = i < n ? (int)((keys[i] >> shift) & (kRadix - 1)) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit < kRadix && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// Exclusive scan of one CTA's values (one per thread) in shared memory;
// returns this thread's exclusive prefix and sets *total.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_tot,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t w = lane < nw ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int32_t before = (warp ? warp_tot[warp - 1] : 0) + x - v;
  *total = warp_tot[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before;
}

// The (digit, tile) scan in three coalesced passes: per segment of
// kScanSeg entries its sum, one CTA over the segment sums, then each
// segment rescanned from its offset.  A thread owns kScanItems
// consecutive entries.
constexpr int kScanItems = 8;
constexpr int kScanSeg = kScanThreads * kScanItems;

__global__ void __launch_bounds__(kScanThreads) seg_sum_kernel(const int32_t* hist, int64_t len,
                                                               int32_t* sums, const Gate g) {
  if (gate_shut(g)) return;
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int64_t b = (int64_t)blockIdx.x * kScanSeg + (int64_t)threadIdx.x * kScanItems;
  int32_t s = 0;
  for (int k = 0; k < kScanItems; ++k) s += b + k < len ? hist[b + k] : 0;
  int32_t total;
  block_exclusive_scan(s, warp_tot, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads) seg_apply_kernel(int32_t* hist, int64_t len,
                                                                 const int32_t* offs,
                                                                 const Gate g) {
  if (gate_shut(g)) return;
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int64_t b = (int64_t)blockIdx.x * kScanSeg + (int64_t)threadIdx.x * kScanItems;
  int32_t v[kScanItems];
  int32_t s = 0;
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = b + k < len ? hist[b + k] : 0;
    s += v[k];
  }
  int32_t total;
  int32_t run = offs[blockIdx.x] + block_exclusive_scan(s, warp_tot, &total);
  for (int k = 0; k < kScanItems; ++k) {
    if (b + k < len) hist[b + k] = run;
    run += v[k];
  }
}

// Exclusive scan of a short array in place, one CTA: each thread owns a
// contiguous segment (the segment sums above).
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int32_t* hist, int64_t len, const Gate g) {
  if (gate_shut(g)) return;
  __shared__ int32_t part[kScanThreads];
  const int64_t seg = (len + kScanThreads - 1) / kScanThreads;
  const int64_t b = (int64_t)threadIdx.x * seg;
  const int64_t e = b + seg < len ? b + seg : len;
  int32_t s = 0;
  for (int64_t i = b; i < e; ++i) s += hist[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int32_t add = threadIdx.x >= o ? part[threadIdx.x - o] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - s;  // exclusive prefix of this segment
  for (int64_t i = b; i < e; ++i) {
    const int32_t v = hist[i];
    hist[i] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const u64* kin, const int32_t* iin, u64* kout, int32_t* iout, int64_t n, int shift,
    const int32_t* offs, int64_t n_tiles, int write_keys, const Gate g) {
  if (gate_shut(g)) return;
  __shared__ int32_t base[kRadix];
  __shared__ int32_t wcnt[kWarps][kRadix];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  base[tid] = offs[(int64_t)tid * n_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
  __syncthreads();
  const int64_t t0 = (int64_t)blockIdx.x * kTileRows;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = t0 + r * kThreads + tid;
    const bool live = i < n;
    u64 key = 0;
    int digit = kRadix;  // past the end: its own class, never written
    if (live) {
      key = kin[i];
      digit = (int)((key >> shift) & (kRadix - 1));
    }
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & lt);
    if (live && rank == 0) wcnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (live) {
      int32_t pos = base[digit] + rank;
      for (int w = 0; w < warp; ++w) pos += wcnt[w][digit];
      iout[pos] = iin[i];
      if (write_keys) kout[pos] = key;
    }
    __syncthreads();
    int32_t add = 0;
    for (int w = 0; w < kWarps; ++w) {
      add += wcnt[w][tid];
      wcnt[w][tid] = 0;
    }
    base[tid] += add;
    __syncthreads();
  }
}

static int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  if (g > 132 * 32) g = 132 * 32;
  return g < 1 ? 1 : (int)g;
}


// Scratch of the radix passes over n rows.
struct RadixScratch {
  u64* keys[2];        // [n] ping-pong; keys[0] holds the prepared keys
  int32_t* idx[2];     // [n] ping-pong; idx[0] holds the prepared indices
  int32_t* hist;       // [kRadix * n_tiles]
  int32_t* seg_sums;   // [ceil(kRadix * n_tiles / kScanSeg)]
};

// The passes over keys[0] / idx[0]: the last writes its indices to
// `out_idx` (and, with `out_keys`, its keys there).  Returns the launch
// error.
static cudaError_t radix_passes(const RadixScratch& r, int64_t n, int n_passes, int32_t* out_idx,
                                u64* out_keys, const Gate g, cudaStream_t s) {
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t len = (int64_t)kRadix * n_tiles;
  const int64_t n_segs = (len + kScanSeg - 1) / kScanSeg;
  int cur = 0;
  for (int p = 0; p < n_passes; ++p) {
    const bool last = p == n_passes - 1;
    const int shift = 8 * p;
    hist_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(r.keys[cur], n, shift, r.hist, n_tiles, g);
    seg_sum_kernel<<<(unsigned)n_segs, kScanThreads, 0, s>>>(r.hist, len, r.seg_sums, g);
    scan_kernel<<<1, kScanThreads, 0, s>>>(r.seg_sums, n_segs, g);
    seg_apply_kernel<<<(unsigned)n_segs, kScanThreads, 0, s>>>(r.hist, len, r.seg_sums, g);
    u64* kout = last ? out_keys : r.keys[1 - cur];
    scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        r.keys[cur], r.idx[cur], kout, last ? out_idx : r.idx[1 - cur], n, shift, r.hist,
        n_tiles, kout != nullptr ? 1 : 0, g);
    cur = 1 - cur;
  }
  return cudaGetLastError();
}
