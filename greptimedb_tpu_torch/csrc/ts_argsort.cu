// K14 ts_argsort: the stable ts-ascending permutation of a super-tile,
//   perm = argsort(where(valid, ts, INT64_MAX), stable)  -> int32 [n]
// read through the entry's chunk tables (ts int64, valid uint8).
//
// Replaces greptimedb_tpu/parallel/tile_cache.py:2680 `ensure_perm` (B13),
// a jnp.argsort (stable) over the concatenated chunks.  Ties in ts are
// the normal case (every host of one scrape shares its ts): a stable sort
// keeps them in (pk, ts) row order, which every blocked fold and limb
// scale over the time-major copies depends on, so the result must be the
// reference's permutation exactly, not just a valid sort.
//
// Design: a least-significant-digit radix sort, 8 bits a pass.
//   1. gt_argsort_range: min and max of the valid keys (one reduction).
//   2. The host picks the number of passes from max - min.  Keys become
//      ts - min (unsigned); an invalid row gets max - min + 1, which sorts
//      after every real row as INT64_MAX does in the reference (or ties
//      with real rows at INT64_MAX, in row order, when max is INT64_MAX).
//   3. gt_argsort_passes: a prepare kernel writes the keys and the iota;
//      per pass a per-tile digit histogram (tile = 4096 rows), one
//      exclusive scan over (digit, tile) (three coalesced kernels) and a
//      stable scatter.  Within a
//      tile the rows are ranked in row order: 16 rounds of 256 rows, the
//      rank among equal digits of a warp from __match_any_sync, across
//      the warps of a round from per-warp counts in shared memory, across
//      rounds from a running count per digit.  No atomics decide an
//      order, so the output is the same on every run.
//
// Bound on the H100: bytes.  The least traffic is the keys and valid
// read once and the perm written once (13 B a row); each pass here moves
// the keys and indices in and out (24 B a row) plus a histogram read of
// the keys, so at 4 passes (a 12 h ms range) the kernel moves ~10x its
// bound.
#include "common.cuh"

constexpr int kTileRows = 4096;
constexpr int kThreads = 256;
constexpr int kRounds = kTileRows / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kScanThreads = 1024;

typedef unsigned long long u64;

struct RangeArgs {
  ChunkTable ts;       // int64
  ChunkTable valid;    // uint8
  int64_t n;
  long long* range;    // [2]: min, max of the valid keys (INT64_MAX, INT64_MIN if none)
};

struct PassArgs {
  ChunkTable ts;
  ChunkTable valid;
  int64_t n;
  u64* keys[2];        // [n] scratch, ping-pong
  int32_t* idx[2];     // [n] scratch, ping-pong
  int32_t* hist;       // [kRadix * n_tiles] scratch
  int32_t* seg_sums;   // [ceil(kRadix * n_tiles / kScanSeg)] scratch
  int32_t* out;        // [n] the permutation
  int64_t lo;          // min valid key
  u64 fill;            // key of an invalid row
  int32_t n_passes;
  int32_t reserved;
};

__global__ void range_init_kernel(long long* range) {
  range[0] = 0x7fffffffffffffffLL;
  range[1] = kInt64Min;
}

__global__ void __launch_bounds__(kThreads) range_kernel(const RangeArgs a) {
  long long mn = 0x7fffffffffffffffLL, mx = kInt64Min;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * kThreads) {
    if (chunk_load<uint8_t>(a.valid, i)) {
      const long long t = chunk_load<long long>(a.ts, i);
      mn = t < mn ? t : mn;
      mx = t > mx ? t : mx;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long m2 = __shfl_down_sync(0xffffffffu, mn, o);
    const long long x2 = __shfl_down_sync(0xffffffffu, mx, o);
    mn = m2 < mn ? m2 : mn;
    mx = x2 > mx ? x2 : mx;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&a.range[0], mn);
    atomicMax(&a.range[1], mx);
  }
}

__global__ void prepare_kernel(const PassArgs a, u64* keys, int32_t* idx) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool v = chunk_load<uint8_t>(a.valid, i) != 0;
    keys[i] = v ? (u64)chunk_load<long long>(a.ts, i) - (u64)a.lo : a.fill;
    idx[i] = (int32_t)i;
  }
}

// Per-tile digit counts.  Rows of one scrape share their ts, so a warp's
// digits are mostly equal: one shared atomic per distinct digit of a warp.
__global__ void __launch_bounds__(kThreads) hist_kernel(const u64* keys, int64_t n, int shift,
                                                        int32_t* hist, int64_t n_tiles) {
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
                                                               int32_t* sums) {
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int64_t b = (int64_t)blockIdx.x * kScanSeg + (int64_t)threadIdx.x * kScanItems;
  int32_t s = 0;
  for (int k = 0; k < kScanItems; ++k) s += b + k < len ? hist[b + k] : 0;
  int32_t total;
  block_exclusive_scan(s, warp_tot, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads) seg_apply_kernel(int32_t* hist, int64_t len,
                                                                 const int32_t* offs) {
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
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int32_t* hist, int64_t len) {
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
    const int32_t* offs, int64_t n_tiles, int write_keys) {
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

GT_EXPORT int gt_argsort_range(const RangeArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  range_init_kernel<<<1, 1, 0, s>>>(args->range);
  if (args->n > 0) range_kernel<<<grid_for(args->n, kThreads), kThreads, 0, s>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_argsort_passes(const PassArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const PassArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  const int64_t n_tiles = (a.n + kTileRows - 1) / kTileRows;
  const int64_t len = (int64_t)kRadix * n_tiles;
  const int64_t n_segs = (len + kScanSeg - 1) / kScanSeg;
  if (a.n_passes == 0) {
    // one key for every row: the stable order is the row order
    prepare_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a, a.keys[0], a.out);
    return (int)cudaGetLastError();
  }
  prepare_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a, a.keys[0], a.idx[0]);
  int cur = 0;
  for (int p = 0; p < a.n_passes; ++p) {
    const bool last = p == a.n_passes - 1;
    const int shift = 8 * p;
    hist_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(a.keys[cur], a.n, shift, a.hist, n_tiles);
    seg_sum_kernel<<<(unsigned)n_segs, kScanThreads, 0, s>>>(a.hist, len, a.seg_sums);
    scan_kernel<<<1, kScanThreads, 0, s>>>(a.seg_sums, n_segs);
    seg_apply_kernel<<<(unsigned)n_segs, kScanThreads, 0, s>>>(a.hist, len, a.seg_sums);
    scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        a.keys[cur], a.idx[cur], a.keys[1 - cur], last ? a.out : a.idx[1 - cur], a.n, shift,
        a.hist, n_tiles, last ? 0 : 1);
    cur = 1 - cur;
  }
  return (int)cudaGetLastError();
}
