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
//   3. gt_argsort_passes: a prepare kernel writes the keys and the iota,
//      then the stable radix passes of radix.cuh (shared with the
//      segment sort of csrc/segment_sort.cu).
//
// Bound on the H100: bytes.  The least traffic is the keys and valid
// read once and the perm written once (13 B a row); each pass here moves
// the keys and indices in and out (24 B a row) plus a histogram read of
// the keys, so at 4 passes (a 12 h ms range) the kernel moves ~10x its
// bound.
#include "radix.cuh"

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
  if (a.n_passes == 0) {
    // one key for every row: the stable order is the row order
    prepare_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a, a.keys[0], a.out);
    return (int)cudaGetLastError();
  }
  prepare_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a, a.keys[0], a.idx[0]);
  const RadixScratch r = {{a.keys[0], a.keys[1]}, {a.idx[0], a.idx[1]}, a.hist, a.seg_sums};
  return (int)radix_passes(r, a.n, a.n_passes, a.out, nullptr, Gate{nullptr, 0, 0}, s);
}
