// K16 delta_patch: merge a sorted delta run into one resident plane.
//
// Replaces greptimedb_tpu/parallel/tile_cache.py:292 `_delta_patch` (B11):
// old row i (of old_n) goes to i + #{j : pos[j] <= i}, delta row j to
// pos[j] + j, and rows past old_n + n_delta are zero (a `valid` plane
// patched this way is false there).  `pos` (sorted, from the host's merge
// of the two sorted runs) and the delta values are the only host-to-
// device traffic; the old rows move at HBM bandwidth.
//
// Design: written as a gather over the output, so every output row is
// written exactly once and no scatter collides.  Delta row j sits at
// pos[j] + j, which strictly increases with j, so the delta rows before
// output row r are c(r) = #{j : pos[j] + j < r}: r is delta row c(r) when
// pos[c] + c == r, else old row r - c(r).  A CTA owns 4096 output rows;
// two binary searches over the whole `pos` bound the delta rows that can
// land in its tile, and each row searches only that window (a few steps
// at a 4 % delta).  Old rows are read through the old chunk table, the
// output written through the new one.
//
// Bound on the H100: bytes — each old row read once and each output row
// written once (16 B a row for an f64 plane), plus pos and the delta.
#include "common.cuh"

struct PatchArgs {
  ChunkTable old_rows;  // [old_n] (chunks of the old entry)
  ChunkTable dst;       // [new_pad] (chunks of the new entry)
  const void* delta;    // [n_delta], contiguous
  const int32_t* pos;   // [n_delta], non-decreasing
  int64_t old_n;
  int64_t n_delta;
  int64_t new_pad;
  int32_t esize;        // 1, 4 or 8
  int32_t reserved;
};

constexpr int kTile = 4096;
constexpr int kThreads = 256;

// #{j in [lo, hi) : pos[j] + j < r} + lo, given the predicate holds on a
// prefix of [lo, hi).
__device__ __forceinline__ int64_t before(const int32_t* pos, int64_t lo, int64_t hi, int64_t r) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)pos[mid] + mid < r) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) patch_kernel(const PatchArgs a) {
  __shared__ int64_t win[2];
  const int64_t r0 = (int64_t)blockIdx.x * kTile;
  if (threadIdx.x < 2) win[threadIdx.x] = before(a.pos, 0, a.n_delta, r0 + threadIdx.x * kTile);
  __syncthreads();
  const int64_t lo = win[0], hi = win[1];
  const int64_t total = a.old_n + a.n_delta;
  const T* delta = (const T*)a.delta;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t r = r0 + k;
    if (r >= a.new_pad) break;
    T v = 0;
    if (r < total) {
      const int64_t c = before(a.pos, lo, hi, r);
      if (c < a.n_delta && (int64_t)a.pos[c] + c == r) v = delta[c];
      else v = chunk_load<T>(a.old_rows, r - c);
    }
    chunk_store<T>(a.dst, r, v);
  }
}

GT_EXPORT int gt_delta_patch(const PatchArgs* args, void* stream) {
  if (args->new_pad <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)((args->new_pad + kTile - 1) / kTile);
  switch (args->esize) {
    case 1: patch_kernel<uint8_t><<<g, kThreads, 0, s>>>(*args); break;
    case 4: patch_kernel<uint32_t><<<g, kThreads, 0, s>>>(*args); break;
    case 8: patch_kernel<unsigned long long><<<g, kThreads, 0, s>>>(*args); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
