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
// Design: the one-sweep LSD radix sort of radix.cuh (shared with K18 and
// K19's large-k branch).
//   1. gt_argsort_range: min and max of the valid ts (one reduction
//      through the chunk tables).
//   2. The host reads them and plans the sort (ops/permute.py
//      `argsort_keys`, ops/radix.py `radix_plan`): keys become ts - min;
//      an invalid row gets the largest key plus one, which sorts after
//      every real row as INT64_MAX does in the reference (or ties with
//      real rows at INT64_MAX, in row order, when max is INT64_MAX).  The
//      largest key sets the key width (u32 up to 2^32 - 1) and the digits:
//      12 h of ms (26 bits) takes three passes.
//   3. gt_argsort_passes: the histogram kernel and the first pass compute
//      the keys from ts and valid on the card; the last pass writes the
//      int32 permutation.
//
// Bound on the H100: bytes.  The least traffic is the keys and valid
// read once and the perm written once (13 B a row).  At 12 h the kernels
// move about 69 B a row: the range and the histogram read ts and valid
// (9 B each), the histogram zeroes the look-back words of the three
// passes (512 + 512 + 256 a tile of 4096 rows, 1.3 B); the first pass
// reads ts and valid and writes u32 keys and rows (17 B), the second
// reads and writes them (16 B), the last reads them and writes the perm
// (12 B); each pass writes its look-back words twice and reads some
// (1-2 B).
#include "radix.cuh"

struct RangeArgs {
  ChunkTable ts;       // int64
  ChunkTable valid;    // uint8
  int64_t n;
  long long* range;    // [2] min and max of the valid ts (INT64_MAX, INT64_MIN if none)
  int32_t kernels;     // out: the kernels launched
};

// Mirrored field for field by _ArgsortArgs in ops/permute.py (ctypes).
struct ArgsortArgs {
  ChunkTable ts;
  ChunkTable valid;
  int64_t n;
  int32_t* out;        // [n] the permutation
  int64_t lo;          // min valid ts
  u64 fill;            // key of an invalid row
  RadixPlan plan;
  RadixScratch scratch;
};

// Where rows [first, last] of a chunked plane live: false when they
// straddle two chunks, else row i is at p[i - off].
template <typename T>
__device__ __forceinline__ bool chunk_span(const ChunkTable& t, int64_t first, int64_t last,
                                           const T*& p, int64_t& off) {
  const uint32_t rows = (uint32_t)t.chunk_rows;  // n < 2^31
  const uint32_t c = (uint32_t)first / rows;
  if ((uint32_t)last / rows != c) return false;
  p = (const T*)t.ptr[c];
  off = (int64_t)c * rows;
  return true;
}

// f(k, i, ts, valid) for the rows i = base + 32 k below n that one thread
// of a tile holds (radix.cuh), read through the chunk tables.
template <typename F>
__device__ __forceinline__ void for_rows(const ChunkTable& ts, const ChunkTable& valid,
                                         int64_t base, int64_t n, F f) {
  if (base >= n) return;
  const int64_t tail = base + (int64_t)(kItems - 1) * 32;
  const int64_t last = tail < n ? tail : n - 1;
  const long long* tp;
  const uint8_t* vp;
  int64_t toff, voff;
  if (chunk_span(ts, base, last, tp, toff) && chunk_span(valid, base, last, vp, voff)) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)k * 32;
      if (i < n) f(k, i, tp[i - toff], vp[i - voff] != 0);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)k * 32;
      if (i < n) f(k, i, chunk_load<long long>(ts, i), chunk_load<uint8_t>(valid, i) != 0);
    }
  }
}

__global__ void range_init_kernel(long long* range) {
  range[0] = 0x7fffffffffffffffLL;
  range[1] = kInt64Min;
}

__global__ void __launch_bounds__(kThreads) range_kernel(const RangeArgs a) {
  long long mn = 0x7fffffffffffffffLL, mx = kInt64Min;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t t = blockIdx.x; t * kTileRows < a.n; t += gridDim.x) {
    for_rows(a.ts, a.valid, t * kTileRows + warp * 32 * kItems + lane, a.n,
             [&](int, int64_t, long long ts, bool v) {
               if (v) {
                 mn = ts < mn ? ts : mn;
                 mx = ts > mx ? ts : mx;
               }
             });
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long m2 = __shfl_down_sync(0xffffffffu, mn, o);
    const long long x2 = __shfl_down_sync(0xffffffffu, mx, o);
    mn = m2 < mn ? m2 : mn;
    mx = x2 > mx ? x2 : mx;
  }
  if (lane == 0) {
    atomicMin(&a.range[0], mn);
    atomicMax(&a.range[1], mx);
  }
}

// The sort's source: key = valid ? ts - lo : fill, row = i.
template <typename KeyT>
struct ArgsortSrc {
  ChunkTable ts;
  ChunkTable valid;
  int64_t lo;
  u64 fill;

  __device__ __forceinline__ void load_items(int64_t base, int64_t n, KeyT (&key)[kItems],
                                             int32_t (&row)[kItems]) const {
    for_rows(ts, valid, base, n, [&](int k, int64_t i, long long t, bool v) {
      key[k] = (KeyT)(v ? (u64)t - (u64)lo : fill);
      row[k] = (int32_t)i;
    });
  }
};

// The sort's sink: the permutation.
struct PermDst {
  int32_t* out;
  template <typename KeyT>
  __device__ __forceinline__ void put(int64_t pos, KeyT, int32_t row) const {
    out[pos] = row;
  }
};

GT_EXPORT int gt_argsort_range(RangeArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  range_init_kernel<<<1, 1, 0, s>>>(args->range);
  args->kernels = 1;
  const int64_t tiles = (args->n + kTileRows - 1) / kTileRows;
  if (args->n > 0) {
    range_kernel<<<(unsigned)(tiles < kHistBlocks ? tiles : kHistBlocks), kThreads, 0, s>>>(*args);
    ++args->kernels;
  }
  return (int)cudaGetLastError();
}

template <typename KeyT>
static cudaError_t argsort(ArgsortArgs& a, cudaStream_t s) {
  const ArgsortSrc<KeyT> src = {a.ts, a.valid, a.lo, a.fill};
  const PermDst dst = {a.out};
  return onesweep_sort<KeyT>(src, dst, a.n, a.plan, a.scratch, Gate{nullptr, 0, 0}, s);
}

GT_EXPORT int gt_argsort_passes(ArgsortArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ArgsortArgs& a = *args;
  return (int)(a.plan.key_bytes == 4 ? argsort<uint32_t>(a, s) : argsort<u64>(a, s));
}
