// K16 delta_patch: merge a sorted delta run into one resident plane.
//
// Replaces greptimedb_tpu/parallel/tile_cache.py:292 `_delta_patch` (B11):
// old row i (of old_n) goes to i + #{j : pos[j] <= i}, delta row j to
// pos[j] + j, and rows past old_n + n_delta are zero (a `valid` plane
// patched this way is false there).  `pos` (sorted, from the host's merge
// of the two sorted runs) and the delta values are the only host-to-
// device traffic; the old rows move at HBM bandwidth.
//
// Bound on the H100: bytes — each old row read once and each output row
// written once (16 B a row for an f64 plane), plus pos and the delta.
//
// Design: a gather over the output, so every output row is written
// exactly once and no scatter collides.  Delta row j sits at q(j) =
// pos[j] + j, which strictly increases with j.  A CTA owns a tile of up
// to 4096 output rows inside one destination chunk (the chunk from the
// tile index: one 32-bit division a CTA, never a 64-bit one a row).
//
// * The window.  The tile's delta rows are [lo, hi), the j with q(j) in
//   the tile.  Two warps find lo and hi at once, each by a 32-way search:
//   a lane probes the last entry of one of 32 equal blocks of the range
//   and a ballot counts the blocks below the key (4 dependent rounds over
//   737,280 entries).
// * The old rows.  The tile's old rows are one contiguous range, from
//   old row r0 - lo on; it is copied into shared memory with 16 B
//   `cp.async` copies (scalar at a chunk's unaligned edge), split where it
//   crosses an old chunk bound (the chunk by a shift, or one 32-bit
//   division, a split).  The window's delta values follow it there.
// * The flags.  Each delta row sets one bit of a 4096-bit mask at q(j) -
//   r0; one warp scans the mask's 128 words, so the delta rows before any
//   row of the tile are a word's prefix plus one popcount: no search a
//   row.
// * The output.  A thread builds 16 B of consecutive rows at a time (16
//   bool rows, 4 int32, 2 f64) from shared memory and stores them as one
//   vector (scalar only at the plane's unaligned tail).
// The descriptor goes to the kernel by value.
#include "common.cuh"

// Mirrored field for field by _PatchArgs in ops/permute.py (ctypes).
struct PatchArgs {
  ChunkTable old_rows;       // [old_n] (chunks of the old entry)
  ChunkTable dst;            // [new_pad] (chunks of the new entry)
  const void* delta;         // [n_delta], contiguous
  const int32_t* pos;        // [n_delta], non-decreasing
  int64_t old_n;
  int64_t n_delta;
  int64_t new_pad;           // < 2^31
  int32_t esize;             // 1, 4 or 8
  int32_t old_shift;         // log2(old chunk rows) when a power of two, else -1
  uint32_t tiles_per_chunk;  // ceil(dst chunk rows / kTile)
  uint32_t n_tiles;
  int32_t vec_old;           // 1: 16 B copies of the old rows line up (see the wrapper)
  int32_t vec_dst;           // 1: every output chunk 16 B aligned
};

constexpr int kTile = 4096;
constexpr int kThreads = 256;
constexpr int kWords = kTile / 32;  // flag words of a tile
constexpr unsigned kFull = 0xffffffffu;

// The first j in [0, n) with pos[j] + j >= key (n if none), found by one
// whole warp; every lane returns it.
__device__ __forceinline__ uint32_t warp_lower_bound(const int32_t* pos, uint32_t n, int32_t key) {
  const uint32_t lane = threadIdx.x & 31;
  uint32_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const uint32_t s = (hi - lo + 31) >> 5;  // block length
    const uint32_t start = lo + lane * s;
    const bool valid = start < hi;
    const uint32_t probe = min(start + s, hi) - 1;
    const bool below = valid && __ldg(pos + probe) + (int32_t)probe < key;
    const uint32_t blocks = __popc(__ballot_sync(kFull, valid));
    const uint32_t cnt = __popc(__ballot_sync(kFull, below));
    if (cnt == blocks) {
      lo = hi;
    } else {  // block cnt holds the answer, its last entry at or past the key
      const uint32_t nlo = lo + cnt * s;
      hi = min(nlo + s, hi) - 1;
      lo = nlo;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Rows [0, cnt) of src into to; with vec, src + i and to + i share their
// place in a 16 B vector, and whole vectors go by cp.async (the rows
// before the first whole vector and after the last one, or every row
// without vec, one a thread).
template <typename T>
__device__ __forceinline__ void copy_rows(T* to, const T* src, int cnt, bool vec) {
  constexpr int V = 16 / sizeof(T);
  int head = 0, nv = 0;
  if (vec) {
    head = min((int)((V - (((uintptr_t)src / sizeof(T)) & (V - 1))) & (V - 1)), cnt);
    nv = (cnt - head) / V;
    const int4* s4 = (const int4*)(src + head);
    int4* t4 = (int4*)(to + head);
    for (int q = threadIdx.x; q < nv; q += kThreads) cp_async16(t4 + q, s4 + q);
  }
  const int tail = head + nv * V;
  if ((int)threadIdx.x < head) to[threadIdx.x] = __ldg(src + threadIdx.x);
  for (int i = tail + threadIdx.x; i < cnt; i += kThreads) to[i] = __ldg(src + i);
}

template <typename T>
union Vec16 {
  int4 q;
  T e[16 / sizeof(T)];
};

// CTAs an SM the registers must allow: eight (all 2048 threads, at most
// 32 registers a thread) for int32 planes; six for f64, whose 33.8 KB of
// shared memory allow no more, and for bool, whose 16-row vectors spill at
// 32 registers.
template <typename T>
constexpr int kMinCtas = sizeof(T) == 4 ? 8 : 6;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas<T>)
    patch_kernel(const __grid_constant__ PatchArgs a) {
  constexpr int V = 16 / sizeof(T);
  // the tile's old rows from buf[sh], then its delta rows
  __shared__ __align__(16) T buf[kTile + V];
  __shared__ uint32_t flags[kWords];
  __shared__ int32_t before[kWords];  // delta rows of the tile before each flag word
  __shared__ uint32_t win[2];

  const uint32_t tile = blockIdx.x;
  const uint32_t c = tile / a.tiles_per_chunk;  // the destination chunk
  const uint32_t cr = (uint32_t)a.dst.chunk_rows;
  const uint32_t off = (tile - c * a.tiles_per_chunk) * kTile;
  const uint32_t rows_c =
      (int32_t)c + 1 == a.dst.n_chunks ? (uint32_t)a.new_pad - c * cr : cr;
  const int len = (int)min((uint32_t)kTile, rows_c - off);
  const int32_t r0 = (int32_t)(c * cr + off);
  const int32_t total = (int32_t)(a.old_n + a.n_delta);
  const uint32_t nd = (uint32_t)a.n_delta;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x < kWords) flags[threadIdx.x] = 0;
  if (warp < 2) {
    // a tile past the merged rows holds no delta row; an empty delta none
    const uint32_t w = nd == 0      ? 0
                       : r0 >= total ? nd
                                     : warp_lower_bound(a.pos, nd, r0 + (warp ? len : 0));
    if ((threadIdx.x & 31) == 0) win[warp] = w;
  }
  __syncthreads();
  const int32_t lo = (int32_t)win[0], hi = (int32_t)win[1];
  const int m = max(0, min(len, total - r0));  // merged rows of the tile; the rest are zero
  const int n_old = m - (hi - lo);
  const int32_t a0 = r0 - lo;  // the tile's first old row
  const int sh = a.vec_old ? (a0 & (V - 1)) : 0;

  // the old rows, a piece per old chunk they cross
  const uint32_t ocr = (uint32_t)a.old_rows.chunk_rows;
  for (int32_t o = a0, end = a0 + n_old; o < end;) {
    const uint32_t ci = a.old_shift >= 0 ? (uint32_t)o >> a.old_shift : (uint32_t)o / ocr;
    const int32_t cbase = (int32_t)(ci * ocr);
    const int64_t chunk_end = (int64_t)cbase + ocr;
    const int32_t stop = chunk_end < end ? (int32_t)chunk_end : end;
    copy_rows<T>(buf + sh + (o - a0), (const T*)a.old_rows.ptr[ci] + (o - cbase), stop - o,
                 a.vec_old != 0);
    o = stop;
  }
  // the delta rows: a flag each, their values after the old rows
  const T* delta = (const T*)a.delta;
  for (int32_t j = lo + threadIdx.x; j < hi; j += kThreads) {
    const int32_t t = __ldg(a.pos + j) + j - r0;
    atomicOr(&flags[t >> 5], 1u << (t & 31));
    buf[sh + n_old + (j - lo)] = __ldg(delta + j);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the flag words' popcounts
    const int lane = threadIdx.x;
    int32_t cnt[kWords / 32], sum = 0;
#pragma unroll
    for (int u = 0; u < kWords / 32; ++u) {
      cnt[u] = __popc(flags[(kWords / 32) * lane + u]);
      sum += cnt[u];
    }
    int32_t inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    int32_t ex = inc - sum;
#pragma unroll
    for (int u = 0; u < kWords / 32; ++u) {
      before[(kWords / 32) * lane + u] = ex;
      ex += cnt[u];
    }
  }
  __syncthreads();

  // the output, V rows (16 B) a thread a step; V divides 32, so the V rows
  // of a step share one flag word
  T* dst = (T*)a.dst.ptr[c] + off;
  for (int i0 = threadIdx.x * V; i0 < len; i0 += kThreads * V) {
    const uint32_t word = flags[i0 >> 5];
    int32_t d = before[i0 >> 5] + __popc(word & ((1u << (i0 & 31)) - 1));
    Vec16<T> v;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = i0 + e;
      const bool is_delta = (word >> (i & 31)) & 1;
      v.e[e] = i < m ? buf[sh + (is_delta ? n_old + d : i - d)] : (T)0;
      d += is_delta;
    }
    if (a.vec_dst && i0 + V <= len) {
      __stcs((int4*)(dst + i0), v.q);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (i0 + e < len) dst[i0 + e] = v.e[e];
      }
    }
  }
}

GT_EXPORT int gt_delta_patch(const PatchArgs* args, void* stream) {
  if (args->n_tiles == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = args->n_tiles;
  switch (args->esize) {
    case 1: patch_kernel<uint8_t><<<g, kThreads, 0, s>>>(*args); break;
    case 4: patch_kernel<uint32_t><<<g, kThreads, 0, s>>>(*args); break;
    case 8: patch_kernel<unsigned long long><<<g, kThreads, 0, s>>>(*args); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
