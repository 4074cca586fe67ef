// K21 segment_udd: per-group bucket-count histograms (the device
// UDDSketch),
//   flat   = int32(gids) * B + int32(bucket_ids)   (wrapping int32)
//   flat   = where(mask, flat, G * B)              (the overflow slot)
//   counts = segment_sum(mask, flat, num_segments = G * B + 1)[:G * B]
// -> counts int32 [G * B] (the wrapper reshapes to [G, B]).  A masked row
// adds nothing; a row whose flat id falls below 0 or at/after G * B is
// dropped (JAX's segment ops drop ids outside [0, num_segments), and the
// overflow slot is cut off).
//
// Replaces greptimedb_tpu/ops/sketch.py:403 `segment_udd` (B21: one
// jax.ops.segment_sum with an overflow slot for masked rows).
//
// Int32 wrap.  As in K20 (segment_hll.cu): the id is computed in uint32
// and cast to int32, the reference's two's complement wrap.
//
// Bound on the H100: bytes.  Each row reads bucket_ids, gids (4 B each)
// and mask (1 B) once, and the counts are written once (G * B * 4 B):
// 17.28 M rows and G = 4000, B = 1024 are 156 MB + 16 MB, 0.051 ms at
// 3.35 TB/s.
//
// Design.  The wrapper zero-fills the counts.  A grid-stride loop over
// whole warps (every lane of a warp takes the same trip count, so the
// warp votes stay converged) gives each lane one row; __match_any_sync on
// the flat id groups the lanes that add to one bucket, and the lowest
// lane of each group adds the group's popcount with one atomicAdd.  Rows
// that arrive in (host, ts) order put a warp's 32 rows on one group and a
// few buckets, where a per-row atomicAdd would serialize on them.  (A
// shared-memory window per tile of rows, merged once per tile, measured
// slower at these shapes: PERF.md §6.)  Integer adds are order free,
// so every run gives the same bytes.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;
constexpr unsigned kFull = 0xffffffffu;

// Mirrored field for field by _UddArgs in ops/sketch.py (ctypes).
struct UddArgs {
  int64_t n;               // rows
  int64_t total;           // G * B
  const int32_t* bucket;   // [n]
  const int32_t* gids;     // [n]
  const uint8_t* mask;     // [n] bool
  int32_t* counts;         // [total] out, zero-filled by the wrapper
  int32_t n_buckets;
  int32_t reserved;
};

__global__ void __launch_bounds__(kThreads) udd_kernel(UddArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // base is the row of the warp's lane 0, the same on every lane
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane); base < a.n;
       base += stride) {
    const int64_t i = base + lane;
    int32_t key = -1;  // no add
    if (i < a.n && a.mask[i]) {
      const int32_t flat =
          (int32_t)((uint32_t)a.gids[i] * (uint32_t)a.n_buckets + (uint32_t)a.bucket[i]);
      if (flat >= 0 && (int64_t)flat < a.total) key = flat;
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(a.counts + key, __popc(peers));
  }
}

GT_EXPORT int gt_segment_udd(const UddArgs* a, void* stream) {
  const int64_t want = (a->n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want < kSms * kBlocksPerSm ? want : kSms * kBlocksPerSm));
  udd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
