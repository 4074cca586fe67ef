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
// 8.64 M rows (4000 hosts x 6 h) at G = 4000, B = 1024 are 77.8 MB +
// 16.4 MB, 0.0281 ms at 3.35 TB/s.  The ordered path reads gids once
// (the run pass) where a window is one group, twice where it holds
// several (the owners again).
//
// Design: two device paths, chosen on the card with no host read, as
// K20's (segment_hll.cu).  Rows arrive in group runs (the TSBS scan's
// (host, ts) order), so each group's histogram can have one owner, in
// shared memory.
//
// * The ordered path (csrc/group_runs.cuh, shared with K20): the run pass
//   sets the verdict and each window's first and last row; a window is
//   `cap` consecutive groups of B buckets (ops/sketch.py::udd_layout: one
//   group where the groups average RUN_GROUP_ROWS rows or more, so the
//   owners read no gids; else 4096 counts, one group from B = 4096).  The
//   host keeps the ordered path off when G * B >= 2^31 (the int32 wrap) or
//   B > kMaxOrderedB (the shared-memory budget).  An owner block per
//   window reads its window's rows beside the verdict, zeroes the window's
//   histograms in shared memory, adds its first `tile_rows` rows with
//   shared atomicAdds (warp-aggregated: a warp's 32 rows are consecutive,
//   and the first lane of each run of equal ids adds the run's length),
//   and stores every count of the window, empty buckets and empty groups
//   included, with coalesced 16-byte stores: no zero fill and no global
//   atomic.  Helper blocks and the fold (+) take the rest of a longer run.
// * The atomic path: the parent's kernel, __match_any_sync on the flat id
//   over whole warps and one global atomicAdd per distinct id in a warp,
//   after a fill.  Where the run pass set the verdict (by-hour gids in host
//   order, ids out of range) the owner launch does the fill; where the host
//   keeps the ordered path off (the wrap) a memset does.
// * An unmasked bucket outside [0, B) (its int32 id aliases into a
//   neighbouring group's row) is skipped by the owners, which set the
//   verdict to kAliased; the finish kernel then adds those rows alone by
//   global atomics on top of the stored windows.
// The finish kernel is the fold of the ordered path and the adds of the
// atomic one: one launch after the owners, whichever path ran.  Integer
// adds are order free, so every run gives the same bytes.
#include "group_runs.cuh"

constexpr int kThreads = 256;
constexpr int kOwnThreads = 128;       // small blocks: more windows in flight
constexpr int kMaxOrderedB = 1 << 15;  // 128 KB of counts in shared memory
constexpr int32_t kAliased = 2;        // the verdict: ordered, with aliasing buckets to add
constexpr unsigned kFull = 0xffffffffu;

// Mirrored field for field by _UddArgs in ops/sketch.py (ctypes).
struct UddArgs {
  int64_t n;               // rows
  int64_t total;           // G * B
  const int32_t* bucket;   // [n]
  const int32_t* gids;     // [n]
  const uint8_t* mask;     // [n] bool
  int32_t* counts;         // [total] out
  int32_t* verdict;        // [1] 0 = ordered, kAliased, any other value the atomic path
  int64_t* windows;        // [2 * n_windows] first row + 1, last row + 1 (0 = none), after
                           // the verdict word's line in one span
  int32_t* scratch;        // [n_tiles * stride] the helpers' partial rows
  int64_t groups;          // G
  int64_t n_windows;       // ceil(G / cap)
  int64_t tile_rows;       // rows an owner or a helper takes
  int64_t n_tiles;         // ceil(n / tile_rows), 0 off the ordered path
  int64_t stride;          // ints per partial row, cap * B rounded up to 4
  int32_t n_buckets;       // B
  int32_t cap;             // groups per window
  int32_t ordered;         // 0: the host keeps the ordered path off
  int32_t reserved;
};

__device__ __forceinline__ bool atomic_path(int32_t v) { return v != 0 && v != kAliased; }

// ---- the run pass ----

__global__ void __launch_bounds__(kRunThreads) run_kernel(const UddArgs a) {
  run_pass_any(a.gids, a.n, a.groups, a.cap, a.verdict, a.windows, a.windows + a.n_windows);
}

// ---- the ordered path ----

constexpr int kOwnRows = 4;      // rows in flight a lane
constexpr int kOwnMinCtas = 12;  // owner CTAs an SM the registers must allow

// A step of the owners' walk: kOwnRows rows a lane, a warp's 32 rows of
// each consecutive.
template <bool kOne>
struct OwnStep {
  uint8_t mk[kOwnRows];
  int32_t bk[kOwnRows];
  int32_t gg[kOne ? 1 : kOwnRows];  // a window of one group reads no gids

  __device__ __forceinline__ void load(const UddArgs& a, int64_t base, int64_t hi, int lane) {
#pragma unroll
    for (int u = 0; u < kOwnRows; ++u) {
      const int64_t r = base + u * (int64_t)blockDim.x + lane;
      const bool in = r < hi;
      mk[u] = in ? a.mask[r] : 0;
      bk[u] = in ? a.bucket[r] : 0;
      if (!kOne) gg[u] = in ? a.gids[r] : 0;
    }
  }
};

// Zero, add rows [lo, hi), store to dst: a window's `width` counts in
// shared memory (groups from ga on).  Warp-uniform: a warp takes 32
// consecutive rows a step, kOwnRows steps loaded before any is added, and
// the next step's rows load while this one's are added.
template <bool kOne>
__device__ void own_rows(const UddArgs& a, int32_t* scount, int64_t width, int64_t ga,
                         int64_t lo, int64_t hi, int32_t* dst, bool vec) {
  zero_row(scount, width, vec);
  bool bad = false;
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)kOwnRows * blockDim.x;
  int64_t base = lo + (threadIdx.x & ~31);
  OwnStep<kOne> cur, nxt;
  cur.load(a, base, hi, lane);
  __syncthreads();
  for (; base < hi; base += step) {
    if (base + step < hi) nxt.load(a, base + step, hi, lane);
#pragma unroll
    for (int u = 0; u < kOwnRows; ++u) {
      int32_t key = -1;  // no add
      if (cur.mk[u]) {
        if ((uint32_t)cur.bk[u] >= (uint32_t)a.n_buckets) {
          bad = true;
        } else {
          key = cur.bk[u] + (kOne ? 0 : (int32_t)(cur.gg[u] - ga) * a.n_buckets);
        }
      }
      // the warp's 32 rows are consecutive: the first lane of each run of
      // equal ids adds the run's length
      const int32_t prev = __shfl_up_sync(kFull, key, 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || key != prev);
      if (key >= 0 && ((heads >> lane) & 1)) {
        const unsigned later = heads & (0xfffffffeu << lane);
        atomicAdd(scount + key, (later ? __ffs(later) - 1 : 32) - lane);
      }
    }
    cur = nxt;
  }
  if (bad) *(volatile int32_t*)a.verdict = kAliased;
  __syncthreads();
  store_row(scount, width, dst, vec);
}

// The owners and helpers; where the run pass found the rows out of order,
// this block's share of the atomic path's fill instead.
template <bool kOne>
__global__ void __launch_bounds__(kOwnThreads, kOwnMinCtas) own_kernel(const UddArgs a) {
  extern __shared__ int4 smem4[];
  __shared__ int32_t v;
  __shared__ BlockRows br;
  __shared__ bool has;
  // the verdict and the window table read side by side, by two warps
  if (threadIdx.x == 0) v = *(volatile const int32_t*)a.verdict;
  if (threadIdx.x == 32)
    has = block_rows(blockIdx.x, a.gids, a.windows, a.n_windows, a.tile_rows, a.cap, br);
  __syncthreads();
  if (atomic_path(v)) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t t4 = a.total / 4;
    int4* c4 = (int4*)a.counts;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < t4; i += stride)
      c4[i] = make_int4(0, 0, 0, 0);
    for (int64_t i = 4 * t4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.total;
         i += stride)
      a.counts[i] = 0;
    return;
  }
  if (!has) return;
  int32_t* dst = br.owner ? a.counts + br.w * a.cap * a.n_buckets
                          : a.scratch + ((int64_t)blockIdx.x - a.n_windows) * a.stride;
  const int64_t ga = br.w * a.cap;
  const int64_t width = min64(a.cap, a.groups - ga) * a.n_buckets;
  // a window's first count lies on a 16 B boundary when cap * B is a
  // multiple of 4 (the partial rows' stride always is)
  own_rows<kOne>(a, (int32_t*)smem4, width, ga, br.lo, br.hi, dst,
                 ((a.cap * a.n_buckets) & 3) == 0);
}

// ---- the finish: the fold of the ordered path, the adds of the atomic one ----

// The atomic path's adds over whole warps: every row, or (aliased) only
// the unmasked rows whose bucket lies outside [0, B).
__device__ __forceinline__ void add_rows(const UddArgs& a, bool aliased) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // base is the row of the warp's lane 0, the same on every lane
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane); base < a.n;
       base += stride) {
    const int64_t i = base + lane;
    int32_t key = -1;  // no add
    if (i < a.n && a.mask[i]) {
      const int32_t b = a.bucket[i];
      if (!aliased || (uint32_t)b >= (uint32_t)a.n_buckets) {
        const int32_t flat = (int32_t)((uint32_t)a.gids[i] * (uint32_t)a.n_buckets + (uint32_t)b);
        if (flat >= 0 && (int64_t)flat < a.total) key = flat;
      }
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(a.counts + key, __popc(peers));
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(const UddArgs a) {
  __shared__ int4 part[kThreads];
  __shared__ int32_t v;
  if (threadIdx.x == 0) v = *(volatile const int32_t*)a.verdict;
  __syncthreads();
  if (!atomic_path(v)) {
    // the windows longer than tile_rows: the owner's row plus every
    // helper's partial (group_runs.cuh), by atomics where aliasing rows
    // are added beside it
    if (blockIdx.x < a.n_tiles) {
      if (v == 0) {
        fold_window<kThreads>(a.gids, a.windows, a.n_windows, a.tile_rows, a.cap, a.groups,
                              a.n_buckets, a.scratch, a.stride, a.counts, part, FoldAdd());
      } else {
        fold_window<kThreads>(a.gids, a.windows, a.n_windows, a.tile_rows, a.cap, a.groups,
                              a.n_buckets, a.scratch, a.stride, a.counts, part,
                              FoldAddAtomic());
      }
    }
    if (v == 0) return;
  }
  add_rows(a, v == kAliased);
}

GT_EXPORT int gt_segment_udd(const UddArgs* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->ordered) {
    static bool allowed[64] = {false}, allowed_one[64] = {false};
    allow_smem(own_kernel<false>, allowed, kMaxOrderedB * 4);
    allow_smem(own_kernel<true>, allowed_one, kMaxOrderedB * 4);
    // the verdict word and the window table are one span (ops/sketch.py
    // `_run_buffers`): one memset clears both
    cudaMemsetAsync(a->verdict, 0, (char*)(a->windows + 2 * a->n_windows) - (char*)a->verdict, s);
    if (a->n > 0) {
      run_kernel<<<run_pass_grid(a->n), kRunThreads, 0, s>>>(*a);
    }
    const int smem = (int)(a->cap * a->n_buckets * 4);
    const unsigned blocks = (unsigned)(a->n_windows + a->n_tiles);
    if (a->cap == 1) {
      own_kernel<true><<<blocks, kOwnThreads, smem, s>>>(*a);
    } else {
      own_kernel<false><<<blocks, kOwnThreads, smem, s>>>(*a);
    }
  } else {
    cudaMemsetAsync(a->verdict, 0xff, sizeof(int32_t), s);
    cudaMemsetAsync(a->counts, 0, (size_t)a->total * sizeof(int32_t), s);
  }
  const int64_t add_blocks = run_grid(a->n, kThreads);
  const int64_t blocks = a->n_tiles > add_blocks ? a->n_tiles : add_blocks;
  finish_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
