// The one stable radix sort of the port, shared by K14 (csrc/ts_argsort.cu),
// K18 (csrc/segment_sort.cu) and K19's large-k branch
// (csrc/topk_distances.cu): a one-sweep LSD radix sort for Hopper, after
// Adinets & Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs" (2022), written here.
//
// Plan.  The host picks the key width and the digits from the largest key
// (ops/radix.py `radix_plan`): u32 keys when it fits 32 bits, else u64;
// one pass up to 11 bits (G = 720: one 10-bit digit; a largest key of 0
// one 1-bit digit), past that the fewest passes of at most 11 bits, or
// up to three of at most 8 where they do (a pass costs more the more
// digits it has: K14 over 12 h of ms, 26 bits, takes three 9/9/8-bit
// passes).
//
// Launches.  One memset of the control words (the digit counts and the
// tile counters), one histogram kernel, one kernel per pass; the sort
// counts its kernels into RadixScratch::kernels for the wrapper:
//   1. onesweep_hist_kernel reads the keys once, straight from the
//      caller's inputs, and counts every pass's digits (per-block counts
//      in shared memory, a run of equal digits in neighbouring lanes adds
//      once, one global atomic per (pass, digit) per block).  It also
//      zeroes the passes' look-back words; the last block to finish turns
//      the counts into exclusive digit offsets.
//   2. onesweep_pass_kernel, once per pass: a tile of 4096 rows (512
//      threads x 8 keys in registers, each warp a contiguous run of 256
//      rows) takes its index from an atomic counter, so it only ever
//      waits on tiles that already started.  Each warp ranks its keys in
//      row order (__match_any_sync, per-warp 16-bit counters in shared
//      memory); the tile publishes its per-digit counts, then finds each
//      digit's offset by decoupled look-back over the earlier tiles'
//      words, four at a time, and publishes its prefix before it stages
//      its rows in digit order in shared memory, so that later tiles find
//      the prefix early.  Each digit's run then goes out as one
//      contiguous write.  The first pass computes its keys from the
//      caller's inputs; the last writes the caller's outputs in their
//      final types; between them the keys and row indices ping-pong
//      through two scratch buffers.
// A look-back word is 32 bits: n < 2^31, so an inclusive count fits 31
// bits beside the prefix flag, and a tile's own count is stored plus one,
// so a published word is never 0.  No atomic decides an order: the tile
// counter only hands out tile indices, and a stable pass's output is
// unique, so the sort gives the same bytes on every run.
//
// Graph-safe.  Every kernel takes a Gate (common.cuh) and returns at once
// when it is shut; the sort reads nothing on the host, allocates nothing
// (the wrapper's torch.empty scratch, sized by ops/radix.py), and resets
// its counters (memset) and look-back words (the histogram kernel) on the
// stream in every launch, so a CUDA graph replay starts clean.
//
// What bounds it on the H100 (chip_smoke.py phases 3d-3f): bytes, but the
// passes run at a fraction of the memory rate.  A pass's cost grows with
// its digit count: the look-back walks digit after digit, and each tile
// writes one run per digit, so at 1024 digits a tile's runs are a few
// rows long and its writes fill partial sectors.
#pragma once

#include "common.cuh"

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // keys per thread
constexpr int kTileRows = kThreads * kItems;
constexpr int kMaxDigitBits = 11;
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kMaxPasses = 6;  // 64 bits at 11 a pass
constexpr int kMaxDigitsPerThread = kMaxRadix / kThreads;
constexpr int kLookback = 4;  // predecessors read at once per digit
constexpr int kHistBlocks = 132 * 2;  // one wave: a shut launch costs little
// A look-back word: 0 until published; then the tile's own count plus one
// (at most kTileRows + 1), or kPrefix | the count of this tile and all
// before it (at most n < 2^31, so 31 bits hold it).
constexpr uint32_t kPrefix = 1u << 31;

// Mirrored field for field by _RadixPlan in ops/radix.py (ctypes).
struct RadixPlan {
  int32_t n_passes;
  int32_t key_bytes;  // 4 or 8
  int32_t shift[kMaxPasses];
  int32_t bits[kMaxPasses];
};

// Mirrored field for field by _RadixScratch in ops/radix.py (ctypes).
struct RadixScratch {
  void* keys[2];       // [n] keys between passes (buffer 1 from the third pass on)
  int32_t* idx[2];     // [n] their rows
  uint32_t* status;    // [n_tiles * sum of 2^bits] look-back words, pass after pass
  uint32_t* control;   // [sum of 2^bits] digit counts, 1 done counter, [n_passes] tile counters
  int32_t kernels;     // out: the kernels the sort launched
};

__device__ __forceinline__ uint32_t status_load(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void status_store(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Adds one published word to a look-back sum; true at a prefix.
__device__ __forceinline__ bool status_add(uint32_t v, uint32_t& run) {
  if (v & kPrefix) {
    run += v & ~kPrefix;
    return true;
  }
  run += v - 1u;
  return false;
}

// Rows of a tile that one thread holds: base + k * 32 for k < kItems, base =
// tile * kTileRows + warp * 32 * kItems + lane.  A source fills key[k] and
// row[k] (the input row) for those rows below n; a sink writes one sorted
// position.  The passes between the first and the last read and write
// these two:
template <typename KeyT>
struct BufSrc {
  const KeyT* keys;
  const int32_t* idx;
  __device__ __forceinline__ void load_items(int64_t base, int64_t n, KeyT (&key)[kItems],
                                             int32_t (&row)[kItems]) const {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)k * 32;
      if (i < n) {
        key[k] = keys[i];
        row[k] = idx[i];
      }
    }
  }
};

template <typename KeyT>
struct BufDst {
  KeyT* keys;
  int32_t* idx;
  __device__ __forceinline__ void put(int64_t pos, KeyT key, int32_t row) const {
    keys[pos] = key;
    idx[pos] = row;
  }
};

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of a[0, len) in shared memory (len <= kMaxRadix) by the
// whole CTA: each thread owns ceil(len / kThreads) consecutive entries.
// Starts and ends with a barrier.
__device__ void cta_exclusive_scan(uint32_t* a, int len, uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int b = threadIdx.x * per;
  __syncthreads();
  uint32_t v[kMaxDigitsPerThread];
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kMaxDigitsPerThread; ++j) {
    v[j] = j < per && b + j < len ? a[b + j] : 0u;
    s += v[j];
  }
  const uint32_t incl = warp_inclusive_scan(s, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t run = incl - s;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
#pragma unroll
  for (int j = 0; j < kMaxDigitsPerThread; ++j) {
    if (j < per && b + j < len) {
      a[b + j] = run;
      run += v[j];
    }
  }
  __syncthreads();
}

template <typename KeyT>
__device__ __forceinline__ int digit_of(KeyT key, int shift, uint32_t mask) {
  return (int)((key >> shift) & mask);
}

// Every pass's digit counts in one read of the keys; zeroes the status
// words; the last block turns the counts into exclusive offsets.
template <typename KeyT, typename In>
__global__ void __launch_bounds__(kThreads) onesweep_hist_kernel(const In in, int64_t n,
                                                                 const RadixPlan plan,
                                                                 uint32_t* status, int64_t status_words,
                                                                 uint32_t* control, const Gate g) {
  if (gate_shut(g)) return;
  extern __shared__ uint32_t h[];  // [sum of 2^bits]
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ bool last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_bins = 0;
  for (int p = 0; p < plan.n_passes; ++p) n_bins += 1 << plan.bits[p];
  for (int i = threadIdx.x; i < n_bins; i += kThreads) h[i] = 0;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < status_words;
       i += (int64_t)gridDim.x * kThreads)
    status[i] = 0;
  __syncthreads();
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * kTileRows + warp * 32 * kItems + lane;
    KeyT key[kItems];
    int32_t row[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) key[k] = 0;
    in.load_items(base, n, key, row);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool live = base + (int64_t)k * 32 < n;
      int off = 0;
      for (int p = 0; p < plan.n_passes; ++p) {
        const int digit = live ? digit_of(key[k], plan.shift[p], (1u << plan.bits[p]) - 1u) : -1;
        const int prev = __shfl_up_sync(0xffffffffu, digit, 1);
        const bool head = lane == 0 || prev != digit;
        const unsigned heads = __ballot_sync(0xffffffffu, head);
        if (head && digit >= 0) {
          const unsigned later = heads & ~((2u << lane) - 1u);
          const int end = later ? __ffs(later) - 1 : 32;
          atomicAdd(&h[off + digit], (uint32_t)(end - lane));
        }
        off += 1 << plan.bits[p];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += kThreads)
    if (h[i]) atomicAdd(&control[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(&control[n_bins], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = threadIdx.x; i < n_bins; i += kThreads) h[i] = __ldcg(&control[i]);
  int off = 0;
  for (int p = 0; p < plan.n_passes; ++p) {
    cta_exclusive_scan(h + off, 1 << plan.bits[p], warp_tot);
    off += 1 << plan.bits[p];
  }
  for (int i = threadIdx.x; i < n_bins; i += kThreads) control[i] = h[i];
}

// Dynamic shared memory of a pass: the staged tile (keys, rows), per digit
// the tile's count (then its output offset less its staged start) and
// staged start, per warp and digit a 16-bit counter.
template <typename KeyT>
constexpr int pass_smem(int radix) {
  return kTileRows * (int)(sizeof(KeyT) + sizeof(int32_t)) + radix * (4 + 4 + 2 * kWarps);
}

// One stable pass over digit (shift, bits).
template <typename KeyT, typename In, typename Out>
__global__ void __launch_bounds__(kThreads) onesweep_pass_kernel(
    const In in, const Out out, int64_t n, int shift, int bits, uint32_t* status,
    const uint32_t* digit_base, uint32_t* tile_counter, const Gate g) {
  if (gate_shut(g)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t tile_s;
  const int radix = 1 << bits;
  const uint32_t dmask = (uint32_t)radix - 1u;
  KeyT* skey = (KeyT*)smem;                            // [kTileRows]
  int32_t* srow = (int32_t*)(skey + kTileRows);        // [kTileRows]
  int32_t* delta = srow + kTileRows;                   // [radix]
  uint32_t* lexcl = (uint32_t*)(delta + radix);        // [radix]
  uint16_t* whist = (uint16_t*)(lexcl + radix);        // [kWarps][radix]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;

  // a capped grid: each CTA takes tiles from the counter until none is left
  for (;;) {
    if (tid == 0) tile_s = atomicAdd(tile_counter, 1u);
    for (int i = tid; i < kWarps * radix / 2; i += kThreads) ((uint32_t*)whist)[i] = 0u;
    __syncthreads();
    const int64_t tile = tile_s;
    if (tile >= n_tiles) return;
    const int64_t t0 = tile * kTileRows;
    const int rows = (int)(n - t0 < kTileRows ? n - t0 : kTileRows);
    const int64_t base = t0 + warp * 32 * kItems + lane;
    KeyT key[kItems];
    int32_t row[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      key[k] = 0;
      row[k] = 0;
    }
    in.load_items(base, n, key, row);

    // 1. Rank within the warp, in row order: item k of lane l is row
    // base + 32 k, so (k, lane) order is row order.
    uint32_t rank[kItems];
    const unsigned lt = (1u << lane) - 1u;
    uint16_t* wh = whist + warp * radix;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool live = base + (int64_t)k * 32 < n;
      const int d = live ? digit_of(key[k], shift, dmask) : radix;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const uint32_t c = live ? (uint32_t)wh[d] : 0u;
      __syncwarp();
      if (live && (peers & lt) == 0u) wh[d] = (uint16_t)(c + __popc(peers));
      __syncwarp();
      rank[k] = c + __popc(peers & lt);
    }
    __syncthreads();

    // 2. Per digit: the warps' counts made exclusive, the tile's count
    // published (tile 0's is already a prefix).
    for (int d = tid; d < radix; d += kThreads) {
      uint32_t run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = whist[w * radix + d];
        whist[w * radix + d] = (uint16_t)run;
        run += c;
      }
      lexcl[d] = run;
      status_store(status + tile * radix + d, tile == 0 ? kPrefix | run : run + 1u);
    }

    // 3. Decoupled look-back, digit after digit of this thread: the counts
    // of the tiles before this one back to the nearest prefix, kLookback
    // words read at once; the prefix is published at once, before this
    // tile's own staging, so that later tiles find it early.
#pragma unroll
    for (int j = 0; j < kMaxDigitsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d >= radix) break;
      uint32_t run = 0;
      if (tile > 0) {
        bool done = false;
        for (int64_t j0 = tile - 1; !done; j0 -= kLookback) {
          uint32_t s[kLookback];
#pragma unroll
          for (int w = 0; w < kLookback; ++w)
            s[w] = j0 - w >= 0 ? status_load(status + (j0 - w) * radix + d) : 0u;
#pragma unroll
          for (int w = 0; w < kLookback; ++w) {
            if (!done && j0 - w >= 0) {
              uint32_t v = s[w];
              while (v == 0u) v = status_load(status + (j0 - w) * radix + d);
              done = status_add(v, run);
            }
          }
        }
        status_store(status + tile * radix + d, kPrefix | (run + lexcl[d]));
      }
      delta[d] = (int32_t)(digit_base[d] + run);
    }
    cta_exclusive_scan(lexcl, radix, warp_tot);

    // 4. Stage the tile in digit order; each digit's output offset less its
    // staged start.
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + (int64_t)k * 32 < n) {
        const int d = digit_of(key[k], shift, dmask);
        const int slot = (int)(lexcl[d] + whist[warp * radix + d] + rank[k]);
        skey[slot] = key[k];
        srow[slot] = row[k];
      }
    }
    for (int d = tid; d < radix; d += kThreads) delta[d] -= (int32_t)lexcl[d];
    __syncthreads();

    // 5. Each digit's run out as one contiguous write.
    for (int s = tid; s < rows; s += kThreads) {
      const KeyT k = skey[s];
      out.put((int64_t)delta[digit_of(k, shift, dmask)] + s, k, srow[s]);
    }
    __syncthreads();  // the tile is out of shared memory before the next
  }
}

template <typename KeyT, typename In, typename Out>
static void launch_pass(const In& in, const Out& out, int64_t n, int64_t n_tiles, int shift,
                        int bits, uint32_t* status, const uint32_t* digit_base, uint32_t* counter,
                        const Gate g, cudaStream_t s) {
  // the widest digit's shared memory is past the default 48 KB: allowed
  // once per device, at the first launch (the first call of a sort runs
  // outside any graph capture)
  static bool allowed[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    cudaFuncSetAttribute(onesweep_pass_kernel<KeyT, In, Out>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, pass_smem<KeyT>(kMaxRadix));
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  const int smem = pass_smem<KeyT>(1 << bits);
  // a capped grid, as many CTAs as the card holds at once: each takes
  // tiles from the counter (a CTA only waits on tiles already taken, so any
  // grid makes progress), and a launch whose gate is shut costs one wave of
  // empty CTAs, not one per tile
  static int resident[kMaxDigitBits + 1];
  if (resident[bits] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onesweep_pass_kernel<KeyT, In, Out>,
                                                  kThreads, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[bits] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const int64_t grid = n_tiles < resident[bits] ? n_tiles : resident[bits];
  onesweep_pass_kernel<KeyT, In, Out><<<(unsigned)grid, kThreads, smem, s>>>(
      in, out, n, shift, bits, status, digit_base, counter, g);
}

// The sort of n keys read through `src`, written through `dst`, by `plan`
// (at least one pass) with the scratch `r`, whose `kernels` it sets to the
// kernels it launched.  Returns the first launch error.
template <typename KeyT, typename Src, typename Dst>
static cudaError_t onesweep_sort(const Src& src, const Dst& dst, int64_t n, const RadixPlan& plan,
                                 RadixScratch& r, const Gate g, cudaStream_t s) {
  r.kernels = 0;
  if (n <= 0) return cudaSuccess;
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  int n_bins = 0;
  for (int p = 0; p < plan.n_passes; ++p) n_bins += 1 << plan.bits[p];
  cudaError_t err = cudaMemsetAsync(r.control, 0, sizeof(uint32_t) * (n_bins + 1 + plan.n_passes), s);
  if (err != cudaSuccess) return err;
  const int hist_grid = (int)(n_tiles < kHistBlocks ? n_tiles : kHistBlocks);
  onesweep_hist_kernel<KeyT, Src><<<hist_grid, kThreads, sizeof(uint32_t) * n_bins, s>>>(
      src, n, plan, r.status, n_tiles * n_bins, r.control, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++r.kernels;
  uint32_t* counters = r.control + n_bins + 1;
  uint32_t* status = r.status;
  const uint32_t* digit_base = r.control;
  for (int p = 0; p < plan.n_passes; ++p) {
    const bool first = p == 0, last = p == plan.n_passes - 1;
    const int bits = plan.bits[p], shift = plan.shift[p];
    const BufSrc<KeyT> bin = {(const KeyT*)r.keys[(p + 1) & 1], r.idx[(p + 1) & 1]};
    const BufDst<KeyT> bout = {(KeyT*)r.keys[p & 1], r.idx[p & 1]};
    if (first && last) {
      launch_pass<KeyT>(src, dst, n, n_tiles, shift, bits, status, digit_base, counters + p, g, s);
    } else if (first) {
      launch_pass<KeyT>(src, bout, n, n_tiles, shift, bits, status, digit_base, counters + p, g, s);
    } else if (last) {
      launch_pass<KeyT>(bin, dst, n, n_tiles, shift, bits, status, digit_base, counters + p, g, s);
    } else {
      launch_pass<KeyT>(bin, bout, n, n_tiles, shift, bits, status, digit_base, counters + p, g, s);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++r.kernels;
    status += n_tiles << bits;
    digit_base += 1 << bits;
  }
  return cudaSuccess;
}
