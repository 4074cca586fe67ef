// K8 pack_result: finalize the merged [G] states and pack everything the
// host reads into one flat byte buffer (plus, on the dense path, the f64
// rows as a [K, G] array), in one launch.
//
// Replaces greptimedb_tpu/parallel/tile_cache.py:3119 `_final` of the
// tile program together with greptimedb_tpu/ops/aggregate.py:1133
// `finalize` (avg = sum / max(count, 1)) and :941 `pack_f64_bits` (B10).
// The byte layout is the reference's, so its decoder carries over:
//   int rows (int32, or 1 bit per group MSB-first in uint8 when no exact
//   count is needed and G >= 2^14), f32 avg rows, then on the compact path
//   the selected group ids, the survivor count and the f64 rows as
//   [hi, lo] int32 words, then the limb verdict byte (1 iff every
//   group's error bound err <= max(|sum| * 1e-7, 1e-12)) and, for a hash
//   plan, the overflow byte (1 iff some row found no slot; the trailing
//   byte of tile_cache.py:3197-3203).
// The f64 words are a bit copy with the reference's canonicalization:
// every NaN becomes the quiet NaN with its sign kept, and subnormals
// become a zero of their sign (the reference composes the words
// arithmetically and its backend flushes subnormals).
//
// Bound on the H100: bytes (each state row read once, the buffer written
// once).  At the dense SQL shapes the work is a few microseconds and the
// call is host time, so a call is one launch and nothing else on the
// stream but the verdict byte's preset: the row descriptors go to the
// kernel by value (`PackDesc`, a __grid_constant__ parameter: no table to
// upload), and the host caches everything but the pointers per result
// layout (ops/aggregate.py `pack_layout`).  Each row gets the CTAs its own
// length needs (blk_end); a CTA finds its row by a binary search over the
// descriptor.  Word rows store whole 4- or 8-byte words where the row's
// offset is aligned and bytes only where it is not (a bit-packed row with
// G not a multiple of 32 leaves an odd offset after it); bit rows read 32
// groups a warp-wide load and pack them with __ballot_sync.  A call with
// more rows than one descriptor holds launches once per kMaxRows rows.
#include "common.cuh"

enum PackKind : int32_t {
  kInt32 = 0,        // a: int32 [G]                      -> int32
  kBits = 1,         // a: int32 [G] (> 0)                -> 1 bit/group
  kAvgF32 = 2,       // a: f64 sums, b: int32 counts      -> f32 avg
  kF64Words = 3,     // a: f64                            -> [hi, lo]
  kAvgF64Words = 4,  // a, b as kAvgF32                   -> [hi, lo]
  kRawInt32 = 5,     // a: int32 [len], not gathered      -> int32
  kF64Dense = 6,     // a: f64                            -> accs64 row
  kAvgF64Dense = 7,  // a, b as kAvgF32                   -> accs64 row
  kScalarInt32 = 8,  // a: int32 [1]                      -> int32
  kVerdict = 9,      // a: f64 errs [G], b: f64 sums [G]  -> clears the byte
  kOverflow = 10,    // a: int32 [1] unplaced rows        -> 1 byte, count > 0
};

constexpr int kMaxRows = 64;  // rows one descriptor holds (ops/aggregate.py _PACK_MAX_ROWS)
constexpr int kThreads = 256;
constexpr int kItems = 4;                          // elements a thread, word rows
constexpr int kWordsPerCta = kThreads * kItems;    // elements a CTA, word rows
constexpr int kBitsPerCta = kThreads * 32;         // groups a CTA, bit rows

struct PackRow {
  int32_t kind;
  int32_t align;  // 8, 4 or 1: the largest of them dividing `out` (buf is 16-aligned)
  int64_t n;      // elements: groups for bit and verdict rows, else the row's length
  int64_t out;    // byte offset in buf, or row index in accs64
};

struct PackDesc {
  int32_t desc_bytes;  // sizeof(PackDesc), checked against the host's
  int32_t n_rows;
  int64_t verdict_at;  // the verdict byte, preset to 1 before the launch; -1: none
  const int32_t* sel;  // [len] gathered group ids, or nullptr
  uint8_t* buf;
  double* accs64;      // [n64, G] or nullptr
  uint32_t blk_end[kMaxRows];    // CTAs of rows 0 .. r together
  PackRow rows[kMaxRows];
  const void* ptrs[2 * kMaxRows];  // row r reads ptrs[2r] (a) and ptrs[2r + 1] (b)
};

__device__ __forceinline__ void put4(uint8_t* p, uint32_t v, bool aligned) {
  if (aligned) {
    *(uint32_t*)p = v;
  } else {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
  }
}

// the two int32 words [hi, lo] of one f64, in that order
__device__ __forceinline__ void put_words(uint8_t* p, uint64_t bits, int align) {
  const uint32_t hi = (uint32_t)(bits >> 32), lo = (uint32_t)bits;
  if (align >= 8) {
    *(uint2*)p = make_uint2(hi, lo);
  } else {
    put4(p, hi, align >= 4);
    put4(p + 4, lo, align >= 4);
  }
}

__device__ __forceinline__ double avg_of(const void* a, const void* b, int64_t g) {
  const int32_t c = ((const int32_t*)b)[g];
  return ((const double*)a)[g] / (double)(c > 1 ? c : 1);
}

__device__ __forceinline__ uint64_t canonical_bits(double x) {
  uint64_t b = (uint64_t)__double_as_longlong(x);
  const uint64_t sign = b & 0x8000000000000000ULL;
  if (x != x) return sign | 0x7ff8000000000000ULL;
  if ((b & 0x7ff0000000000000ULL) == 0) return sign;  // zero or subnormal
  return b;
}

// A bit row: each warp packs 1024 groups into 32 words, lane k keeping the
// ballot of groups 32k .. 32k + 31 (group 32k + l in bit l), stored
// MSB-first: bit 7 of byte q is group 8q.
__device__ __forceinline__ void pack_bits(const PackDesc& d, const PackRow& r, const int32_t* a,
                                          int64_t cta) {
  const int lane = threadIdx.x & 31;
  const int64_t g0 = cta * kBitsPerCta + (int64_t)(threadIdx.x >> 5) * 1024;
  if (g0 >= r.n) return;  // uniform per warp
  int32_t v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int64_t g = g0 + 32 * k + lane;
    v[k] = g < r.n ? a[g] : 0;
  }
  uint32_t mine = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t bits = __ballot_sync(0xffffffffu, v[k] > 0);
    if (lane == k) mine = bits;
  }
  const uint32_t w = __byte_perm(__brev(mine), 0, 0x0123);
  const int64_t byte0 = g0 / 8 + 4 * lane;
  const int64_t nbytes = (r.n + 7) / 8;
  if (byte0 >= nbytes) return;
  uint8_t* p = d.buf + r.out + byte0;
  if (byte0 + 4 <= nbytes) {
    put4(p, w, r.align >= 4);
  } else {
    for (int q = 0; byte0 + q < nbytes; ++q) p[q] = (uint8_t)(w >> (8 * q));
  }
}

__global__ void __launch_bounds__(kThreads) pack_kernel(const __grid_constant__ PackDesc d) {
  // this CTA's row: the first whose blk_end passes blockIdx.x
  const uint32_t b = blockIdx.x;
  int lo = 0, hi = d.n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d.blk_end[mid] > b) hi = mid; else lo = mid + 1;
  }
  const PackRow& r = d.rows[lo];
  const void* pa = d.ptrs[2 * lo];
  const void* pb = d.ptrs[2 * lo + 1];
  const int64_t cta = (int64_t)b - (lo > 0 ? d.blk_end[lo - 1] : 0);
  const int t = threadIdx.x;
  switch (r.kind) {
    case kBits:
      pack_bits(d, r, (const int32_t*)pa, cta);
      return;
    case kScalarInt32:
      if (t == 0) put4(d.buf + r.out, (uint32_t)((const int32_t*)pa)[0], r.align >= 4);
      return;
    case kOverflow:
      if (t == 0) d.buf[r.out] = ((const int32_t*)pa)[0] > 0 ? 1 : 0;
      return;
    case kVerdict: {
      bool fail = false;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int64_t i = cta * kWordsPerCta + k * kThreads + t;
        if (i < r.n) {
          const double err = ((const double*)pa)[i];
          const double s = fabs(((const double*)pb)[i]) * 1e-7;
          const double lim = s != s ? s : fmax(s, 1e-12);  // NaN propagates
          fail |= !(err <= lim);
        }
      }
      // the byte was preset to 1 before the launch; a failing CTA clears it
      if (__syncthreads_or(fail) && t == 0) d.buf[r.out] = 0;
      return;
    }
    default:
      break;
  }
  const bool gathered = d.sel != nullptr && r.kind != kRawInt32;
  const int64_t i0 = cta * kWordsPerCta + t;  // element i0 + k * kThreads for k < kItems
  int64_t g[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + k * kThreads;
    g[k] = i < r.n && gathered ? (int64_t)d.sel[i] : i;
  }
  switch (r.kind) {
    case kInt32:
    case kRawInt32:
    case kAvgF32: {
      uint32_t w[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (i0 + k * kThreads >= r.n) continue;
        w[k] = r.kind == kAvgF32 ? __float_as_uint(__double2float_rn(avg_of(pa, pb, g[k])))
                                 : (uint32_t)((const int32_t*)pa)[g[k]];
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int64_t i = i0 + k * kThreads;
        if (i < r.n) put4(d.buf + r.out + 4 * i, w[k], r.align >= 4);
      }
      return;
    }
    case kF64Words:
    case kAvgF64Words:
    case kF64Dense:
    case kAvgF64Dense: {
      const bool avg = r.kind == kAvgF64Words || r.kind == kAvgF64Dense;
      const bool dense = r.kind == kF64Dense || r.kind == kAvgF64Dense;
      double x[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (i0 + k * kThreads >= r.n) continue;
        x[k] = avg ? avg_of(pa, pb, g[k]) : ((const double*)pa)[g[k]];
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int64_t i = i0 + k * kThreads;
        if (i >= r.n) continue;
        if (dense) {
          d.accs64[r.out * r.n + i] = x[k];
        } else {
          put_words(d.buf + r.out + 8 * i, canonical_bits(x[k]), r.align);
        }
      }
      return;
    }
    default:
      return;
  }
}

// CTAs a row takes: one per kBitsPerCta groups of a bit row, one for a
// scalar or overflow row, else one per kWordsPerCta elements (at least one)
GT_EXPORT int gt_pack_result(const PackDesc* desc, void* stream) {
  const PackDesc& d = *desc;
  if (d.desc_bytes != (int32_t)sizeof(PackDesc) || d.n_rows <= 0 || d.n_rows > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (d.verdict_at >= 0) {
    const cudaError_t err = cudaMemsetAsync(d.buf + d.verdict_at, 1, 1, s);
    if (err != cudaSuccess) return (int)err;
  }
  const uint32_t grid = d.blk_end[d.n_rows - 1];
  if (grid == 0) return (int)cudaSuccess;
  pack_kernel<<<grid, kThreads, 0, s>>>(d);
  return (int)cudaGetLastError();
}
