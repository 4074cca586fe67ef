// K8 pack_result: finalize the merged [G] states and pack everything the
// host reads into one flat byte buffer (plus, on the dense path, the f64
// rows as a [K, G] array), in one pass over the rows.
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
// once); at the main path's sizes the kernel is a few microseconds and
// launch latency dominates, so one launch covers every row: the host
// passes a table of row descriptors, grid.y walks the rows.  The buffer
// is packed without alignment (a bit-packed row can leave an odd
// offset), so values are stored byte by byte.
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

struct PackRow {
  int32_t kind;
  int32_t reserved;
  const void* a;
  const void* b;
  int64_t out;  // byte offset in buf, or row index in accs64
};

struct PackArgs {
  const PackRow* rows;
  const int32_t* sel;  // [len] gathered group ids, or nullptr
  uint8_t* buf;
  double* accs64;      // [n64, len] or nullptr
  int64_t len;         // elements per row (cap, or G)
  int64_t num_groups;  // G (verdict rows scan all groups)
  int32_t n_rows;
  int32_t reserved;
};

__device__ __forceinline__ void store4(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

__device__ __forceinline__ double avg_of(const PackRow& r, int64_t g) {
  const int32_t c = ((const int32_t*)r.b)[g];
  return ((const double*)r.a)[g] / (double)(c > 1 ? c : 1);
}

__device__ __forceinline__ uint64_t canonical_bits(double x) {
  uint64_t b = (uint64_t)__double_as_longlong(x);
  const uint64_t sign = b & 0x8000000000000000ULL;
  if (x != x) return sign | 0x7ff8000000000000ULL;
  if ((b & 0x7ff0000000000000ULL) == 0) return sign;  // zero or subnormal
  return b;
}

__global__ void __launch_bounds__(256) pack_kernel(const PackArgs a) {
  const PackRow r = a.rows[blockIdx.y];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  switch (r.kind) {
    case kBits: {  // one thread per output byte, groups 8i .. 8i + 7
      if (i >= (a.len + 7) / 8) return;
      uint32_t byte = 0;
      for (int j = 0; j < 8; ++j) {
        const int64_t g = i * 8 + j;
        if (g < a.len && ((const int32_t*)r.a)[g] > 0) byte |= 0x80u >> j;
      }
      a.buf[r.out + i] = (uint8_t)byte;
      return;
    }
    case kScalarInt32:
      if (i == 0) store4(a.buf + r.out, (uint32_t)((const int32_t*)r.a)[0]);
      return;
    case kOverflow:
      if (i == 0) a.buf[r.out] = ((const int32_t*)r.a)[0] > 0 ? 1 : 0;
      return;
    case kVerdict: {
      if (i >= a.num_groups) return;
      const double err = ((const double*)r.a)[i];
      const double s = fabs(((const double*)r.b)[i]) * 1e-7;
      const double lim = s != s ? s : fmax(s, 1e-12);  // NaN propagates
      if (!(err <= lim)) a.buf[r.out] = 0;  // the caller preset it to 1
      return;
    }
    default:
      break;
  }
  if (i >= a.len) return;
  const int64_t g = (a.sel != nullptr && r.kind != kRawInt32) ? a.sel[i] : i;
  switch (r.kind) {
    case kInt32:
    case kRawInt32:
      store4(a.buf + r.out + i * 4, (uint32_t)((const int32_t*)r.a)[g]);
      break;
    case kAvgF32:
      store4(a.buf + r.out + i * 4, __float_as_uint(__double2float_rn(avg_of(r, g))));
      break;
    case kF64Words:
    case kAvgF64Words: {
      const double x = r.kind == kF64Words ? ((const double*)r.a)[g] : avg_of(r, g);
      const uint64_t bits = canonical_bits(x);
      store4(a.buf + r.out + i * 8, (uint32_t)(bits >> 32));
      store4(a.buf + r.out + i * 8 + 4, (uint32_t)bits);
      break;
    }
    case kF64Dense:
      a.accs64[r.out * a.len + i] = ((const double*)r.a)[g];
      break;
    case kAvgF64Dense:
      a.accs64[r.out * a.len + i] = avg_of(r, g);
      break;
    default:
      break;
  }
}

GT_EXPORT int gt_pack_result(const PackArgs* args, void* stream) {
  if (args->n_rows <= 0) return (int)cudaSuccess;
  const int64_t width = args->len > args->num_groups ? args->len : args->num_groups;
  dim3 grid((unsigned)((width + 255) / 256), (unsigned)args->n_rows);
  pack_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
