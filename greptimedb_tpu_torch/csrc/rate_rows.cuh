// Row access and the row prologue shared by K9 (strip_counter_resets.cu)
// and K10 (range_windows.cu).
//
// A source's rows are sorted by (series, ts) and stored as chunk lists of
// one length (the last may be shorter), addressed through device tables of
// chunk pointers (ops/rate.py::_row_planes), so the 2^24-row super-tile
// chunks are read in place.  The prologue is the one of the reference's
// `_region_stats` (greptimedb_tpu/query/promql/tile_exec.py:122-158): a
// row is fetched when it is valid, its ts (native unit) lies in [lo, hi),
// its tag codes are >= 0 and its matcher masks hold; its series id is the
// mixed radix of its codes (or the legacy scan's id plane).
#pragma once

#include <math.h>

#include "common.cuh"

struct RowPlanes {
  int64_t n;                     // rows over all chunks
  int64_t chunk_rows;            // rows per chunk (every chunk but the last)
  int64_t chunk_shift;           // log2(chunk_rows) when a power of two, else -1
  const int64_t* const* ts;      // [chunks] native unit
  const double* const* vals;     // [chunks]
  const uint8_t* const* nulls;   // [chunks] present masks, or nullptr
  const uint8_t* const* valid;   // [chunks], or nullptr (every row valid)
  const int32_t* const* sid;     // [chunks] series ids, or nullptr
  const int32_t* const* codes;   // [n_tags * chunks], tag-major
  const int64_t* radices;        // [n_tags]
  const uint8_t* const* masks;   // [n_tags]; nullptr = no matcher on the tag
  const int64_t* mask_len;       // [n_tags] padded cardinality of each mask
  int64_t lo, hi;                // fetch bound [lo, hi), native unit
  int64_t unit_ns, offset;       // native -> ms, then the offset modifier
  int32_t n_tags, has_range;
};

struct SeriesLayout {
  uint8_t* in_fetch;  // [n]
  int64_t* first;     // [S] first fetched row, INT64_MAX when none
  int64_t* last;      // [S] last fetched row, -1 when none
  uint8_t* presence;  // [S]
  int64_t num_series;
};

struct LayoutArgs {
  RowPlanes rows;
  SeriesLayout out;
};

constexpr int64_t kInt64Max = 0x7fffffffffffffffLL;

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Chunk and offset of global row r (a shift and a mask for the 2^24-row
// super-tile chunks and for a single chunk; a division otherwise).
__device__ __forceinline__ void row_at(const RowPlanes& p, int64_t r, int64_t& c, int64_t& o) {
  if (p.chunk_shift >= 0) {
    c = r >> p.chunk_shift;
    o = r & ((1LL << p.chunk_shift) - 1);
  } else {
    c = r / p.chunk_rows;
    o = r - c * p.chunk_rows;
  }
}

// The legacy fetch's native -> ms conversion (floor division), then the
// offset; a millisecond column skips the multiply.
__device__ __forceinline__ int64_t ts_ms_of(const RowPlanes& p, int64_t r) {
  int64_t c, o;
  row_at(p, r, c, o);
  const int64_t t = p.ts[c][o];
  if (p.unit_ns == 1000000) return t + p.offset;
  return floor_div(t * p.unit_ns, 1000000) + p.offset;
}

// A row's value; an absent (NULL) value reads as NaN.
__device__ __forceinline__ double value_of(const RowPlanes& p, int64_t r) {
  int64_t c, o;
  row_at(p, r, c, o);
  if (p.nulls != nullptr && p.nulls[c][o] == 0) return __longlong_as_double(0x7ff8000000000000LL);
  return p.vals[c][o];
}

// Row r's series id when it is fetched, else -1.
__device__ __forceinline__ int64_t fetched_series(const RowPlanes& p, int64_t r, int64_t chunks,
                                                  int64_t num_series) {
  int64_t c, o;
  row_at(p, r, c, o);
  bool ok = p.valid == nullptr || p.valid[c][o] != 0;
  if (p.has_range) {
    const int64_t t = p.ts[c][o];
    ok = ok && t >= p.lo && t < p.hi;
  }
  int64_t sid = 0;
  if (p.sid != nullptr) {
    sid = p.sid[c][o];
  } else {
    int64_t mult = 1;
    for (int t = p.n_tags - 1; t >= 0; --t) {
      const int64_t code = p.codes[(int64_t)t * chunks + c][o];
      ok = ok && code >= 0;
      const uint8_t* m = p.masks[t];
      if (m != nullptr) ok = ok && code < p.mask_len[t] && m[code < 0 ? 0 : code] != 0;
      sid += code * mult;
      mult *= p.radices[t];
    }
  }
  return ok && sid >= 0 && sid < num_series ? sid : -1;
}

constexpr int kLayoutGroups = 4;   // groups of 32 rows a warp loads at once
constexpr int kLayoutSpan = 1024;  // rows a warp takes in a row

// Bound on the H100: bytes — valid, ts and the code planes read once per
// row, in_fetch written.  Each warp takes kLayoutSpan consecutive rows,
// kLayoutGroups x 32 in flight.  A series' first/last fetched row is a
// 64-bit integer atomicMin/atomicMax (the result does not depend on
// order), issued only where the series changes between one fetched row
// and the next fetched row of the warp's span (rows that are not fetched
// between them do not count), and at the span's ends: two atomics per
// series and span, not per warp of 32 rows.
__global__ void __launch_bounds__(256) series_layout_kernel(const LayoutArgs a) {
  const RowPlanes& p = a.rows;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t chunks = (p.n + p.chunk_rows - 1) / p.chunk_rows;
  // warp-uniform loops: every lane takes part in the votes and shuffles
  for (int64_t c0 = warp * kLayoutSpan; c0 < p.n; c0 += warps * kLayoutSpan) {
    const int64_t c1 = c0 + kLayoutSpan < p.n ? c0 + kLayoutSpan : p.n;
    int64_t cs = -1, cr = -1;  // the series and row of the span's last fetched row so far
    for (int64_t r0 = c0; r0 < c1; r0 += 32 * kLayoutGroups) {
      int64_t sg[kLayoutGroups];
#pragma unroll
      for (int u = 0; u < kLayoutGroups; ++u) {
        const int64_t r = r0 + 32 * u + lane;
        sg[u] = r < c1 ? fetched_series(p, r, chunks, a.out.num_series) : -1;
      }
      // stored after every load of the groups (a store between them would
      // keep the loads of the next group waiting)
#pragma unroll
      for (int u = 0; u < kLayoutGroups; ++u) {
        const int64_t r = r0 + 32 * u + lane;
        if (r < c1) a.out.in_fetch[r] = sg[u] >= 0 ? 1 : 0;
      }
#pragma unroll
      for (int u = 0; u < kLayoutGroups; ++u) {
        const int64_t r = r0 + 32 * u + lane;
        const int64_t s = sg[u];
        const unsigned fm = __ballot_sync(0xffffffffu, s >= 0);
        if (fm == 0) continue;
        const unsigned before = fm & ((1u << lane) - 1);
        const unsigned after = lane == 31 ? 0u : fm & (0xffffffffu << (lane + 1));
        const int64_t prev_s = __shfl_sync(0xffffffffu, s, before ? 31 - __clz(before) : 0);
        const int64_t next_s = __shfl_sync(0xffffffffu, s, after ? __ffs(after) - 1 : 0);
        if (s >= 0) {
          const int64_t ps = before ? prev_s : cs;
          if (ps != s) {
            atomicMin((long long*)(a.out.first + s), (long long)r);
            if (!before && cs >= 0) {  // the carried row ended its run
              atomicMax((long long*)(a.out.last + cs), (long long)cr);
              a.out.presence[cs] = 1;
            }
          }
          if (after && next_s != s) {
            atomicMax((long long*)(a.out.last + s), (long long)r);
            a.out.presence[s] = 1;
          }
        }
        const int top = 31 - __clz(fm);
        cs = __shfl_sync(0xffffffffu, s, top);
        cr = __shfl_sync(0xffffffffu, r, top);
      }
    }
    if (lane == 0 && cs >= 0) {  // the span's last fetched row ends its run
      atomicMax((long long*)(a.out.last + cs), (long long)cr);
      a.out.presence[cs] = 1;
    }
  }
}

// The layout's identities: no fetched row (first INT64_MAX, last -1,
// presence 0) in every series, before the prologue's atomics.
__global__ void __launch_bounds__(256) layout_init_kernel(const SeriesLayout out) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= out.num_series) return;
  out.first[s] = kInt64Max;
  out.last[s] = -1;
  out.presence[s] = 0;
}

// The identities, then the prologue, on `stream`; each launch adds one to
// *kernels where given.
static inline int launch_series_layout(const LayoutArgs* args, cudaStream_t stream,
                                       int32_t* kernels = nullptr) {
  const int64_t S = args->out.num_series;
  if (S > 0) {
    layout_init_kernel<<<(unsigned)((S + 255) / 256), 256, 0, stream>>>(args->out);
    if (kernels) ++*kernels;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (args->rows.n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (args->rows.n + 8 * kLayoutSpan - 1) / (8 * kLayoutSpan);  // 8 warps a block
  series_layout_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, stream>>>(*args);
  if (kernels) ++*kernels;
  return (int)cudaGetLastError();
}
