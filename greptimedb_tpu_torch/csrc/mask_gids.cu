// K1 mask_gids: the predicate mask and the group ids in one elementwise pass.
//
// Replaces greptimedb_tpu/parallel/executor.py:207 `_apply_filters`
// (ops/filter.py:32 `compile_predicate`) fused with ops/aggregate.py:57
// `raw_group_ids`, :98 `time_bucket` and the padding rule of
// parallel/executor.py:314-321.  XLA fused those into one pass over HBM;
// this kernel does the same by hand.
//
// Bound on the H100: bytes.  Per row it reads `valid`, each filter plane,
// each null gate, each tag code plane and the ts plane once, and writes a
// 4-byte gid and a 1-byte mask (double-groupby-1: 1 + 8 + 4 read, 5
// written: 302 MB at 2^24 rows, 0.090 ms at 3.35 TB/s).  There is no reuse
// to exploit; literals (IN-lists included) are runtime data in a small
// device buffer, read through the read-only cache.  The bucket origin and
// interval lead that buffer (lits[0], lits[1]) instead of riding the
// argument struct by value: a CUDA graph bakes a launch's arguments in, so
// a captured dashboard tick slides its window by rewriting the buffer,
// with no recapture.
//
// Design.  A thread holds kQuads quad(s) of 4 consecutive rows,
// the quads of a warp side by side, so each plane is read in 16 B vectors
// (4 B for the byte planes) and the ids and mask are stored so.  The loads
// of `valid`, the ts plane and the first kPreTags tags' codes all issue
// before any compare; a filter over the ts plane itself compares the ts
// already in registers, and each literal is loaded once for the rows
// held.  The time bucket divides by the interval without a 64-bit
// division (nvcc lowers one to a subroutine call): each CTA derives a
// magic reciprocal of |interval| once from lits[1] (Granlund-Montgomery,
// "Division by invariant integers using multiplication", fig. 4.1: exact
// for every 64-bit numerator), and each row takes a multiply-high, an add
// and two shifts, the floor's sign folded into the numerator and a
// complement.  Rows before the first quad whose operands are all aligned
// (`head`: a chunk view at an odd row) and past the last whole quad take
// the same arithmetic one row a thread; where no such head exists (`vec`
// 0) every row does.  tools/mask_variants.py times the constants below
// (two quads a thread took 128 registers and lost time; 8 CTAs an SM beat
// 16 and 64; streaming or L2-only loads gained nothing over __ldg).
//
// Semantics kept from the reference:
//  * time_bucket is a FLOOR division, (ts - origin) // interval (the
//    difference wrapping in int64), then a wrapping cast to int32 (XLA's
//    astype), for every non-zero interval, negative ones included.
//  * comparisons against NaN are false (`!=` true), as IEEE and XLA say.
//  * int64 literals are compared in int64, never narrowed.
//  * codes outside [0, card) (e.g. -1 for a literal the dictionary never
//    saw) are clipped into range and flagged out of the mask, never
//    redirected, so the id order of a sorted scan stays intact.
//  * ids in two widths (the kernel is templated on the id type):
//    int32 for the dense strategy, composed with int32 wrapping, padding
//    rows set to pad_gid; int64 for the hash strategy (ops/aggregate.py:55
//    `raw_group_ids(dtype=int64)`, parallel/executor.py:299-312): every
//    component widened to int64 first (the bucket after its int32 cast),
//    composed with int64 wrapping, and no padding rule.  The planner keeps
//    the padded int64 space under 2^62, so nothing wraps there.
#include <type_traits>

#include "common.cuh"

constexpr int kMaxFilters = 16;
constexpr int kMaxGates = 16;
constexpr int kMaxTags = 8;

enum PlaneKind : int32_t { kI32 = 0, kI64 = 1, kF64 = 2, kU8 = 3 };
enum FilterOp : int32_t { kEq = 0, kNe, kLt, kLe, kGt, kGe, kIn, kNotIn };

// Mirrored field for field by MaskGidsArgs in ops/filter.py (ctypes).
struct MaskGidsArgs {
  int64_t n;
  const uint8_t* valid;
  const int64_t* ts;        // nullptr: no time bucket component
  const int64_t* lits;      // [origin, interval, literal bits...] (f64 literals
                            // as their bit pattern; offsets count from 0)
  void* gids_out;           // int32 [n], or int64 [n] with id64
  uint8_t* mask_out;
  const void* fplane[kMaxFilters];
  const uint8_t* gate[kMaxGates];
  const int32_t* tag[kMaxTags];
  int32_t fkind[kMaxFilters];
  int32_t fop[kMaxFilters];
  int32_t flit_off[kMaxFilters];
  int32_t flit_cnt[kMaxFilters];
  int32_t card[kMaxTags];
  int32_t n_filters;
  int32_t n_gates;
  int32_t n_tags;
  int32_t n_buckets;
  int32_t pad_gid;          // id of padding rows (internal groups - 1)
  int32_t id64;             // 1: int64 ids, no padding rule
  int32_t head;             // rows before the first quad whose operands
                            // are all aligned (< 4)
  int32_t vec;              // 0: no such quad, every row one a thread
};

// A literal of the filter's compare type from its int64 bits.
template <typename T>
__device__ __forceinline__ T literal(const int64_t* lits, int at) {
  const int64_t bits = __ldg(lits + at);
  if constexpr (std::is_floating_point<T>::value) return __longlong_as_double(bits);
  else return (T)bits;
}

// m[e] &= (x[e] op literal(s)), each literal loaded once for the rows held.
// NOT IN is the complement of IN: x != y is !(x == y) for every x, NaN
// included, so a NaN is NOT IN every list (comparisons against NaN are
// false, `!=` true).
template <typename T, int N>
__device__ __forceinline__ void apply_filter(const T (&x)[N], const int64_t* lits, int op,
                                             int off, int cnt, bool (&m)[N]) {
  if (op == kIn || op == kNotIn) {
    bool any[N];
#pragma unroll
    for (int e = 0; e < N; ++e) any[e] = false;
    for (int j = 0; j < cnt; ++j) {
      const T y = literal<T>(lits, off + j);
#pragma unroll
      for (int e = 0; e < N; ++e) any[e] |= x[e] == y;
    }
    const bool want = op == kIn;
#pragma unroll
    for (int e = 0; e < N; ++e) m[e] &= any[e] == want;
    return;
  }
  const T y = literal<T>(lits, off);
  switch (op) {
#define GT_ROWS(expr) _Pragma("unroll") for (int e = 0; e < N; ++e) m[e] &= (expr); break
    case kEq: GT_ROWS(x[e] == y);
    case kNe: GT_ROWS(x[e] != y);
    case kLt: GT_ROWS(x[e] < y);
    case kLe: GT_ROWS(x[e] <= y);
    case kGt: GT_ROWS(x[e] > y);
    default: GT_ROWS(x[e] >= y);  // kGe
#undef GT_ROWS
  }
}

// Floor division by the interval, (d // v) for every int64 d and v != 0,
// as a multiply: d's sign and v's turn it into an unsigned quotient of a
// numerator < 2^64 by u = |v| and, where the true quotient is negative, a
// complement (floor(-x / u) = ~((x - 1) / u) for x > 0).
struct FloorDiv {
  uint64_t m;      // the magic multiplier of u
  uint32_t sh1;    // min(l, 1), l = ceil(log2 u)
  uint32_t sh2;    // max(l - 1, 0)
  int32_t pos;     // v > 0
};

__device__ __forceinline__ FloorDiv floor_div_of(int64_t v) {
  FloorDiv f;
  f.pos = v > 0;
  const uint64_t u = v < 0 ? 0ull - (uint64_t)v : (uint64_t)v;
  if (u <= 1) {  // u = 1 (and the refused u = 0): the numerator itself
    f.m = 0;
    f.sh1 = f.sh2 = 0;
    return f;
  }
  const int l = 64 - __clzll(u - 1);  // 2^(l-1) < u <= 2^l, l <= 63
  // m = floor(2^64 (2^l - u) / u) + 1 by long division: r < u <= 2^63,
  // so 2r never overflows
  uint64_t r = (1ull << l) - u, q = 0;
  for (int i = 0; i < 64; ++i) {
    r <<= 1;
    q <<= 1;
    if (r >= u) {
      r -= u;
      q |= 1;
    }
  }
  f.m = q + 1;
  f.sh1 = 1;
  f.sh2 = (uint32_t)(l - 1);
  return f;
}

__device__ __forceinline__ int64_t floor_div(const FloorDiv& f, int64_t d) {
  bool flip;
  uint64_t num;
  if (f.pos) {
    flip = d < 0;
    num = flip ? ~(uint64_t)d : (uint64_t)d;
  } else {
    flip = d > 0;
    num = flip ? (uint64_t)d - 1 : 0ull - (uint64_t)d;
  }
  const uint64_t t = __umul64hi(f.m, num);
  const uint64_t q = (t + ((num - t) >> f.sh1)) >> f.sh2;
  return (int64_t)(flip ? ~q : q);
}

constexpr int kThreads = 256;
constexpr int kQuads = 1;       // quads of 4 rows a thread holds at once
constexpr int kPreTags = 4;     // tags whose codes load with valid and ts
constexpr int kCtasPerSm = 8;   // the grid's cap: it strides past this

// The rows a thread holds: V, kQuads quads at rows head + 4 * quad[j]
// (live[j] says which exist); else one row.
template <bool V>
struct Rows {
  static constexpr int N = V ? 4 * kQuads : 1;
  static constexpr int Q = V ? kQuads : 1;
  int64_t at[Q];  // the first row of each quad, or the row
  bool live[Q];
};

template <typename T>
__device__ __forceinline__ void load_quad(const T* p, int64_t r, T* x) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t w = __ldg((const unsigned int*)(p + r));
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = (T)((w >> (8 * e)) & 255u);
  } else if constexpr (sizeof(T) == 4) {
    const int4 w = __ldg((const int4*)(p + r));
    x[0] = (T)w.x;
    x[1] = (T)w.y;
    x[2] = (T)w.z;
    x[3] = (T)w.w;
  } else {
    const longlong2 w0 = __ldg((const longlong2*)(p + r));
    const longlong2 w1 = __ldg((const longlong2*)(p + r + 2));
    if constexpr (std::is_same<T, double>::value) {  // the bits, not the values
      x[0] = __longlong_as_double(w0.x);
      x[1] = __longlong_as_double(w0.y);
      x[2] = __longlong_as_double(w1.x);
      x[3] = __longlong_as_double(w1.y);
    } else {
      x[0] = (T)w0.x;
      x[1] = (T)w0.y;
      x[2] = (T)w1.x;
      x[3] = (T)w1.y;
    }
  }
}

// The values of plane p at the rows held, as T (0 where a quad is absent).
template <typename T, bool V>
__device__ __forceinline__ void load_rows(const T* p, const Rows<V>& s, T (&x)[Rows<V>::N]) {
  if constexpr (V) {
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      if (s.live[j]) {
        load_quad(p, s.at[j], x + 4 * j);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * j + e] = (T)0;
      }
    }
  } else {
    x[0] = p[s.at[0]];
  }
}

// A filter plane's values at the rows held, compared in the filter's type.
template <typename T, typename P, bool V>
__device__ __forceinline__ void filter_rows(const void* plane, const Rows<V>& s,
                                            const int64_t* lits, int op, int off, int cnt,
                                            bool (&m)[Rows<V>::N]) {
  P raw[Rows<V>::N];
  load_rows<P, V>((const P*)plane, s, raw);
  T x[Rows<V>::N];
#pragma unroll
  for (int e = 0; e < Rows<V>::N; ++e) x[e] = (T)raw[e];
  apply_filter<T, Rows<V>::N>(x, lits, op, off, cnt, m);
}

// The codes of tag k folded into the rows' ids (mixed radix, clipped into
// range, out-of-range rows flagged).
template <typename IdT, typename UT, int N>
__device__ __forceinline__ void add_tag(const int32_t (&c)[N], int32_t card32, UT (&gid)[N],
                                        bool (&in_range)[N]) {
  const IdT card = (IdT)card32;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const IdT x = (IdT)c[e];
    in_range[e] = in_range[e] && x >= 0 && x < card;
    const IdT cc = x < 0 ? 0 : (x > card - 1 ? card - 1 : x);
    gid[e] = gid[e] * (UT)card + (UT)cc;
  }
}

// IdT: int32_t or int64_t; UT its unsigned twin, in which the mixed-radix
// composition wraps as XLA's integer arithmetic does
// (`a` by value: a reference to the kernel's parameter would copy it to
// the stack)
template <typename IdT, typename UT, bool V>
__device__ __forceinline__ void mask_gids_rows(const MaskGidsArgs a, const Rows<V>& s,
                                               const FloorDiv& div, int64_t origin) {
  constexpr int N = Rows<V>::N;
  // the loads of the rows' valid bytes, timestamps and first kPreTags
  // tags' codes first
  uint8_t vb[N];
  load_rows<uint8_t, V>(a.valid, s, vb);
  int64_t ts[N];
  if (a.ts != nullptr) load_rows<int64_t, V>(a.ts, s, ts);
  int32_t pre[kPreTags][N];
#pragma unroll
  for (int k = 0; k < kPreTags; ++k) {
    if (k < a.n_tags) load_rows<int32_t, V>(a.tag[k], s, pre[k]);
  }

  bool m[N];
#pragma unroll
  for (int e = 0; e < N; ++e) m[e] = vb[e] != 0;
  for (int f = 0; f < a.n_filters; ++f) {
    const int kind = a.fkind[f], op = a.fop[f], off = a.flit_off[f], cnt = a.flit_cnt[f];
    if (kind == kI64 && a.fplane[f] == (const void*)a.ts) {
      apply_filter<int64_t, N>(ts, a.lits, op, off, cnt, m);
    } else if (kind == kF64) {
      filter_rows<double, double, V>(a.fplane[f], s, a.lits, op, off, cnt, m);
    } else if (kind == kI64) {
      filter_rows<int64_t, int64_t, V>(a.fplane[f], s, a.lits, op, off, cnt, m);
    } else if (kind == kI32) {
      filter_rows<int64_t, int32_t, V>(a.fplane[f], s, a.lits, op, off, cnt, m);
    } else {
      filter_rows<int64_t, uint8_t, V>(a.fplane[f], s, a.lits, op, off, cnt, m);
    }
  }
  for (int k = 0; k < a.n_gates; ++k) {
    uint8_t g[N];
    load_rows<uint8_t, V>(a.gate[k], s, g);
#pragma unroll
    for (int e = 0; e < N; ++e) m[e] &= g[e] != 0;
  }

  // mixed-radix group id with XLA's wrapping arithmetic in IdT
  UT gid[N];
  bool in_range[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    gid[e] = 0;
    in_range[e] = true;
  }
#pragma unroll
  for (int k = 0; k < kPreTags; ++k) {
    if (k < a.n_tags) add_tag<IdT, UT, N>(pre[k], a.card[k], gid, in_range);
  }
  for (int k = kPreTags; k < a.n_tags; ++k) {
    int32_t c[N];
    load_rows<int32_t, V>(a.tag[k], s, c);
    add_tag<IdT, UT, N>(c, a.card[k], gid, in_range);
  }
  if (a.ts != nullptr) {
    const IdT card = (IdT)a.n_buckets;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int64_t d = (int64_t)((uint64_t)ts[e] - (uint64_t)origin);
      const IdT b = (IdT)(int32_t)(uint32_t)(uint64_t)floor_div(div, d);  // astype(int32)
      in_range[e] = in_range[e] && b >= 0 && b < card;
      const IdT bb = b < 0 ? 0 : (b > card - 1 ? card - 1 : b);
      gid[e] = gid[e] * (UT)card + (UT)bb;
    }
  }

  IdT out[N];
  uint8_t mk[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (sizeof(IdT) == 8) {
      out[e] = (IdT)gid[e];  // the hash ids have no padding rule
    } else {
      out[e] = vb[e] != 0 ? (IdT)gid[e] : (IdT)a.pad_gid;
    }
    mk[e] = (m[e] && in_range[e]) ? 1 : 0;
  }
  IdT* gids = (IdT*)a.gids_out;
  if constexpr (V) {
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      if (!s.live[j]) continue;
      const int64_t r = s.at[j];
      const IdT* o = out + 4 * j;
      if constexpr (sizeof(IdT) == 4) {
        *(int4*)(gids + r) = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
      } else {
        *(longlong2*)(gids + r) = make_longlong2((long long)o[0], (long long)o[1]);
        *(longlong2*)(gids + r + 2) = make_longlong2((long long)o[2], (long long)o[3]);
      }
      const uint8_t* b = mk + 4 * j;
      *(uint32_t*)(a.mask_out + r) =
          (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
    }
  } else {
    gids[s.at[0]] = out[0];
    a.mask_out[s.at[0]] = mk[0];
  }
}

template <typename IdT, typename UT>
__global__ void __launch_bounds__(kThreads) mask_gids_kernel(const MaskGidsArgs a) {
  __shared__ FloorDiv s_div;
  if (a.ts != nullptr) {
    if (threadIdx.x == 0) s_div = floor_div_of(__ldg(a.lits + 1));
    __syncthreads();
  }
  const FloorDiv div = s_div;  // unread without a bucket
  const int64_t origin = a.ts != nullptr ? __ldg(a.lits) : 0;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  if (!a.vec) {
    for (int64_t i = tid; i < a.n; i += threads) {
      const Rows<false> s = {{i}, {true}};
      mask_gids_rows<IdT, UT, false>(a, s, div, origin);
    }
    return;
  }
  // the whole quads past `head`, then the rows before and after them one
  // a thread
  const int64_t head = a.head;
  const int64_t quads = (a.n - head) >> 2;
  const int64_t tail = head + 4 * quads;
  const int64_t loose = head + (a.n - tail);
  if (tid < loose) {
    const int64_t i = tid < head ? tid : tail + (tid - head);
    const Rows<false> s = {{i}, {true}};
    mask_gids_rows<IdT, UT, false>(a, s, div, origin);
  }
  const int64_t tile_quads = (int64_t)kThreads * kQuads;
  for (int64_t t0 = (int64_t)blockIdx.x * tile_quads; t0 < quads;
       t0 += (int64_t)gridDim.x * tile_quads) {
    Rows<true> s;
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int64_t q = t0 + (int64_t)j * kThreads + threadIdx.x;
      s.live[j] = q < quads;
      s.at[j] = head + 4 * q;
    }
    mask_gids_rows<IdT, UT, true>(a, s, div, origin);
  }
}

GT_EXPORT int gt_mask_gids(const MaskGidsArgs* args, void* stream) {
  const int64_t n = args->n;
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks;
  if (args->vec) {
    const int64_t quads = (n - args->head) >> 2;
    blocks = (quads + kThreads * kQuads - 1) / (kThreads * kQuads);
  } else {
    blocks = (n + kThreads - 1) / kThreads;
  }
  if (blocks > 132 * kCtasPerSm) blocks = 132 * kCtasPerSm;  // then it strides
  if (blocks < 1) blocks = 1;                 // the loose rows alone
  if (args->id64) {
    mask_gids_kernel<int64_t, uint64_t><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  } else {
    mask_gids_kernel<int32_t, uint32_t><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
