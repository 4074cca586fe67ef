// K22 fold_states: the mesh merge of partial aggregate states.
//
// Replaces greptimedb_tpu/ops/aggregate.py:1007 `psum_states` (B20) and the
// folds of greptimedb_tpu/parallel/tile_cache.py:3491-3673
// `_mesh_merge_program` (dense and keyed) and :3682
// `_mesh_hash_cross_program`, and the collective merge of
// greptimedb_tpu/parallel/executor.py:508-527 `_device_step`.
//
// Input: the partial state dicts of M = D * n_local sources (source m sits
// on slot m / n_local, n_local per slot, padded with all-invalid dummies),
// each key's fields read in place from every source (or from a copy on the
// first slot when the source lies on another card), and `order`, the real
// sources in global source order.  One launch folds every key and every
// field of a merge: the descriptor (`FoldDesc`) goes to the kernel by value
// in its parameter space (up to 32,764 bytes on sm_90), holding per key its
// rows, its fields' types and, per field, the output and each source's row
// base.  The caller splits a merge whose keys do not fit into launches of
// whole keys (ops/aggregate.py `fold_launch_plan`).  A launch past the
// descriptor's 512 real sources, or a key past its pointers alone, is
// staged: its pointers, each real source's row of inv and `order` lie in a
// table in device memory (`table`), and the descriptor keeps the rest.
// The keys' 256-row blocks are laid end to end, and each CTA of a grid the
// card holds at once takes a contiguous range of them; one thread per
// output row walks the sources in a fixed order, so the bytes are the same
// on every run and no float atomic is involved.
//
// Dense mode (one [rows] state per source, the same group space):
//   sums     left fold over `order`: acc = g[o0]; acc = acc + g[ok] (IEEE
//            adds, round to nearest, never contracted, x86's NaN rules; the
//            psum rule keeps the later NaN where two meet, as XLA's CPU
//            all-reduce does, the fold rule the earlier);
//   counts   integer add over every source (any order is exact);
//   min/max  the IEEE minimum/maximum fold over every source (jnp.minimum:
//            a NaN propagates, -0 < +0).  Its result depends only on the
//            sources' values (a min is +NaN if any source is +NaN, else
//            -NaN if any is, else the least value; a max mirrors it), so
//            one slot and N slots give the same bytes.  XLA CPU's pmin and
//            pmax across devices skip a NaN instead; K22 does not follow
//            them there (the tile encode stores a NaN value as 0, so no
//            SQL state holds one);
//   LAST     rule 0 (fold, tile mesh): left fold over `order`, the later
//            source wins a ts tie; rule 1 (psum_states, the table-fed mesh): the
//            max ts, and the collective max of the values at that ts (XLA
//            CPU's pmax: a NaN skipped), the others counting as -DBL_MAX.
// Keyed mode (hash plans, per key): each slot's states are indexed by its
// own slot table; `inv[d, u]` is the row of slot d's table that holds union
// row u's key, or -1 (built by gt_fold_invert from K17's union slot map).
// Row u starts at the scatter identity (0, 0, +DBL_MAX, -DBL_MAX) and takes
// g[m, inv[d_m, u]] in `order`, as the reference's `.at[].add/min/max`
// scatters do in global source order (the add keeping the update's NaN
// where two meet); a trailing row (rows == h + 1) takes each source's own
// trailing row.  The empty slots of a device table hold the identity (as
// every partial leaves them), so folding them into the trailing row, as
// the reference's scatter does, changes nothing and is skipped.  A keyed
// key's thread folds its union row field by field: the first field reads
// the row's inv entries from memory and the later ones from L1, so the card
// reads inv once, where a launch per field read it once per field.
//
// Bound on the H100: bytes — every input state read once, the merged
// states written once (keyed: each slot map once, each source's occupied
// rows).  The cost it was redesigned against is fixed: one launch per
// field and key, a host-to-device copy of `order` and a stack of the
// sources per key cost about 0.17 ms a key whatever its size.  Here a
// merge is one launch with no copy; a thread issues a batch of its
// sources' loads before it folds them, and the dense loads are coalesced
// (thread r reads row r of each source); in keyed mode a key's union slot
// is near its slot in each device table (the same hash home), so the
// gathers stay mostly coalesced.
#include "common.cuh"

#include <float.h>

enum { kSum = 0, kCount = 1, kMin = 2, kMax = 3, kLastTs = 4, kLastVal = 5 };
enum { kF64 = 0, kF32 = 1, kI64 = 2, kI32 = 3 };

// The descriptor's capacity: its size is what sm_90's kernel parameter
// space holds (32,764 bytes).  Mirrored by _FoldDesc in ops/aggregate.py.
constexpr int kMaxKeys = 64;
constexpr int kMaxOrder = 512;
constexpr int kMaxPtrs = 3734;

struct KeyDesc {
  int64_t rows;      // the key's rows (keyed: h or h + 1)
  int32_t ptr0;      // its first pointer in `ptrs`
  uint8_t present;   // bit f: field f (sums, counts, mins, maxs, last_ts, last_val)
  uint8_t keyed;     // 1: fold through `inv`
  uint8_t dtype[4];  // of sums, counts, mins, maxs
  uint8_t reserved[6];
};

// Per present field, in field order: its output, then its M sources' row
// bases (`ptrs[ptr0 + i * (m + 1)]` is the i-th present field's output).
struct FoldDesc {
  int32_t desc_bytes;  // sizeof(FoldDesc) as the caller laid it out
  int32_t n_keys;
  int32_t m;
  int32_t n_local;
  int32_t n_order;
  int32_t rule;        // 0: fold (tile mesh), 1: psum (table-fed)
  int32_t n_ptrs;
  int32_t n_slots;     // rows of inv (keyed keys)
  int64_t h;           // slot-table size (keyed keys)
  int64_t total_rows;  // the keys' rows summed
  int64_t n_blocks;    // blk_end[n_keys - 1]
  const int32_t* inv;  // [n_slots, h] or null
  // null, or a staged launch's table: ptrs[n_ptrs], then per entry of
  // `order` its slot's row of inv (null without inv), then int32 order[n_order]
  const void* const* table;
  uint32_t blk_end[kMaxKeys];  // running sum of each key's blocks
  KeyDesc keys[kMaxKeys];
  uint16_t order[kMaxOrder];   // the real sources in global source order
  const void* ptrs[kMaxPtrs];
};
static_assert(sizeof(FoldDesc) <= 32764, "K22's descriptor must fit the kernel parameters");

struct InvertArgs {
  const int32_t* slot_map;  // [d, h]: union slot of each device-table row (h = none)
  int32_t* inv;             // [d, h], filled with -1 by the caller
  int64_t h;
  int32_t d;
  int32_t reserved;
};

constexpr int kThreads = 256;
constexpr int kBatch = 4;       // sources loaded before they are folded
constexpr int kKeyedBatch = 4;
constexpr int kSmemPtrs = 1024; // a key's pointers staged in shared memory (8 KB)

// What a row reads of the launch, in registers and shared memory: the
// descriptor's scalars, and `order` staged by the block.
struct Ctx {
  const int32_t* const* inv_rows;  // per entry of `order`: its slot's row of inv
  const int32_t* order;
  int64_t h;
  int32_t m, n_local, n_order, rule;
};

// IEEE adds with the NaN rules of the reference's CPU backend (x86 SSE),
// not the card's (which returns one canonical NaN): a NaN operand comes
// out quieted, the first one when both are NaN, and an invalid sum
// (inf - inf) is the sign-set default NaN.  So a state's bytes do not
// depend on the device that folded it.
__device__ __forceinline__ double add_rn(double a, double b) {
  if (a != a) return __longlong_as_double(__double_as_longlong(a) | 0x0008000000000000LL);
  if (b != b) return __longlong_as_double(__double_as_longlong(b) | 0x0008000000000000LL);
  const double r = __dadd_rn(a, b);
  return r != r ? __longlong_as_double((long long)0xfff8000000000000ULL) : r;
}
__device__ __forceinline__ float add_rn(float a, float b) {
  if (a != a) return __int_as_float(__float_as_int(a) | 0x00400000);
  if (b != b) return __int_as_float(__float_as_int(b) | 0x00400000);
  const float r = __fadd_rn(a, b);
  return r != r ? __int_as_float((int)0xffc00000u) : r;
}
__device__ __forceinline__ int64_t add_rn(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ int32_t add_rn(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }
__device__ __forceinline__ bool sign_of(double v) { return signbit(v); }
__device__ __forceinline__ bool sign_of(float v) { return signbit(v); }
__device__ __forceinline__ bool sign_of(int64_t v) { return v < 0; }
__device__ __forceinline__ bool sign_of(int32_t v) { return v < 0; }

// jnp.minimum / jnp.maximum (and the scatter combiners) as the reference's
// CPU backend computes them (LLVM's x86 lowering of IEEE minimum/maximum):
// order the operands by the first one's sign, take MINSD/MAXSD (the second
// operand on a NaN or a tie), and return the first ordered operand when it
// is a NaN.  So -0 < +0, a NaN propagates unquieted, and of two NaNs the
// sign decides which.
template <typename T> __device__ __forceinline__ T ieee_min(T a, T b) {
  const bool pos = !sign_of(a);
  const T x = pos ? a : b, y = pos ? b : a;
  return is_nan(x) ? x : (x < y ? x : y);
}
template <typename T> __device__ __forceinline__ T ieee_max(T a, T b) {
  const bool neg = sign_of(a);
  const T x = neg ? a : b, y = neg ? b : a;
  return is_nan(x) ? x : (x > y ? x : y);
}
// psum_states' LAST across slots (XLA CPU pmax): NaN is skipped, and a tie
// keeps the accumulated (earlier slot's) value.
template <typename T> __device__ __forceinline__ T coll_max(T acc, T b) {
  if (is_nan(acc)) return b;
  if (is_nan(b)) return acc;
  return b > acc ? b : acc;
}

template <typename T> __device__ __forceinline__ T type_max();
template <> __device__ __forceinline__ double type_max<double>() { return DBL_MAX; }
template <> __device__ __forceinline__ float type_max<float>() { return FLT_MAX; }
template <> __device__ __forceinline__ int64_t type_max<int64_t>() { return 0x7fffffffffffffffLL; }
template <> __device__ __forceinline__ int32_t type_max<int32_t>() { return 0x7fffffff; }

// Read-only loads of element i of a source.
template <typename T> __device__ __forceinline__ T load(const void* base, int64_t i);
template <> __device__ __forceinline__ double load<double>(const void* b, int64_t i) {
  return __ldg((const double*)b + i);
}
template <> __device__ __forceinline__ float load<float>(const void* b, int64_t i) {
  return __ldg((const float*)b + i);
}
template <> __device__ __forceinline__ int64_t load<int64_t>(const void* b, int64_t i) {
  return (int64_t)__ldg((const long long*)b + i);
}
template <> __device__ __forceinline__ int32_t load<int32_t>(const void* b, int64_t i) {
  return __ldg((const int*)b + i);
}

template <typename T, int K> __device__ __forceinline__ T identity() {
  return K == kMin ? type_max<T>() : (K == kMax ? (T)(-type_max<T>()) : (T)0);
}

// One dense field of row r: a batch of source loads, then their fold.
template <typename T, int K>
__device__ __forceinline__ void dense_field(const Ctx& a, const void* const* src, void* dst,
                                            int64_t r) {
  const int n = K == kSum ? a.n_order : a.m;
  T acc = (T)0;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 + i < n) v[i] = load<T>(src[K == kSum ? (int)a.order[k0 + i] : k0 + i], r);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i;
      if (k >= n) break;
      if (k == 0 && K != kCount) acc = v[i];
      else if (K == kSum) acc = a.rule == 1 ? add_rn(v[i], acc) : add_rn(acc, v[i]);
      else if (K == kCount) acc = add_rn(acc, v[i]);
      else if (K == kMin) acc = ieee_min(acc, v[i]);
      else acc = ieee_max(acc, v[i]);
    }
  }
  ((T*)dst)[r] = acc;
}

template <typename T>
__device__ __forceinline__ void dense_typed(const Ctx& a, int f, const void* const* src,
                                            void* dst, int64_t r) {
  switch (f) {
    case kSum: dense_field<T, kSum>(a, src, dst, r); break;
    case kCount: dense_field<T, kCount>(a, src, dst, r); break;
    case kMin: dense_field<T, kMin>(a, src, dst, r); break;
    default: dense_field<T, kMax>(a, src, dst, r); break;
  }
}

__device__ __forceinline__ void dense_last(const Ctx& a, const void* const* ts,
                                           const void* const* val, int64_t r) {
  int64_t lt;
  double lv = 0.0;
  if (a.rule == 0) {
    const int o0 = a.order[0];
    lt = load<int64_t>(ts[1 + o0], r);
    lv = load<double>(val[1 + o0], r);
    for (int k0 = 1; k0 < a.n_order; k0 += kBatch) {
      int64_t bt[kBatch];
      double bv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (k0 + i < a.n_order) {
          const int o = a.order[k0 + i];
          bt[i] = load<int64_t>(ts[1 + o], r);
          bv[i] = load<double>(val[1 + o], r);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (k0 + i >= a.n_order) break;
        if (bt[i] >= lt) lv = bv[i];
        lt = bt[i] > lt ? bt[i] : lt;
      }
    }
  } else {
    lt = load<int64_t>(ts[1], r);
    for (int m = 1; m < a.m; ++m) {
      const int64_t t = load<int64_t>(ts[1 + m], r);
      lt = t > lt ? t : lt;
    }
    for (int m = 0; m < a.m; ++m) {
      const double c = load<int64_t>(ts[1 + m], r) == lt ? load<double>(val[1 + m], r) : -DBL_MAX;
      lv = m == 0 ? c : coll_max(lv, c);
    }
  }
  ((int64_t*)ts[0])[r] = lt;
  ((double*)val[0])[r] = lv;
}

// One keyed field of union row u: per batch of sources in `order`, their
// inv entries (the key's first field reads them from memory, the later
// ones from L1), then their gathers, then the fold.
template <typename T, int K>
__device__ __forceinline__ void keyed_field(const Ctx& a, const void* const* src, void* dst,
                                            int64_t u) {
  T acc = identity<T, K>();
  for (int k0 = 0; k0 < a.n_order; k0 += kKeyedBatch) {
    int mm[kKeyedBatch];
    int64_t j[kKeyedBatch];
#pragma unroll
    for (int i = 0; i < kKeyedBatch; ++i) {
      mm[i] = 0;
      j[i] = -1;
      if (k0 + i < a.n_order) {
        mm[i] = a.order[k0 + i];
        j[i] = u < a.h ? (int64_t)__ldg(a.inv_rows[k0 + i] + u) : a.h;
      }
    }
    T v[kKeyedBatch];
#pragma unroll
    for (int i = 0; i < kKeyedBatch; ++i) {
      if (j[i] >= 0) v[i] = load<T>(src[mm[i]], j[i]);
    }
#pragma unroll
    for (int i = 0; i < kKeyedBatch; ++i) {
      if (j[i] < 0) continue;
      if (K == kMin) acc = ieee_min(acc, v[i]);
      else if (K == kMax) acc = ieee_max(acc, v[i]);
      else acc = add_rn(v[i], acc);
    }
  }
  ((T*)dst)[u] = acc;
}

template <typename T>
__device__ __forceinline__ void keyed_typed(const Ctx& a, int f, const void* const* src,
                                            void* dst, int64_t u) {
  switch (f) {
    case kSum: keyed_field<T, kSum>(a, src, dst, u); break;
    case kCount: keyed_field<T, kCount>(a, src, dst, u); break;
    case kMin: keyed_field<T, kMin>(a, src, dst, u); break;
    default: keyed_field<T, kMax>(a, src, dst, u); break;
  }
}

// A keyed key of at most kKeyedBatch real sources over a CTA's blocks
// [vb0, vb1): the sources' rows of inv and indices stay in registers, and
// a row reads its inv entries once for every field.
template <typename T, int K>
__device__ __forceinline__ void keyed_row_field(const void* const* src, void* dst,
                                                const int* mm, const int64_t* j, int64_t u) {
  T acc = identity<T, K>();
  T v[kKeyedBatch];
#pragma unroll
  for (int i = 0; i < kKeyedBatch; ++i) {
    if (j[i] >= 0) v[i] = load<T>(src[mm[i]], j[i]);
  }
#pragma unroll
  for (int i = 0; i < kKeyedBatch; ++i) {
    if (j[i] < 0) continue;
    if (K == kMin) acc = ieee_min(acc, v[i]);
    else if (K == kMax) acc = ieee_max(acc, v[i]);
    else acc = add_rn(v[i], acc);
  }
  ((T*)dst)[u] = acc;
}

template <typename T>
__device__ __forceinline__ void keyed_row_typed(int f, const void* const* src, void* dst,
                                                const int* mm, const int64_t* j, int64_t u) {
  switch (f) {
    case kSum: keyed_row_field<T, kSum>(src, dst, mm, j, u); break;
    case kCount: keyed_row_field<T, kCount>(src, dst, mm, j, u); break;
    case kMin: keyed_row_field<T, kMin>(src, dst, mm, j, u); break;
    default: keyed_row_field<T, kMax>(src, dst, mm, j, u); break;
  }
}

__device__ __forceinline__ void keyed_segment(const Ctx& c, const KeyDesc& key,
                                              const void* const* p, int64_t first, int64_t vb0,
                                              int64_t vb1) {
  const int32_t* rows_of[kKeyedBatch];
  int mm[kKeyedBatch];
#pragma unroll
  for (int i = 0; i < kKeyedBatch; ++i) {
    const bool live = i < c.n_order;
    mm[i] = live ? c.order[i] : 0;
    rows_of[i] = live ? c.inv_rows[i] : nullptr;
  }
  for (int64_t vb = vb0; vb < vb1; ++vb) {
    const int64_t u = (vb - first) * kThreads + threadIdx.x;
    if (u >= key.rows) break;
    int64_t j[kKeyedBatch];
#pragma unroll
    for (int i = 0; i < kKeyedBatch; ++i) {
      j[i] = rows_of[i] == nullptr ? -1 : (u < c.h ? (int64_t)__ldg(rows_of[i] + u) : c.h);
    }
    int nf = 0;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (!((key.present >> f) & 1)) continue;
      const void* const* src = p + nf * (c.m + 1);
      ++nf;
      switch (key.dtype[f]) {
        case kF64: keyed_row_typed<double>(f, src + 1, (void*)src[0], mm, j, u); break;
        case kF32: keyed_row_typed<float>(f, src + 1, (void*)src[0], mm, j, u); break;
        case kI64: keyed_row_typed<int64_t>(f, src + 1, (void*)src[0], mm, j, u); break;
        default: keyed_row_typed<int32_t>(f, src + 1, (void*)src[0], mm, j, u); break;
      }
    }
  }
}

// The rows of one 256-row block of a key: a thread a row, every field.
__device__ __forceinline__ void fold_rows(const Ctx& c, const KeyDesc& key,
                                          const void* const* p, int64_t r) {
  int nf = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (!((key.present >> f) & 1)) continue;
    const void* const* src = p + nf * (c.m + 1);
    void* dst = (void*)src[0];
    ++nf;
    if (key.keyed) {
      switch (key.dtype[f]) {
        case kF64: keyed_typed<double>(c, f, src + 1, dst, r); break;
        case kF32: keyed_typed<float>(c, f, src + 1, dst, r); break;
        case kI64: keyed_typed<int64_t>(c, f, src + 1, dst, r); break;
        default: keyed_typed<int32_t>(c, f, src + 1, dst, r); break;
      }
      continue;
    }
    switch (key.dtype[f]) {
      case kF64: dense_typed<double>(c, f, src + 1, dst, r); break;
      case kF32: dense_typed<float>(c, f, src + 1, dst, r); break;
      case kI64: dense_typed<int64_t>(c, f, src + 1, dst, r); break;
      default: dense_typed<int32_t>(c, f, src + 1, dst, r); break;
    }
  }
  if ((key.present >> kLastTs) & 1) {
    dense_last(c, p + nf * (c.m + 1), p + (nf + 1) * (c.m + 1), r);
  }
}

// The keys' 256-row blocks lie end to end; a CTA takes a contiguous range
// of them (the grid is what the card holds at once).  The descriptor read
// by a computed index goes through generic loads of the parameter space,
// so a CTA stages `order`, each source's row of inv and the current key's
// pointers in shared memory once, and again only where its range crosses
// into the next key; a keyed key of up to four real sources keeps their
// rows of inv in registers across its rows.  A staged launch reads `order`
// and the rows of inv from its table, and stages a key's pointers from it
// where they fit.  At most 64 registers: four CTAs an SM.
__global__ void __launch_bounds__(kThreads, 4) fold_kernel(const __grid_constant__ FoldDesc a) {
  __shared__ const void* sp[kSmemPtrs];
  __shared__ int32_t so[kMaxOrder];
  __shared__ const int32_t* sinv[kMaxOrder];
  const void* const* ptrs = a.ptrs;
  const int32_t* const* inv_rows = sinv;
  const int32_t* order = so;
  if (a.table != nullptr) {
    ptrs = a.table;
    inv_rows = (const int32_t* const*)(a.table + a.n_ptrs);
    order = (const int32_t*)(a.table + a.n_ptrs + a.n_order);
  } else {
    for (int i = threadIdx.x; i < a.n_order; i += kThreads) {
      so[i] = a.order[i];
      sinv[i] = a.inv == nullptr ? nullptr : a.inv + (int64_t)(a.order[i] / a.n_local) * a.h;
    }
  }
  const Ctx c{inv_rows, order, a.h, a.m, a.n_local, a.n_order, a.rule};
  const int64_t per = (a.n_blocks + gridDim.x - 1) / gridDim.x;
  const int64_t vb_end = min((int64_t)(blockIdx.x + 1) * per, a.n_blocks);
  int64_t vb = (int64_t)blockIdx.x * per;
  while (vb < vb_end) {
    // the key of block vb (the same for every thread of the CTA)
    int lo = 0, hi = a.n_keys - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (vb < (int64_t)a.blk_end[mid]) hi = mid;
      else lo = mid + 1;
    }
    const KeyDesc key = a.keys[lo];
    const int64_t first = lo == 0 ? 0 : a.blk_end[lo - 1];
    const int64_t seg_end = min((int64_t)a.blk_end[lo], vb_end);
    const int n_p = __popc(key.present) * (a.m + 1);
    const void* const* p = ptrs + key.ptr0;
    __syncthreads();  // the last key's pointers are read no more
    if (n_p <= kSmemPtrs) {
      for (int i = threadIdx.x; i < n_p; i += kThreads) sp[i] = p[i];
      p = sp;
    }
    __syncthreads();
    if (key.keyed && c.n_order <= kKeyedBatch) {
      keyed_segment(c, key, p, first, vb, seg_end);
    } else {
      for (int64_t b = vb; b < seg_end; ++b) {
        const int64_t r = (b - first) * kThreads + threadIdx.x;
        if (r < key.rows) fold_rows(c, key, p, r);
      }
    }
    vb = seg_end;
  }
}

__global__ void __launch_bounds__(kThreads) invert_kernel(const InvertArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)a.d * a.h) return;
  const int64_t d = i / a.h;
  const int64_t u = a.slot_map[i];
  if (u >= 0 && u < a.h) a.inv[d * a.h + u] = (int32_t)(i - d * a.h);
}

GT_EXPORT int gt_fold_states(const FoldDesc* desc, void* stream) {
  const FoldDesc& a = *desc;
  if (a.desc_bytes != (int32_t)sizeof(FoldDesc) || a.n_keys <= 0 || a.n_keys > kMaxKeys ||
      a.m <= 0 || a.n_local <= 0 || a.m % a.n_local != 0 || a.n_order <= 0 ||
      (a.table == nullptr && (a.n_order > kMaxOrder || a.n_ptrs > kMaxPtrs)) ||
      a.n_blocks < 0 ||
      a.n_blocks != (int64_t)a.blk_end[a.n_keys - 1]) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_blocks == 0) return (int)cudaSuccess;
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_kernel, kThreads, 0);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int64_t grid = a.n_blocks < resident ? a.n_blocks : resident;
  fold_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_fold_invert(const InvertArgs* args, void* stream) {
  const int64_t n = (int64_t)args->d * args->h;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  invert_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(*args);
  return (int)cudaGetLastError();
}
