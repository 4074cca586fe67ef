// K22 fold_states: the mesh merge of partial aggregate states.
//
// Replaces greptimedb_tpu/ops/aggregate.py:1007 `psum_states` (B20) and the
// folds of greptimedb_tpu/parallel/tile_cache.py:3491-3673
// `_mesh_merge_program` (dense and keyed) and :3682
// `_mesh_hash_cross_program`, and the collective merge of
// greptimedb_tpu/parallel/executor.py:508-527 `_device_step`.
//
// Input: the partial states of one AggState key from M = D * n_local
// sources, gathered on the first mesh slot as [M, rows] (source m sits on
// slot m / n_local, n_local per slot, padded with all-invalid dummies), and
// `order`, the rows of the real sources in global source order.  One thread
// per output row walks the sources in a fixed order, so the bytes are the
// same on every run and no float atomic is involved.
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
// Keyed mode (hash plans): each slot's states are indexed by its own slot
// table; `inv[d, u]` is the row of slot d's table that holds union row u's
// key, or -1 (built by gt_fold_invert from K17's union slot map).  Row u
// starts at the scatter identity (0, 0, +DBL_MAX, -DBL_MAX) and takes
// g[m, inv[d_m, u]] in `order`, as the reference's `.at[].add/min/max`
// scatters do in global source order (the add keeping the update's NaN
// where two meet); a trailing row (rows == h + 1) takes each source's own
// trailing row.  The empty slots of a device table hold the identity (as
// every partial leaves them), so folding them into the trailing row, as
// the reference's scatter does, changes nothing and is skipped.
//
// Bound on the H100: bytes — every input state read once (M * rows
// elements per field), the merged state written once.  The dense loads are
// coalesced (thread r reads row r of each source); in keyed mode a key's
// union slot is near its slot in each device table (the same hash home),
// so the gathers stay mostly coalesced.
#include "common.cuh"

#include <float.h>

enum { kNone = 0, kSum = 1, kCount = 2, kMin = 3, kMax = 4 };
enum { kF64 = 0, kF32 = 1, kI64 = 2, kI32 = 3 };

struct FoldField {
  const void* src;  // [m, rows]
  void* dst;        // [rows]
  int32_t kind;
  int32_t dtype;
};

struct FoldArgs {
  FoldField fields[4];         // sums, counts, mins, maxs (kind kNone: absent)
  const int64_t* last_ts;      // [m, rows] or null
  const double* last_val;      // [m, rows]
  int64_t* out_last_ts;        // [rows]
  double* out_last_val;        // [rows]
  const int32_t* order;        // [n_order] rows of the real sources, global order
  const int32_t* inv;          // [d, h] (keyed mode) or null (dense mode)
  int64_t rows;
  int64_t h;                   // slot-table size (keyed mode)
  int32_t m;
  int32_t n_local;
  int32_t n_order;
  int32_t rule;                // 0: fold (tile mesh), 1: psum (table-fed)
};

struct InvertArgs {
  const int32_t* slot_map;  // [d, h]: union slot of each device-table row (h = none)
  int32_t* inv;             // [d, h], filled with -1 by the caller
  int64_t h;
  int32_t d;
  int32_t reserved;
};

constexpr int kThreads = 256;

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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) dense_field(const FoldArgs a, const T* __restrict__ g,
                                                        T* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.rows) return;
  const int64_t R = a.rows;
  T acc = (T)0;
  if (K == kSum) {
    acc = g[(int64_t)a.order[0] * R + r];
    for (int k = 1; k < a.n_order; ++k) {
      const T v = g[(int64_t)a.order[k] * R + r];
      acc = a.rule == 1 ? add_rn(v, acc) : add_rn(acc, v);
    }
  } else if (K == kCount) {
    acc = 0;
    for (int m = 0; m < a.m; ++m) acc = add_rn(acc, g[(int64_t)m * R + r]);
  } else {
    acc = g[r];
    for (int m = 1; m < a.m; ++m) {
      const T v = g[(int64_t)m * R + r];
      acc = K == kMin ? ieee_min(acc, v) : ieee_max(acc, v);
    }
  }
  out[r] = acc;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) keyed_field(const FoldArgs a, const T* __restrict__ g,
                                                        T* __restrict__ out) {
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= a.rows) return;
  const int64_t R = a.rows;
  T acc = K == kMin ? type_max<T>() : (K == kMax ? (T)(-type_max<T>()) : (T)0);
  for (int k = 0; k < a.n_order; ++k) {
    const int m = a.order[k];
    const int d = m / a.n_local;
    const int64_t j = u < a.h ? (int64_t)a.inv[(int64_t)d * a.h + u] : a.h;
    if (j < 0) continue;
    const T v = g[(int64_t)m * R + j];
    if (K == kMin) acc = ieee_min(acc, v);
    else if (K == kMax) acc = ieee_max(acc, v);
    else acc = add_rn(v, acc);
  }
  out[u] = acc;
}

__global__ void __launch_bounds__(kThreads) dense_last(const FoldArgs a) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.rows) return;
  const int64_t R = a.rows;
  int64_t lt;
  double lv = 0.0;
  if (a.rule == 0) {
    const int64_t o0 = (int64_t)a.order[0] * R + r;
    lt = a.last_ts[o0];
    lv = a.last_val[o0];
    for (int k = 1; k < a.n_order; ++k) {
      const int64_t o = (int64_t)a.order[k] * R + r;
      const int64_t bt = a.last_ts[o];
      if (bt >= lt) lv = a.last_val[o];
      lt = bt > lt ? bt : lt;
    }
  } else {
    lt = a.last_ts[r];
    for (int m = 1; m < a.m; ++m) {
      const int64_t t = a.last_ts[(int64_t)m * R + r];
      lt = t > lt ? t : lt;
    }
    for (int m = 0; m < a.m; ++m) {
      const int64_t o = (int64_t)m * R + r;
      const double c = a.last_ts[o] == lt ? a.last_val[o] : -DBL_MAX;
      lv = m == 0 ? c : coll_max(lv, c);
    }
  }
  a.out_last_ts[r] = lt;
  a.out_last_val[r] = lv;
}

__global__ void __launch_bounds__(kThreads) invert_kernel(const InvertArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)a.d * a.h) return;
  const int64_t d = i / a.h;
  const int64_t u = a.slot_map[i];
  if (u >= 0 && u < a.h) a.inv[d * a.h + u] = (int32_t)(i - d * a.h);
}

template <typename T>
static int launch_field(const FoldArgs& a, const FoldField& f, unsigned grid, cudaStream_t s) {
  const T* g = (const T*)f.src;
  T* out = (T*)f.dst;
  const bool keyed = a.inv != nullptr;
  switch (f.kind) {
    case kSum:
      if (keyed) keyed_field<T, kSum><<<grid, kThreads, 0, s>>>(a, g, out);
      else dense_field<T, kSum><<<grid, kThreads, 0, s>>>(a, g, out);
      break;
    case kCount:
      if (keyed) keyed_field<T, kCount><<<grid, kThreads, 0, s>>>(a, g, out);
      else dense_field<T, kCount><<<grid, kThreads, 0, s>>>(a, g, out);
      break;
    case kMin:
      if (keyed) keyed_field<T, kMin><<<grid, kThreads, 0, s>>>(a, g, out);
      else dense_field<T, kMin><<<grid, kThreads, 0, s>>>(a, g, out);
      break;
    case kMax:
      if (keyed) keyed_field<T, kMax><<<grid, kThreads, 0, s>>>(a, g, out);
      else dense_field<T, kMax><<<grid, kThreads, 0, s>>>(a, g, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

GT_EXPORT int gt_fold_states(const FoldArgs* args, void* stream) {
  const FoldArgs& a = *args;
  if (a.rows <= 0) return (int)cudaSuccess;
  if (a.m <= 0 || a.n_local <= 0 || a.m % a.n_local != 0 || a.n_order <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((a.rows + kThreads - 1) / kThreads);
  for (int i = 0; i < 4; ++i) {
    const FoldField& f = a.fields[i];
    if (f.kind == kNone) continue;
    int err = 0;
    switch (f.dtype) {
      case kF64: err = launch_field<double>(a, f, grid, s); break;
      case kF32: err = launch_field<float>(a, f, grid, s); break;
      case kI64: err = launch_field<int64_t>(a, f, grid, s); break;
      case kI32: err = launch_field<int32_t>(a, f, grid, s); break;
      default: err = (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
  }
  if (a.last_ts != nullptr) {
    if (a.inv != nullptr) return (int)cudaErrorInvalidValue;
    dense_last<<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_fold_invert(const InvertArgs* args, void* stream) {
  const int64_t n = (int64_t)args->d * args->h;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  invert_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(*args);
  return (int)cudaGetLastError();
}
