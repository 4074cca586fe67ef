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
// 4-byte gid and a 1-byte mask (double-groupby-1: 1 + 4 + 8 + 8 read, 5
// written).  There is no reuse to exploit, so the design is one thread
// per row over a grid-stride loop with coalesced loads; literals (IN-lists
// included) are runtime data in a small device buffer, read through the
// read-only cache.  The bucket origin and interval lead that buffer
// (lits[0], lits[1]) instead of riding the argument struct by value: a
// CUDA graph bakes a launch's arguments in, so a captured dashboard tick
// slides its window by rewriting the buffer, with no recapture.
//
// Semantics kept from the reference:
//  * time_bucket is a FLOOR division, (ts - origin) // interval, then a
//    wrapping cast to int32 (XLA's astype); C++ `/` truncates, so the
//    quotient is corrected for negative offsets.
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
};

template <typename T>
__device__ __forceinline__ bool cmp(T x, T y, int op) {
  switch (op) {
    case kEq: return x == y;
    case kNe: return x != y;
    case kLt: return x < y;
    case kLe: return x <= y;
    case kGt: return x > y;
    default: return x >= y;  // kGe
  }
}

template <typename T>
__device__ __forceinline__ bool eval_filter(T x, const int64_t* lits, int op, int off, int cnt) {
  if (op == kIn || op == kNotIn) {
    bool any_eq = false, all_ne = true;
    for (int j = 0; j < cnt; ++j) {
      int64_t bits = __ldg(lits + off + j);
      T y;
      if constexpr (std::is_floating_point<T>::value) y = __longlong_as_double(bits);
      else y = (T)bits;
      any_eq = any_eq || (x == y);
      all_ne = all_ne && (x != y);
    }
    return op == kIn ? any_eq : all_ne;
  }
  int64_t bits = __ldg(lits + off);
  T y;
  if constexpr (std::is_floating_point<T>::value) y = __longlong_as_double(bits);
  else y = (T)bits;
  return cmp<T>(x, y, op);
}

// IdT: int32_t or int64_t; UT its unsigned twin, in which the mixed-radix
// composition wraps as XLA's integer arithmetic does
template <typename IdT, typename UT>
__global__ void __launch_bounds__(256) mask_gids_kernel(const MaskGidsArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const bool valid = a.valid[i] != 0;
    bool m = valid;
    for (int f = 0; f < a.n_filters; ++f) {
      const int kind = a.fkind[f], op = a.fop[f], off = a.flit_off[f], cnt = a.flit_cnt[f];
      bool ok;
      if (kind == kF64) {
        ok = eval_filter<double>(((const double*)a.fplane[f])[i], a.lits, op, off, cnt);
      } else if (kind == kI64) {
        ok = eval_filter<int64_t>(((const int64_t*)a.fplane[f])[i], a.lits, op, off, cnt);
      } else if (kind == kI32) {
        ok = eval_filter<int64_t>((int64_t)((const int32_t*)a.fplane[f])[i], a.lits, op, off, cnt);
      } else {
        ok = eval_filter<int64_t>((int64_t)((const uint8_t*)a.fplane[f])[i], a.lits, op, off, cnt);
      }
      m = m && ok;
    }
    for (int k = 0; k < a.n_gates; ++k) m = m && (a.gate[k][i] != 0);

    // mixed-radix group id with XLA's wrapping arithmetic in IdT
    UT gid = 0;
    bool in_range = true;
    for (int k = 0; k < a.n_tags; ++k) {
      const IdT c = (IdT)a.tag[k][i], card = (IdT)a.card[k];
      in_range = in_range && c >= 0 && c < card;
      const IdT cc = c < 0 ? 0 : (c > card - 1 ? card - 1 : c);
      gid = gid * (UT)card + (UT)cc;
    }
    if (a.ts != nullptr) {
      const int64_t origin = __ldg(a.lits), interval = __ldg(a.lits + 1);
      const int64_t d = (int64_t)((uint64_t)a.ts[i] - (uint64_t)origin);
      int64_t q = d / interval;
      if ((d % interval != 0) && ((d < 0) != (interval < 0))) q -= 1;  // floor
      const IdT b = (IdT)(int32_t)(uint32_t)(uint64_t)q;                   // astype(int32)
      const IdT card = (IdT)a.n_buckets;
      in_range = in_range && b >= 0 && b < card;
      const IdT bb = b < 0 ? 0 : (b > card - 1 ? card - 1 : b);
      gid = gid * (UT)card + (UT)bb;
    }
    IdT* out = (IdT*)a.gids_out;
    if constexpr (sizeof(IdT) == 8) {
      out[i] = (IdT)gid;  // the hash ids have no padding rule
    } else {
      out[i] = valid ? (IdT)gid : (IdT)a.pad_gid;
    }
    a.mask_out[i] = (m && in_range) ? 1 : 0;
  }
}

GT_EXPORT int gt_mask_gids(const MaskGidsArgs* args, void* stream) {
  const int64_t n = args->n;
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 CTAs per SM
  if (args->id64) {
    mask_gids_kernel<int64_t, uint64_t><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  } else {
    mask_gids_kernel<int32_t, uint32_t><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
