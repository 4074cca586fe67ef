// A per-group operand of the select stage, read by K13 (having_mask.cu)
// and K7 (topk_select.cu): what a HAVING or ORDER BY ref reads for group g
// of the finalized [G] states, with its NULL rule, read straight from the
// states so no torch op runs before the kernels.
//
//   values  [G] f64 / f32 / i32 / i64 / u8, or nullptr for a dim ref: the
//           group's coordinate (g / div) % card in the mixed-radix id
//   nulls   nullptr; a NULL plane (u8, nonzero = NULL); or a count plane
//           (i32 / i64, NULL where 0)
//   nan_null  a NaN value is NULL too (the host's NULL for a NaN output)
//
// G < 2^31, so a dim coordinate needs no 64-bit division: g / div and
// q / card are each a multiply-high by a magic number the host derives
// once per structure (ops/aggregate.py `_div_magic`; Granlund-Montgomery,
// "Division by invariant integers using multiplication", thm 4.2 with
// N = 31: exact for every numerator below 2^31).  Mirrored by _GroupRef in
// ops/aggregate.py (ctypes).
#pragma once

#include <stdint.h>

enum GroupValueType : int32_t { kF64 = 0, kF32 = 1, kI32 = 2, kI64 = 3, kU8 = 4 };
enum GroupNullType : int32_t { kNoNull = 0, kNullPlane = 1, kCountI32 = 2, kCountI64 = 3 };

struct GroupRef {
  const void* values;  // [G], or nullptr: a dim ref
  const void* nulls;   // [G] per ntype, or nullptr
  int32_t vtype;       // GroupValueType
  int32_t ntype;       // GroupNullType
  int32_t nan_null;
  uint32_t card;       // dim ref: (g / div) % card
  uint32_t div_mul;    // g / div = (g * div_mul) >> div_shift
  uint32_t div_shift;
  uint32_t card_mul;   // q / card = (q * card_mul) >> card_shift
  uint32_t card_shift;
};

__device__ __forceinline__ uint32_t magic_div(uint32_t n, uint32_t mul, uint32_t shift) {
  return (uint32_t)(((uint64_t)n * mul) >> shift);
}

__device__ __forceinline__ uint32_t dim_coord(const GroupRef& r, uint32_t g) {
  const uint32_t q = magic_div(g, r.div_mul, r.div_shift);
  return q - r.card * magic_div(q, r.card_mul, r.card_shift);
}

__device__ __forceinline__ bool group_null(const GroupRef& r, uint32_t g) {
  switch (r.ntype) {
    case kNullPlane: return __ldg((const uint8_t*)r.nulls + g) != 0;
    case kCountI32: return __ldg((const int32_t*)r.nulls + g) == 0;
    case kCountI64: return __ldg((const long long*)r.nulls + g) == 0;
    default: return false;
  }
}

// The ref's value as f64 (the reference's astype(float64)) and whether it
// is NULL.
__device__ __forceinline__ double group_value_f64(const GroupRef& r, uint32_t g, bool& null) {
  double x;
  switch (r.values == nullptr ? -1 : r.vtype) {
    case -1: x = (double)dim_coord(r, g); break;
    case kF64: x = __ldg((const double*)r.values + g); break;
    case kF32: x = (double)__ldg((const float*)r.values + g); break;
    case kI32: x = (double)__ldg((const int32_t*)r.values + g); break;
    case kI64: x = (double)__ldg((const long long*)r.values + g); break;
    default: x = (double)__ldg((const uint8_t*)r.values + g); break;
  }
  null = group_null(r, g) || (r.nan_null && x != x);
  return x;
}

// A float's position in lax.sort's total order as a signed int64: -0.0
// equals 0.0, every NaN is one NaN above +inf.
__device__ __forceinline__ int64_t float_order(double v) {
  if (v != v) return 0x7ff8000000000000LL;
  if (v == 0.0) return 0;
  const int64_t b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

// The raw value words of U groups of a ref, and their NULL planes' verdicts:
// the switch on the ref's kind is uniform and stands outside the groups'
// loop, so the U loads issue back to back before any is used.  A float's
// word is its bits (an f32's sign-extended), an integer's its value.
template <int U>
__device__ __forceinline__ void group_raw(const GroupRef& r, const uint32_t (&g)[U],
                                          int64_t (&raw)[U]) {
  if (r.values == nullptr) {
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = dim_coord(r, g[u]);
    return;
  }
  switch (r.vtype) {
    case kF64:
    case kI64:
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = __ldg((const long long*)r.values + g[u]);
      return;
    case kF32:
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = __float_as_int(__ldg((const float*)r.values + g[u]));
      return;
    case kI32:
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = __ldg((const int32_t*)r.values + g[u]);
      return;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = __ldg((const uint8_t*)r.values + g[u]);
      return;
  }
}

template <int U>
__device__ __forceinline__ void group_nulls(const GroupRef& r, const uint32_t (&g)[U],
                                            bool (&null)[U]) {
  switch (r.ntype) {
    case kNullPlane:
#pragma unroll
      for (int u = 0; u < U; ++u) null[u] = __ldg((const uint8_t*)r.nulls + g[u]) != 0;
      return;
    case kCountI32:
#pragma unroll
      for (int u = 0; u < U; ++u) null[u] = __ldg((const int32_t*)r.nulls + g[u]) == 0;
      return;
    case kCountI64:
#pragma unroll
      for (int u = 0; u < U; ++u) null[u] = __ldg((const long long*)r.nulls + g[u]) == 0;
      return;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u) null[u] = false;
      return;
  }
}

// ORDER BY key of a group from its raw word and NULL-plane verdict: its
// null bucket (-1 NULLs first, 1 NULLs last, 0 not NULL) and an int64
// whose signed order is lax.sort's order of the key (floats canonicalized
// by float_order; descending is -v, wrapping for integers; a NULL's value
// is 0; NaN is NULL where the ref says so).
__device__ __forceinline__ int64_t order_of_raw(const GroupRef& r, int64_t raw, bool null,
                                                bool ascending, bool nulls_first, int32_t& nb) {
  int64_t v;
  if (r.values != nullptr && (r.vtype == kF64 || r.vtype == kF32)) {
    const double x = r.vtype == kF64 ? __longlong_as_double(raw)
                                     : (double)__int_as_float((int32_t)raw);
    null = null || (r.nan_null && x != x);
    const double y = null ? 0.0 : x;
    v = float_order(ascending ? y : -y);
  } else {
    const int64_t y = null ? 0 : raw;
    v = ascending ? y : (int64_t)(0ULL - (uint64_t)y);  // wrapping negation
  }
  nb = null ? (nulls_first ? -1 : 1) : 0;
  return v;
}

// The same for one group g.
__device__ __forceinline__ int64_t group_order_key(const GroupRef& r, uint32_t g, bool ascending,
                                                   bool nulls_first, int32_t& nb) {
  const uint32_t gs[1] = {g};
  int64_t raw[1];
  bool null[1];
  group_raw<1>(r, gs, raw);
  group_nulls<1>(r, gs, null);
  return order_of_raw(r, raw[0], null[0], ascending, nulls_first, nb);
}
