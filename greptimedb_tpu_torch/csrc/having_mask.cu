// K13 having_mask: SQL HAVING over finalized [G] group states, with
// Kleene three-valued logic, fused with the survivor gate:
//   out[g] = eval(tree)[g] is TRUE  and  presence[g] > 0     (uint8 [G])
//
// Replaces greptimedb_tpu/ops/aggregate.py:1076 `having_mask` (B9), which
// the reference ANDs into the survivor mask before its top-k
// (parallel/tile_cache.py:3070-3117 `_device_select`).
//
// The predicate tree is encoded on the host as a short postfix program
// (ops/aggregate.py `_having_program`, built once per structure) and
// passed by value with its refs (group_ref.cuh), a __grid_constant__
// parameter: no table is uploaded and no CTA copies the program; every
// thread of a warp walks the same instructions, so each is a uniform read
// of the parameter space.  One thread evaluates the program for one group
// on a stack of (value, valid) bit pairs held as two bit masks in
// registers (bit i = stack level i):
//   CMP    op, ref, slot   x(ref) <op> literal[slot]      valid = ref not NULL
//   CMPREF op, r1, r2      x(r1) <op> x(r2)                valid = neither NULL
//   ISNULL ref, negated    (ref is NULL) xor negated       always valid
//   NOT                    ~v, validity kept
//   AND / OR               Kleene: a definite FALSE (TRUE) side decides
// Comparisons run in f64 after converting the value as the reference's
// astype(float64) does, so a NaN compares false (and != true).  A ref is
// NULL where its count plane is 0 and, for a float output marked so,
// where the value is NaN (the host's NULL bucket).  A dim ref is the
// group's coordinate (g / div) % card, by multiply-highs (no division).
// An unknown result drops the group, as SQL does.  The literals stay a
// device pointer: they are views of the tile program's uploaded input
// buffer, which a captured tick rewrites before each replay.
//
// Bound on the H100: bytes (the [G] planes the refs name read once, one
// byte a group written); at the TSBS shapes (G of a few tens of
// thousands) the launch dominates.
#include "common.cuh"
#include "group_ref.cuh"

constexpr int kMaxRefs = 16;
constexpr int kMaxCode = 64;
constexpr int kThreads = 256;

enum { kCmp = 0, kCmpRef = 1, kIsNull = 2, kNot = 3, kAnd = 4, kOr = 5 };
enum { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

// Mirrored field for field by _HavingArgs in ops/aggregate.py (ctypes).
struct HavingArgs {
  GroupRef refs[kMaxRefs];
  int16_t code[kMaxCode][4];  // op, a, b, c
  const double* literals;     // [n] comparison literals by slot (on the device)
  const void* presence;       // [G] kI32 or kI64
  uint8_t* out;               // [G]
  int32_t ptype;
  int32_t n_code;
  int32_t num_groups;
  int32_t reserved;
};

__device__ __forceinline__ bool compare(int op, double x, double y) {
  switch (op) {
    case kEq: return x == y;
    case kNe: return x != y;
    case kLt: return x < y;
    case kLe: return x <= y;
    case kGt: return x > y;
    default: return x >= y;
  }
}

__global__ void __launch_bounds__(kThreads) having_kernel(const __grid_constant__ HavingArgs a) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= (uint32_t)a.num_groups) return;
  // the Kleene stack: bit i of sv / sok is level i's value / validity
  uint32_t sv = 0, sok = 0;
  int sp = 0;
  for (int pc = 0; pc < a.n_code; ++pc) {
    const int op = a.code[pc][0];
    bool v, ok;
    if (op <= kIsNull) {
      bool xn;
      const double x = group_value_f64(a.refs[a.code[pc][op == kIsNull ? 1 : 2]], g, xn);
      if (op == kCmp) {
        v = compare(a.code[pc][1], x, __ldg(a.literals + a.code[pc][3]));
        ok = !xn;
      } else if (op == kCmpRef) {
        bool yn;
        const double y = group_value_f64(a.refs[a.code[pc][3]], g, yn);
        v = compare(a.code[pc][1], x, y);
        ok = !xn && !yn;
      } else {
        v = a.code[pc][2] ? !xn : xn;
        ok = true;
      }
      sv |= (uint32_t)v << sp;
      sok |= (uint32_t)ok << sp;
      ++sp;
      continue;
    }
    if (op == kNot) {
      sv ^= 1u << (sp - 1);
      continue;
    }
    // kAnd / kOr over levels sp - 2 (a) and sp - 1 (b)
    const bool bv = (sv >> (sp - 1)) & 1, bok = (sok >> (sp - 1)) & 1;
    const bool av = (sv >> (sp - 2)) & 1, aok = (sok >> (sp - 2)) & 1;
    if (op == kAnd) {
      v = av && bv;
      ok = (aok && bok) || (aok && !av) || (bok && !bv);
    } else {
      v = av || bv;
      ok = (aok && bok) || (aok && av) || (bok && bv);
    }
    --sp;
    const uint32_t keep = (1u << (sp - 1)) - 1;  // the levels below a
    sv = (sv & keep) | ((uint32_t)v << (sp - 1));
    sok = (sok & keep) | ((uint32_t)ok << (sp - 1));
  }
  const long long present = a.ptype == kI64 ? __ldg((const long long*)a.presence + g)
                                            : (long long)__ldg((const int32_t*)a.presence + g);
  a.out[g] = (uint8_t)((sv & sok & 1u) && present > 0);
}

GT_EXPORT int gt_having_mask(const HavingArgs* args, void* stream) {
  if (args->num_groups <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((args->num_groups + kThreads - 1) / kThreads);
  having_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
