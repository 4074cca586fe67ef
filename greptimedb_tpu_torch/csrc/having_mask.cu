// K13 having_mask: SQL HAVING over finalized [G] group states, with
// Kleene three-valued logic, fused with the survivor gate:
//   out[g] = eval(tree)[g] is TRUE  and  presence[g] > 0     (uint8 [G])
//
// Replaces greptimedb_tpu/ops/aggregate.py:1076 `having_mask` (B9), which
// the reference ANDs into the survivor mask before its top-k
// (parallel/tile_cache.py:3070-3117 `_device_select`).
//
// The predicate tree is encoded on the host as a short postfix program
// (ops/aggregate.py `_having_program`) and uploaded with its reference
// table; one thread evaluates the program for one group on a small stack
// of (value, valid) bit pairs:
//   CMP    op, ref, slot   x(ref) <op> literal[slot]      valid = ref not NULL
//   CMPREF op, r1, r2      x(r1) <op> x(r2)                valid = neither NULL
//   ISNULL ref, negated    (ref is NULL) xor negated       always valid
//   NOT                    ~v, validity kept
//   AND / OR               Kleene: a definite FALSE (TRUE) side decides
// Comparisons run in f64 after converting the value as the reference's
// astype(float64) does, so a NaN compares false (and != true).  A ref is
// NULL where its count plane is 0 and, for a float output marked so,
// where the value is NaN (the host's NULL bucket).  A dim ref is the
// group's coordinate (gid / div) % card.  An unknown result drops the
// group, as SQL does.
//
// Bound on the H100: bytes (the [G] planes the refs name read once, one
// byte a group written); at the TSBS shapes (G of a few tens of
// thousands) the launch dominates.
#include "common.cuh"

constexpr int kMaxRefs = 16;
constexpr int kMaxCode = 64;
constexpr int kMaxStack = 16;

enum { kF64 = 0, kF32 = 1, kI32 = 2, kI64 = 3, kU8 = 4 };
enum { kCmp = 0, kCmpRef = 1, kIsNull = 2, kNot = 3, kAnd = 4, kOr = 5 };
enum { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

struct HavingRef {
  const void* values;  // [G], or nullptr for a dim ref
  const void* counts;  // [G] count plane (0 = NULL), or nullptr
  int32_t vtype;       // kF64 .. kU8
  int32_t ctype;       // kI32 or kI64
  int32_t nan_null;    // a NaN value is NULL
  int32_t reserved;
  int64_t div;         // dim ref: (gid / div) % card
  int64_t card;
};

struct HavingProgram {
  HavingRef refs[kMaxRefs];
  int32_t code[kMaxCode][4];  // op, a, b, c
  int32_t n_code;
  int32_t n_refs;
};

struct HavingArgs {
  const HavingProgram* prog;  // on the device
  const double* literals;     // [n] comparison literals by slot
  const void* presence;       // [G]
  int32_t ptype;              // kI32 or kI64
  int32_t reserved;
  uint8_t* out;               // [G]
  int64_t num_groups;
};

__device__ __forceinline__ double load_as_f64(const void* p, int type, int64_t g) {
  switch (type) {
    case kF64: return ((const double*)p)[g];
    case kF32: return (double)((const float*)p)[g];
    case kI32: return (double)((const int32_t*)p)[g];
    case kI64: return (double)((const long long*)p)[g];
    default: return (double)((const uint8_t*)p)[g];
  }
}

__device__ __forceinline__ long long load_int(const void* p, int type, int64_t g) {
  return type == kI64 ? ((const long long*)p)[g] : (long long)((const int32_t*)p)[g];
}

__device__ __forceinline__ void ref_value(const HavingRef& r, int64_t g, double& x, bool& null) {
  if (r.values == nullptr) {
    x = (double)((g / r.div) % r.card);
    null = false;
    return;
  }
  x = load_as_f64(r.values, r.vtype, g);
  null = r.counts != nullptr && load_int(r.counts, r.ctype, g) == 0;
  if (r.nan_null && x != x) null = true;
}

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

__global__ void having_kernel(const HavingArgs a) {
  __shared__ HavingProgram p;
  {
    const int words = (int)(sizeof(HavingProgram) / sizeof(int32_t));
    const int32_t* src = (const int32_t*)a.prog;
    int32_t* dst = (int32_t*)&p;
    for (int w = threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
  }
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.num_groups) return;
  bool sv[kMaxStack], sok[kMaxStack];
  int sp = 0;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const int32_t* ins = p.code[pc];
    switch (ins[0]) {
      case kCmp: {
        double x;
        bool xn;
        ref_value(p.refs[ins[2]], g, x, xn);
        sv[sp] = compare(ins[1], x, a.literals[ins[3]]);
        sok[sp] = !xn;
        ++sp;
        break;
      }
      case kCmpRef: {
        double x, y;
        bool xn, yn;
        ref_value(p.refs[ins[2]], g, x, xn);
        ref_value(p.refs[ins[3]], g, y, yn);
        sv[sp] = compare(ins[1], x, y);
        sok[sp] = !xn && !yn;
        ++sp;
        break;
      }
      case kIsNull: {
        double x;
        bool xn;
        ref_value(p.refs[ins[1]], g, x, xn);
        sv[sp] = ins[2] ? !xn : xn;
        sok[sp] = true;
        ++sp;
        break;
      }
      case kNot:
        sv[sp - 1] = !sv[sp - 1];
        break;
      default: {  // kAnd, kOr
        const bool bv = sv[sp - 1], bok = sok[sp - 1];
        const bool av = sv[sp - 2], aok = sok[sp - 2];
        --sp;
        if (ins[0] == kAnd) {
          sv[sp - 1] = av && bv;
          sok[sp - 1] = (aok && bok) || (aok && !av) || (bok && !bv);
        } else {
          sv[sp - 1] = av || bv;
          sok[sp - 1] = (aok && bok) || (aok && av) || (bok && bv);
        }
        break;
      }
    }
  }
  const bool present = load_int(a.presence, a.ptype, g) > 0;
  a.out[g] = (uint8_t)(sv[0] && sok[0] && present);
}

GT_EXPORT int gt_having_mask(const HavingArgs* args, void* stream) {
  if (args->num_groups <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((args->num_groups + 255) / 256);
  having_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
