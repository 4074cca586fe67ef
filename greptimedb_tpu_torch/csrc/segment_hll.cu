// K20 segment_hll: per-group HyperLogLog registers,
//   flat = int32(gids) * m + int32(reg_idx)      (wrapping int32)
//   regs = max(0, segment_max(rho, flat, num_segments = G * m))
// -> regs int32 [G * m] (the wrapper reshapes to [G, m]); flat ids below 0
// or at/after G * m are dropped, as JAX's segment ops drop them.
//
// Replaces greptimedb_tpu/ops/sketch.py:185 `segment_hll` (B21: one
// jax.ops.segment_max over flattened (gid, register) ids, clamped at 0).
//
// Int32 wrap.  The reference multiplies and adds in int32 two's
// complement, so an out-of-range gid can alias into a valid register and,
// with G * m >= 2^31, the last groups' rows wrap negative and are dropped.
// Signed overflow is undefined in C++, so the id is computed in uint32 and
// cast to int32, which is the two's complement wrap.
//
// Bound on the H100: bytes.  Each row reads reg_idx, rho and gids once
// (12 B) and the registers are written once (G * m * 4 B): 17.28 M rows
// and G = 4000, m = 4096 are 207 MB + 66 MB, 0.082 ms at 3.35 TB/s.  The
// operations (a multiply, an add, two compares) are far below 67 TOP/s.
//
// Design.  The wrapper zero-fills the registers (torch.zeros), which is
// the clamp at 0: a row whose rho is not above 0 changes nothing.  A
// grid-stride loop gives each thread one row at a time, coalesced; the
// thread reads the register through L2 first and calls atomicMax only
// where its rho is larger.  Registers only grow, so a stale read costs one
// extra atomic and never a wrong result.  Where many rows share a
// register (by hour, or every row on one register) most rows skip the
// atomic; at about one row per register (a host's 4320 rows over 4096)
// nearly every row still pays one, which is what keeps the kernel off its
// bound.  (A shared-memory window per tile of rows, and four rows in
// flight per thread with the read skipped where rows are fewer than
// registers, measured no better overall at these shapes: PERF.md §6.)
// A max is order free, so every run gives the same bytes.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;

// Mirrored field for field by _HllArgs in ops/sketch.py (ctypes).
struct HllArgs {
  int64_t n;            // rows
  int64_t total;        // G * m
  const int32_t* reg;   // [n] register index
  const int32_t* rho;   // [n]
  const int32_t* gids;  // [n]
  int32_t* regs;        // [total] out, zero-filled by the wrapper
  int32_t m;
  int32_t reserved;
};

__global__ void __launch_bounds__(kThreads) hll_kernel(HllArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const int32_t r = a.rho[i];
    if (r <= 0) continue;
    const int32_t flat = (int32_t)((uint32_t)a.gids[i] * (uint32_t)a.m + (uint32_t)a.reg[i]);
    if (flat < 0 || (int64_t)flat >= a.total) continue;
    int32_t* p = a.regs + flat;
    if (__ldcg(p) < r) atomicMax(p, r);
  }
}

GT_EXPORT int gt_segment_hll(const HllArgs* a, void* stream) {
  const int64_t want = (a->n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want < kSms * kBlocksPerSm ? want : kSms * kBlocksPerSm));
  hll_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
