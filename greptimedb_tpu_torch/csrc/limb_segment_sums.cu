// K6 limb_segment_sums: multi-column segmented sum + count over the
// bfloat16 digit planes of K5, one CTA per 4096-row block.
//
// Replaces greptimedb_tpu/ops/aggregate.py:291 `limb_segment_sums` (B6):
// its layout guard (masked ids in range, span < 16), the one-hot bf16
// matmul of the fast branch with the f64 recombination and the windowed
// fold (:190 `windowed_slot_sum`), and the dequantization of the slow
// branch (whose segment sums then run on K3).
//
// Bound on the H100: bytes.  Per row the id (4 B), the mask (1 B), the
// optional count indicators (1 B each) and 8 B of digits per column are
// read once; the [nb, C, 16] partials and [C, G] states are small.  The
// TPU formed per-(block, slot) digit sums as a bf16 one-hot matmul whose
// f32 accumulation is exact because every sum is an integer below 2^24.
// Here the same integers are formed directly: a warp owns 512 consecutive
// rows (lane l holds rows l, l + 32, ...), sums the digits of the slots
// its rows touch in int32, a fixed shuffle tree combines the lanes and
// the block adds its warps in warp order.  The f64 recombination
// -pres * 2^29 + sum_j P_j * 256^j is exact (integers below 2^53) and is
// multiplied by the block's scale, so every per-(block, slot) value is
// bit-identical to the reference's.  The fold adds the blocks covering a
// group in (base, block) order: no float atomics, the same bytes on every
// run.  A block failing the guard ORs the verdict and stops.  No host
// reads the verdict: the fold and the slow branch — dequantize the digits
// (`gt_limb_dequant`), sort the ids, aggregate the values on K3 — are all
// launched, each predicated on it (Gate in common.cuh), and both branches
// write the same output tensors.
#include "common.cuh"

constexpr int kLimbQExp = 29;
constexpr int kWarps = kBlockThreads / 32;
constexpr int kColChunk = 8;                  // value columns per barrier
constexpr int kCntChunk = 4 * kColChunk;      // count planes per barrier

struct LimbArgs {
  int64_t n;
  int64_t nb;
  const int32_t* gids;
  const uint8_t* mask;
  const uint2* const* limbs;      // device array [C] of [nb * 4096] digit quads
  const double* const* scales;    // device array [C] of [nb]
  const uint8_t* const* count01;  // device array [Cc] of [n] indicators
  int32_t* base_out;              // [nb]
  int32_t* verdict;               // [1]
  int32_t* ppres;                 // [nb, 16]
  int32_t* pcnt;                  // [nb, Cc, 16]
  double* psum;                   // [nb, C, 16]
  double* perr;                   // [nb, C, 16]
  int32_t num_groups;
  int32_t n_cols;
  int32_t n_counted;
  int32_t reserved;
};

struct LimbFoldArgs {
  const int32_t* sbase;  // [nb] sorted ascending
  const int64_t* order;  // [nb] block of each sorted base
  const int32_t* ppres;
  const int32_t* pcnt;
  const double* psum;
  const double* perr;
  int32_t* presence;  // [G]
  int32_t* counts;    // [Cc, G]
  double* sums;       // [C, G]
  double* errs;       // [C, G]
  int64_t nb;
  int32_t num_groups;
  int32_t n_cols;
  int32_t n_counted;
  int32_t reserved;
  Gate gate;          // runs when the guard passed
};

struct DequantArgs {
  int64_t n;
  const uint2* limbs;
  const double* scale;
  double* vhat;  // [n]: (q - 2^29) * scale
  double* half;  // [n]: scale / 2, or nullptr
  Gate gate;     // the slow branch: runs when the guard failed
};

__device__ __forceinline__ int32_t digit(uint32_t halfword) {
  return (int32_t)__uint_as_float(halfword << 16);
}

__global__ void __launch_bounds__(kBlockThreads) limb_partials_kernel(const LimbArgs a) {
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int32_t s_lo[kWarps], s_hi[kWarps], s_bad[kWarps], s_klo[kWarps], s_khi[kWarps];
  __shared__ int32_t s_base, s_ok;
  __shared__ int32_t s_pres[kSpan];
  __shared__ int32_t w_int[kWarps][kCntChunk][kSpan];

  const int64_t wrow0 = row0 + (int64_t)warp * 32 * kRowsPerThread + lane;
  int32_t k[kRowsPerThread];
  int32_t lo = 0x7fffffff, hi = -1, bad = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = wrow0 + (int64_t)i * 32;
    const bool m = r < a.n && a.mask[r] != 0;
    k[i] = m ? a.gids[r] : -1;
    if (m) {
      lo = min(lo, k[i]);
      hi = max(hi, k[i]);
      bad |= (k[i] < 0 || k[i] >= a.num_groups) ? 1 : 0;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  bad = (int32_t)__reduce_or_sync(0xffffffffu, (unsigned)bad);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (t == 0) {
    int32_t blo = s_lo[0], bhi = s_hi[0], bbad = s_bad[0];
    for (int w = 1; w < kWarps; ++w) {
      blo = min(blo, s_lo[w]);
      bhi = max(bhi, s_hi[w]);
      bbad |= s_bad[w];
    }
    const bool ok = ((int64_t)bhi - (int64_t)blo) < kSpan && !bbad;
    const int32_t base = min(blo, a.num_groups);
    a.base_out[b] = base;
    if (!ok) atomicOr(a.verdict, 1);
    s_base = base;
    s_ok = ok ? 1 : 0;
  }
  __syncthreads();
  if (!s_ok) return;
  const int32_t base = s_base;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) k[i] = k[i] >= 0 ? k[i] - base : -1;
  const int klo = hi < 0 ? kSpan : lo - base;
  const int khi = hi < 0 ? -1 : hi - base;
  if (lane == 0) {
    s_klo[warp] = klo;
    s_khi[warp] = khi;
  }

  // stage 1: presence (plane 0) and the null-gated counts, in chunks
  const int n_cnt = 1 + a.n_counted;
  for (int p0 = 0; p0 < n_cnt; p0 += kCntChunk) {
    const int pc = min(kCntChunk, n_cnt - p0);
    for (int pi = 0; pi < pc; ++pi) {
      const int p = p0 + pi;
      const uint8_t* c01 = p == 0 ? nullptr : a.count01[p - 1];
      int32_t kc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        kc[i] = (k[i] >= 0 && (c01 == nullptr || c01[wrow0 + (int64_t)i * 32] != 0)) ? k[i] : -1;
      }
      for (int j = klo; j <= khi; ++j) {  // warp-uniform
        int32_t cnt = 0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) cnt += kc[i] == j ? 1 : 0;
        cnt = warp_sum_i(cnt);
        if (lane == 0) w_int[warp][pi][j] = cnt;
      }
    }
    __syncthreads();
    // a chunk holds up to kCntChunk * kSpan = 512 (plane, slot) pairs: stride
    for (int x = t; x < pc * kSpan; x += kBlockThreads) {
      const int pi = x / kSpan, j = x % kSpan, p = p0 + pi;
      int32_t cnt = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (j >= s_klo[w] && j <= s_khi[w]) cnt += w_int[w][pi][j];
      }
      if (p == 0) {
        s_pres[j] = cnt;
        a.ppres[b * kSpan + j] = cnt;
      } else {
        a.pcnt[(b * a.n_counted + (p - 1)) * kSpan + j] = cnt;
      }
    }
    __syncthreads();
  }

  // stage 2: digit sums of up to 8 columns per chunk, then recombination
  for (int c0 = 0; c0 < a.n_cols; c0 += kColChunk) {
    const int cc = min(kColChunk, a.n_cols - c0);
    for (int ci = 0; ci < cc; ++ci) {
      const uint2* L = a.limbs[c0 + ci];
      int32_t d[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (k[i] >= 0) {
          const uint2 w = L[wrow0 + (int64_t)i * 32];
          d[i][0] = digit(w.x & 0xFFFFu);
          d[i][1] = digit(w.x >> 16);
          d[i][2] = digit(w.y & 0xFFFFu);
          d[i][3] = digit(w.y >> 16);
        } else {
          d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0;
        }
      }
      for (int j = klo; j <= khi; ++j) {
        int32_t s[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (k[i] != j) continue;
          s[0] += d[i][0];
          s[1] += d[i][1];
          s[2] += d[i][2];
          s[3] += d[i][3];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int32_t v = warp_sum_i(s[q]);
          if (lane == 0) w_int[warp][ci * 4 + q][j] = v;
        }
      }
    }
    __syncthreads();
    for (int x = t; x < cc * kSpan; x += kBlockThreads) {
      const int ci = x / kSpan, j = x % kSpan, c = c0 + ci;
      int32_t P[4] = {0, 0, 0, 0};
      for (int w = 0; w < kWarps; ++w) {
        if (j < s_klo[w] || j > s_khi[w]) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) P[q] += w_int[w][ci * 4 + q][j];
      }
      const double pres = (double)s_pres[j];
      double acc = -pres * (double)(1 << kLimbQExp);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc = __dadd_rn(acc, __dmul_rn((double)P[q], (double)(1 << (8 * q))));
      const double sc = a.scales[c][b];
      const int64_t off = (b * a.n_cols + c) * kSpan + j;
      a.psum[off] = __dmul_rn(acc, sc);
      a.perr[off] = __dmul_rn(pres, __dmul_rn(sc, 0.5));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256) limb_fold_kernel(const LimbFoldArgs a) {
  if (gate_shut(a.gate)) return;
  // planes: 0 presence, 1..Cc counts, then C sums, then C errs
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t G = a.num_groups;
  const int64_t n_planes = 1 + a.n_counted + 2 * (int64_t)a.n_cols;
  if (idx >= G * n_planes) return;
  const int64_t p = idx / G, g = idx % G;
  const int64_t lo = lower_bound_i32(a.sbase, a.nb, g - kSpan + 1);
  const int64_t hi = lower_bound_i32(a.sbase, a.nb, g + 1);
  if (p <= a.n_counted) {
    int32_t s = 0;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t slot = g - a.sbase[i];
      s += p == 0 ? a.ppres[a.order[i] * kSpan + slot]
                  : a.pcnt[(a.order[i] * a.n_counted + (p - 1)) * kSpan + slot];
    }
    if (p == 0) a.presence[g] = s;
    else a.counts[(p - 1) * G + g] = s;
    return;
  }
  const int64_t q = p - 1 - a.n_counted;
  const bool is_err = q >= a.n_cols;
  const int64_t c = is_err ? q - a.n_cols : q;
  const double* src = is_err ? a.perr : a.psum;
  double s = 0.0;
  for (int64_t i = lo; i < hi; ++i) {
    s += src[(a.order[i] * a.n_cols + c) * kSpan + (g - a.sbase[i])];
  }
  (is_err ? a.errs : a.sums)[c * G + g] = s;
}

// grid-stride over a capped grid: a launch whose gate is shut costs a few
// thousand empty blocks, not one per 256 rows
__global__ void __launch_bounds__(256) limb_dequant_kernel(const DequantArgs a) {
  if (gate_shut(a.gate)) return;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const uint2 w = a.limbs[r];
    const int32_t q = digit(w.x & 0xFFFFu) + (digit(w.x >> 16) << 8) +
                      (digit(w.y & 0xFFFFu) << 16) + (digit(w.y >> 16) << 24);
    const double sc = a.scale[r / kBlockRows];
    a.vhat[r] = __dmul_rn((double)(q - (1 << kLimbQExp)), sc);
    if (a.half != nullptr) a.half[r] = __dmul_rn(sc, 0.5);
  }
}

GT_EXPORT int gt_limb_partials(const LimbArgs* args, void* stream) {
  if (args->nb <= 0) return (int)cudaSuccess;
  limb_partials_kernel<<<(unsigned)args->nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_limb_fold(const LimbFoldArgs* args, void* stream) {
  const int64_t total = (int64_t)args->num_groups * (1 + args->n_counted + 2 * (int64_t)args->n_cols);
  if (total <= 0) return (int)cudaSuccess;
  limb_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_limb_dequant(const DequantArgs* args, void* stream) {
  if (args->n <= 0) return (int)cudaSuccess;
  int64_t blocks = (args->n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  limb_dequant_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
