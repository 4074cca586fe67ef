// K6 limb_segment_sums: multi-column segmented sum + count over the
// bfloat16 digit planes of K5, one CTA per 4096-row block.
//
// Replaces greptimedb_tpu/ops/aggregate.py:291 `limb_segment_sums` (B6):
// its layout guard (masked ids in range, span < 16), the one-hot bf16
// matmul of the fast branch with the f64 recombination and the windowed
// fold (:190 `windowed_slot_sum`), and the slow branch (the digits
// dequantized, then segment sums in row order).
//
// Bound on the H100: bytes.  Per row the id (4 B), the mask (1 B), the
// optional count indicators (1 B each) and 8 B of digits per column are
// read once; the [nb, C, 16] partials and [C, G] states are small.  The
// TPU formed per-(block, slot) digit sums as a bf16 one-hot matmul whose
// f32 accumulation is exact because every sum is an integer below 2^24.
// Here the same integers are formed directly: a warp owns 512 consecutive
// rows (lane l holds rows l, l + 32, ...), and per slot its rows touch
// adds the digits straight from their bf16 bits as f32 (each digit is an
// integer in [0, 255], every partial sum an integer below 2^24, so the
// adds are exact in any order); a fixed shuffle tree combines the lanes
// and the block adds its warps in warp order as integers.  The f64
// recombination -pres * 2^29 + sum_j P_j * 256^j is exact (integers below
// 2^53) and is multiplied by the block's scale, so every per-(block, slot)
// value is bit-identical to the reference's.
//
// One pass per block (`limb_partials_kernel`): the ids and the mask are
// loaded together, and the first column's digits as soon as they are in,
// before the guard is decided; a row's slot is 4 bits of a packed word and
// each column's digits stay as their raw 8 bytes until used; presence, the
// null-gated counts and the columns' digit sums share the staging buffer
// and its barriers (no separate counts stage).  Thread 0 writes the block's base and occupied
// slots, and the last CTA finishes the block layout (block_layout.cuh):
// the verdict word, written rather than ORed into, and the fold's keys.
// The fold (`limb_fold_kernel`, a thread per (plane, group), or a warp
// where the groups are few against the blocks) adds each group's blocks in
// BLOCK ORDER, as the reference's scatter does, with no sort: K6 equals
// its plain version and the reference byte for byte on every layout.
//
// The slow branch (the guard failed: the ids are not clustered) is one
// kernel behind K18's flag-reading sort of the ids: `limb_runs_kernel`, a
// warp per group over the group's run of rows in row order, each lane one
// output (a column's dequantized sum (q - 2^29) * s or its error bound
// s / 2, presence, or a null-gated count) added row after row, as the
// reference's and the plain version's segment sums add.  Both are
// launched behind the guard's word (Gate in common.cuh) with no host read,
// and both branches write the same output tensors.
//
// Determinism: no float atomics; every f64 sum is added in a fixed order
// (block order in the fold, row order in the runs), so the same bytes on
// every run.
#include "block_layout.cuh"

constexpr int kLimbQExp = 29;
constexpr int kWarps = kBlockThreads / 32;
constexpr int kMaxCols = 16;      // value columns a launch takes (and counted columns)
constexpr int kStageRows = 32;    // per-warp staging rows between two barriers
// Mirrored field for field by _LimbArgs in ops/aggregate.py (ctypes).
struct LimbArgs {
  int64_t n;
  const int32_t* gids;
  const uint8_t* mask;
  const uint2* limbs[kMaxCols];       // [nb * 4096] digit quads
  const double* scales[kMaxCols];     // [nb]
  const uint8_t* count01[kMaxCols];   // [n] indicators of the counted columns
  BlockLayout layout;
  int32_t* ppres;                     // [nb, 16]
  int32_t* pcnt;                      // [nb, Cc, 16]
  double* psum;                       // [nb, C, 16]
  double* perr;                       // [nb, C, 16]
  int32_t n_cols;
  int32_t n_counted;
};

// Mirrored field for field by _LimbFoldArgs in ops/aggregate.py (ctypes).
struct LimbFoldArgs {
  BlockLayout layout;
  const int32_t* ppres;
  const int32_t* pcnt;
  const double* psum;
  const double* perr;
  int32_t* presence;  // [G]
  int32_t* counts;    // [Cc, G]
  double* sums;       // [C, G]
  double* errs;       // [C, G]
  int32_t n_cols;
  int32_t n_counted;
  Gate gate;          // runs when the guard passed
};

// Mirrored field for field by _LimbRunsArgs in ops/aggregate.py (ctypes).
struct LimbRunsArgs {
  int64_t n;
  const int32_t* skeys;  // [n] K18's sorted ids (masked rows carry G)
  const int64_t* perm;   // [n] the row of each
  const uint2* limbs[kMaxCols];
  const double* scales[kMaxCols];
  const uint8_t* count01[kMaxCols];
  int32_t* presence;
  int32_t* counts;
  double* sums;
  double* errs;
  int32_t num_groups;
  int32_t n_cols;
  int32_t n_counted;
  int32_t reserved;
  Gate gate;             // runs when the guard failed
};

// The exact value of a bf16 digit (an integer in [0, 255]) as f32.
__device__ __forceinline__ float digit_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float digit_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// A row's q from its four digits (int32, as the plain version's _limb_q).
__device__ __forceinline__ int32_t limb_q(uint2 w) {
  return (int32_t)digit_lo(w.x) + ((int32_t)digit_hi(w.x) << 8) + ((int32_t)digit_lo(w.y) << 16) +
         ((int32_t)digit_hi(w.y) << 24);
}

__global__ void __launch_bounds__(kBlockThreads) limb_partials_kernel(const LimbArgs a) {
  const BlockLayout& L = a.layout;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * kBlockRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int32_t s_lo[kWarps], s_hi[kWarps], s_bad[kWarps], s_klo[kWarps], s_khi[kWarps];
  __shared__ uint32_t s_wocc[kWarps];
  __shared__ int32_t s_base, s_ok;
  __shared__ int32_t s_pres[kSpan];
  __shared__ int32_t w_int[kWarps][kStageRows][kSpan];

  const int64_t wrow0 = row0 + (int64_t)warp * 32 * kRowsPerThread + lane;
  int32_t id[kRowsPerThread];
  uint8_t mk[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = wrow0 + (int64_t)i * 32;
    const bool in = r < a.n;
    mk[i] = in ? a.mask[r] : (uint8_t)0;
    id[i] = in ? a.gids[r] : 0;
  }
  uint32_t live = 0u;
  int32_t lo = 0x7fffffff, hi = -1, bad = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (mk[i] != 0) {
      live |= 1u << i;
      lo = min(lo, id[i]);
      hi = max(hi, id[i]);
      bad |= (id[i] < 0 || id[i] >= L.num_groups) ? 1 : 0;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  bad = (int32_t)__reduce_or_sync(0xffffffffu, (unsigned)bad);
  uint64_t rel = 0ull;
  uint32_t wocc = 0u;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const uint32_t d = ((uint32_t)id[i] - (uint32_t)lo) & 15u;
    rel |= (uint64_t)d << (4 * i);
    if ((live >> i) & 1u) wocc |= 1u << d;
  }
  wocc = __reduce_or_sync(0xffffffffu, wocc);
  // the first column's digits go out before the guard is decided
  uint2 w[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    w[i] = ((live >> i) & 1u) ? a.limbs[0][wrow0 + (int64_t)i * 32] : make_uint2(0u, 0u);
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_bad[warp] = bad;
    s_wocc[warp] = wocc;
  }
  __syncthreads();
  bool failed = false;
  if (t == 0) {
    int32_t blo = s_lo[0], bhi = s_hi[0], bbad = s_bad[0];
    for (int v = 1; v < kWarps; ++v) {
      blo = min(blo, s_lo[v]);
      bhi = max(bhi, s_hi[v]);
      bbad |= s_bad[v];
    }
    const bool ok = ((int64_t)bhi - (int64_t)blo) < kSpan && !bbad;
    const int32_t base = min(blo, L.num_groups);
    uint32_t occ = 0u;
    if (ok) {
      for (int v = 0; v < kWarps; ++v) {
        if (s_hi[v] >= 0) occ |= s_wocc[v] << (s_lo[v] - base);
      }
    }
    L.base[b] = base;
    L.occ[b] = occ;
    s_base = base;
    s_ok = ok ? 1 : 0;
    failed = !ok;
  }
  finish_layout(L, failed);  // starts with a barrier: s_base, s_ok visible
  if (!s_ok) return;
  const int32_t base = s_base;
  const int woff = lo - base;
  const int klo = hi < 0 ? kSpan : woff;
  const int khi = hi < 0 ? -1 : hi - base;
  if (lane == 0) {
    s_klo[warp] = klo;
    s_khi[warp] = khi;
  }

  // Items in order: presence, the Cc counts (one staging row each), the C
  // columns (four: one per digit).  A chunk takes items while their rows
  // fit kStageRows, then one barrier and the chunk's combine.
  const int n_items = 1 + a.n_counted + a.n_cols;
  int item = 0;
  while (item < n_items) {
    int rows = 0, end = item;
    while (end < n_items) {
      const int need = end <= a.n_counted ? 1 : 4;
      if (rows + need > kStageRows) break;
      rows += need;
      ++end;
    }
    int row = 0;
    for (int it = item; it < end; ++it) {
      if (it <= a.n_counted) {
        // presence (it = 0) or the null-gated count of counted column it - 1
        uint32_t bits = live;
        if (it > 0) {
          const uint8_t* c01 = a.count01[it - 1];
          uint32_t cb = 0u;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const bool on = (live >> i) & 1u;
            cb |= ((on && c01[wrow0 + (int64_t)i * 32] != 0) ? 1u : 0u) << i;
          }
          bits = cb;
        }
        for (int j = klo; j <= khi; ++j) {  // warp-uniform
          const uint32_t rj = (uint32_t)(j - woff);
          int32_t cnt = 0;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            cnt += (((bits >> i) & 1u) && (uint32_t)((rel >> (4 * i)) & 15u) == rj) ? 1 : 0;
          }
          cnt = warp_sum_i(cnt);
          if (lane == 0) w_int[warp][row][j] = cnt;
        }
        row += 1;
        continue;
      }
      const int c = it - 1 - a.n_counted;
      if (c > 0) {
        const uint2* Lc = a.limbs[c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          w[i] = ((live >> i) & 1u) ? Lc[wrow0 + (int64_t)i * 32] : make_uint2(0u, 0u);
        }
      }
      for (int j = klo; j <= khi; ++j) {
        const uint32_t rj = (uint32_t)(j - woff);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (!((live >> i) & 1u) || (uint32_t)((rel >> (4 * i)) & 15u) != rj) continue;
          s0 += digit_lo(w[i].x);
          s1 += digit_hi(w[i].x);
          s2 += digit_lo(w[i].y);
          s3 += digit_hi(w[i].y);
        }
        s0 = warp_sum_f(s0);
        s1 = warp_sum_f(s1);
        s2 = warp_sum_f(s2);
        s3 = warp_sum_f(s3);
        if (lane == 0) {
          w_int[warp][row + 0][j] = (int32_t)s0;
          w_int[warp][row + 1][j] = (int32_t)s1;
          w_int[warp][row + 2][j] = (int32_t)s2;
          w_int[warp][row + 3][j] = (int32_t)s3;
        }
      }
      row += 4;
    }
    __syncthreads();
    // combine: one thread per (item of the chunk, slot), the warps in warp order
    for (int x = t; x < (end - item) * kSpan; x += kBlockThreads) {
      const int k = x / kSpan, j = x % kSpan, it = item + k;
      // the item's first staging row
      const int r0 = it <= a.n_counted ? it - item
                     : (item <= a.n_counted ? a.n_counted + 1 - item : 0) +
                           4 * (it - max(item, a.n_counted + 1));
      if (it <= a.n_counted) {
        int32_t cnt = 0;
        for (int v = 0; v < kWarps; ++v) {
          if (j >= s_klo[v] && j <= s_khi[v]) cnt += w_int[v][r0][j];
        }
        if (it == 0) {
          s_pres[j] = cnt;
          a.ppres[b * kSpan + j] = cnt;
        } else {
          a.pcnt[(b * a.n_counted + (it - 1)) * kSpan + j] = cnt;
        }
        continue;
      }
      const int c = it - 1 - a.n_counted;
      int32_t P[4] = {0, 0, 0, 0};
      int32_t pres_here = 0;
      for (int v = 0; v < kWarps; ++v) {
        if (j < s_klo[v] || j > s_khi[v]) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) P[q] += w_int[v][r0 + q][j];
        if (item == 0) pres_here += w_int[v][0][j];
      }
      // presence is this chunk's row 0 in the first chunk, else s_pres
      const double pres = (double)(item == 0 ? pres_here : s_pres[j]);
      double acc = -pres * (double)(1 << kLimbQExp);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc = __dadd_rn(acc, __dmul_rn((double)P[q], (double)(1 << (8 * q))));
      const double sc = a.scales[c][b];
      const int64_t off = (b * a.n_cols + c) * kSpan + j;
      a.psum[off] = __dmul_rn(acc, sc);
      a.perr[off] = __dmul_rn(pres, __dmul_rn(sc, 0.5));
    }
    __syncthreads();
    item = end;
  }
}

// grid (ceil(G / groups a CTA), planes): planes 0 presence, 1..Cc counts,
// then C sums, then C errs; a thread or a warp (fold_lanes) per (plane,
// group)
__global__ void __launch_bounds__(256) limb_fold_kernel(const LimbFoldArgs a) {
  if (gate_shut(a.gate)) return;
  const BlockLayout& L = a.layout;
  const int64_t G = L.num_groups;
  const int lanes = fold_lanes(L.nb, G);
  const int64_t g = (int64_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int64_t p = blockIdx.y;
  if (g >= G) return;  // uniform per warp when a warp folds a group
  const int lane = threadIdx.x & 31;
  if (p <= a.n_counted) {
    int32_t s = 0;
    const int32_t* src = p == 0 ? a.ppres : a.pcnt;
    const int64_t stride = p == 0 ? 1 : a.n_counted;
    const int64_t plane = p == 0 ? 0 : p - 1;
    auto load = [&](int64_t blk, int slot) { return src[(blk * stride + plane) * kSpan + slot]; };
    if (lanes == 1) {
      fold_blocks<4, int32_t>(L, g, load, [&](int32_t v) { s += v; });
    } else {
      fold_blocks_warp<int32_t>(L, g, lane, load,
                                [&](int32_t v, int l) { s += __shfl_sync(0xffffffffu, v, l); });
      if (lane != 0) return;
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
  auto load = [&](int64_t blk, int slot) { return src[(blk * a.n_cols + c) * kSpan + slot]; };
  if (lanes == 1) {
    fold_blocks<4, double>(L, g, load, [&](double v) { s += v; });
  } else {
    fold_blocks_warp<double>(L, g, lane, load,
                             [&](double v, int l) { s += __shfl_sync(0xffffffffu, v, l); });
    if (lane != 0) return;
  }
  (is_err ? a.errs : a.sums)[c * G + g] = s;
}

// Group g's run, by one warp: lane k adds output k (C dequantized sums,
// C error bounds, presence, Cc counts) over the run's rows in row order,
// kBatch rows at a time whose loads are all issued before the adds.
__device__ void limb_run(const LimbRunsArgs& a, int64_t g, int lane) {
  constexpr int kBatch = 16;
  const int64_t start = lower_bound_i32(a.skeys, a.n, g);
  const int64_t end = lower_bound_i32(a.skeys, a.n, g + 1);
  const int C = a.n_cols, n_out = 2 * C + 1 + a.n_counted;
  for (int k0 = 0; k0 < n_out; k0 += 32) {
    const int k = k0 + lane;
    const int c = k < C ? k : k - C;  // the column of a sum or an error bound
    double s = 0.0;
    int32_t cnt = 0;
    for (int64_t j0 = start; j0 < end; j0 += kBatch) {
      const int m = (int)min((int64_t)kBatch, end - j0);
      const int32_t mine = lane < m ? (int32_t)a.perm[j0 + lane] : 0;
      int32_t rows[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) rows[r] = __shfl_sync(0xffffffffu, mine, r);
      if (k < 2 * C) {
        double sc[kBatch];
        uint2 w[kBatch];
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          if (r < m) {
            sc[r] = a.scales[c][rows[r] / kBlockRows];
            if (k < C) w[r] = a.limbs[c][rows[r]];
          }
        }
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          if (r < m) {
            s += k < C ? __dmul_rn((double)(limb_q(w[r]) - (1 << kLimbQExp)), sc[r])
                       : __dmul_rn(sc[r], 0.5);
          }
        }
      } else if (k == 2 * C) {
        cnt += m;
      } else if (k < n_out) {
        const uint8_t* c01 = a.count01[k - 2 * C - 1];
        uint8_t b[kBatch];
#pragma unroll
        for (int r = 0; r < kBatch; ++r) b[r] = r < m ? c01[rows[r]] : (uint8_t)0;
#pragma unroll
        for (int r = 0; r < kBatch; ++r) cnt += b[r] != 0 ? 1 : 0;
      }
    }
    const int64_t G = a.num_groups;
    if (k < C) a.sums[k * G + g] = s;
    else if (k < 2 * C) a.errs[(k - C) * G + g] = s;
    else if (k == 2 * C) a.presence[g] = cnt;
    else if (k < n_out) a.counts[(k - 2 * C - 1) * G + g] = cnt;
  }
}

// The slow branch: a warp per group walks its run of K18's sorted rows, 16
// at a time (lane r fetches the r-th row's index, every lane gets all 16
// by shuffles); more than 32 outputs: lane k takes k, k + 32, ...
__global__ void __launch_bounds__(256) limb_runs_kernel(const LimbRunsArgs a) {
  if (gate_shut(a.gate)) return;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < a.num_groups;
       g += warps) {  // uniform per warp
    limb_run(a, g, threadIdx.x & 31);
  }
}

GT_EXPORT int gt_limb_partials(const LimbArgs* args, void* stream) {
  if (args->layout.nb <= 0 || args->n_cols <= 0 || args->n_cols > kMaxCols ||
      args->n_counted < 0 || args->n_counted > kMaxCols)
    return (int)cudaErrorInvalidValue;
  limb_partials_kernel<<<(unsigned)args->layout.nb, kBlockThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_limb_fold(const LimbFoldArgs* args, void* stream) {
  const int64_t G = args->layout.num_groups;
  if (G <= 0) return (int)cudaSuccess;
  const int64_t per_cta = 256 / fold_lanes(args->layout.nb, G);
  const dim3 grid((unsigned)((G + per_cta - 1) / per_cta),
                  (unsigned)(1 + args->n_counted + 2 * args->n_cols));
  limb_fold_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_limb_runs(const LimbRunsArgs* args, void* stream) {
  const int64_t threads = (int64_t)args->num_groups * 32;
  if (threads <= 0) return (int)cudaSuccess;
  if (args->n_cols <= 0 || args->n_cols > kMaxCols || args->n_counted < 0 ||
      args->n_counted > kMaxCols)
    return (int)cudaErrorInvalidValue;
  // a capped grid of warps striding over the groups: a launch whose gate
  // is shut costs one wave of empty CTAs
  const int64_t blocks = (threads + 255) / 256;
  limb_runs_kernel<<<(unsigned)(blocks < kCapBlocks ? blocks : kCapBlocks), 256, 0,
                     (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
