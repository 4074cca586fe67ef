// K15 gather_planes: chunked planes through an int32 index, two modes.
//
// * gather (B13's time-major copies): out_p[i] = src_p[perm[i]] for every
//   plane p of one launch, sources and outputs chunked at the entry's
//   bounds, elements of 1, 4 or 8 bytes.  Replaces the
//   `jnp.concatenate(chunks)[perm]` of
//   greptimedb_tpu/parallel/tile_cache.py:2193 `ensure_time_major`.
// * remap (B12's dictionary repair): out[i] = take(table, codes[i],
//   mode="fill", fill_value=-1) over int32 code planes.  Replaces the
//   `jnp.take(pdev, c, mode="fill", fill_value=-1)` of
//   greptimedb_tpu/parallel/tile_cache.py:2146 `repair_super`.  JAX's
//   fill mode wraps a negative index in [-n, -1] (Python style) and fills
//   only outside [-n, n); this kernel does the same.
//
// Bound on the H100: bytes.  Remap reads the code and writes it (8 B a
// row) and the table once.  Gather reads perm (4 B a row) once for every
// plane of the launch and each plane's element twice (read, write).
//
// Both kernels walk tiles of rows that each lie in one chunk: the chunk
// of a row comes from the tile index (one 32-bit division a tile), never
// from a 64-bit division a row.  Remap runs a grid the card holds at once,
// each CTA striding over the tiles; it moves 16 codes a thread a tile in
// 16 B vectors (scalar where a chunk's tail or an unaligned chunk asks
// for it), the table staged in shared memory where it fits.  Gather reads
// perm[i] once a row and finds its source chunk by a shift (chunk_rows a
// power of two) or one 32-bit division, then moves that row of every
// plane of the launch, a thread keeping kGatherLoads loads in flight (R
// rows of its tile x P planes).  Its reads are scattered (the time-major
// perm walks the hosts at one timestamp), so what it moves comes from L2
// only while the sectors that neighbouring timestamps share stay there:
// a CTA a tile, which the card starts in index order, keeps the rows in
// flight to a narrow window of output rows, and each source load asks L2
// for the 128 B around it.  The descriptor (`GatherDesc`) goes to the
// kernel by value; planes whose chunk tables pass it are split into
// launches by the caller (ops/permute.py `gather_launch_plan`).
#include "common.cuh"

constexpr int kThreads = 256;

// ---- remap -----------------------------------------------------------------

// Mirrored field for field by _RemapArgs in ops/permute.py (ctypes).
struct RemapArgs {
  ChunkTable codes;      // int32
  ChunkTable dst;        // int32
  const int32_t* table;  // [n_table]
  int64_t n_table;
  int64_t n;
  int32_t vec;           // 1: every chunk pointer 16 B aligned
  int32_t reserved;
};

constexpr int kRemapSteps = 4;                          // 16 B vectors a thread a tile
constexpr int kRemapTile = kThreads * 4 * kRemapSteps;  // 4096 codes
constexpr int kSmemTable = 12288;                       // 48 KB of shared memory

__device__ __forceinline__ int32_t remap_one(int32_t c, const int32_t* tab, int32_t nt) {
  if (c < 0) c += nt;  // no overflow: nt < 2^31
  return (uint32_t)c < (uint32_t)nt ? tab[c] : -1;
}

__global__ void __launch_bounds__(kThreads) remap_kernel(const __grid_constant__ RemapArgs a,
                                                         uint32_t tiles_per_chunk,
                                                         uint32_t n_tiles, int staged) {
  extern __shared__ int32_t s_table[];
  const int32_t nt = (int32_t)a.n_table;
  const int32_t* tab = a.table;
  if (staged) {
    for (int i = threadIdx.x; i < nt; i += kThreads) s_table[i] = __ldg(a.table + i);
    __syncthreads();
    tab = s_table;
  }
  const uint32_t cr = (uint32_t)a.codes.chunk_rows;
  const int last = a.codes.n_chunks - 1;
  for (uint32_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const uint32_t c = tile / tiles_per_chunk;  // uniform per CTA
    const uint32_t rows = (int)c == last ? (uint32_t)(a.n - (int64_t)c * cr) : cr;
    const uint32_t off = (tile - c * tiles_per_chunk) * kRemapTile;
    const int32_t* src = (const int32_t*)a.codes.ptr[c];
    int32_t* dst = (int32_t*)a.dst.ptr[c];
    int32_t v[4 * kRemapSteps];
#pragma unroll
    for (int s = 0; s < kRemapSteps; ++s) {
      const uint32_t i = off + (uint32_t)(s * kThreads + threadIdx.x) * 4;
      if (a.vec && i + 4 <= rows) {
        const int4 q = __ldg((const int4*)(src + i));
        v[4 * s] = q.x;
        v[4 * s + 1] = q.y;
        v[4 * s + 2] = q.z;
        v[4 * s + 3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[4 * s + e] = i + e < rows ? __ldg(src + i + e) : 0;
      }
    }
#pragma unroll
    for (int s = 0; s < kRemapSteps; ++s) {
      const uint32_t i = off + (uint32_t)(s * kThreads + threadIdx.x) * 4;
      int4 q;
      q.x = remap_one(v[4 * s], tab, nt);
      q.y = remap_one(v[4 * s + 1], tab, nt);
      q.z = remap_one(v[4 * s + 2], tab, nt);
      q.w = remap_one(v[4 * s + 3], tab, nt);
      if (a.vec && i + 4 <= rows) {
        *(int4*)(dst + i) = q;
      } else {
        const int32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i + e < rows) dst[i + e] = w[e];
        }
      }
    }
  }
}

// ---- gather ----------------------------------------------------------------

// The descriptor's capacity: its size is what sm_90's kernel parameter
// space holds (32,764 bytes).  Mirrored by _GatherDesc in ops/permute.py.
constexpr int kGatherPtrs = 4080;

// The planes of a launch in element-size order: n8 planes of 8 B, then n4
// of 4 B, then n1 of 1 B.  Plane p's source chunks lie at ptrs[2 p nc +
// c] and its output chunks at ptrs[(2 p + 1) nc + c] (nc = n_chunks);
// sources and outputs are cut alike, every chunk but the last holding
// chunk_rows rows.
struct GatherDesc {
  int32_t desc_bytes;   // sizeof(GatherDesc) as the caller laid it out
  int32_t n8, n4, n1;
  int32_t n_chunks;
  int32_t chunk_shift;  // log2(chunk_rows) when it is a power of two, else -1
  uint32_t chunk_rows;
  uint32_t n;           // rows (< 2^31)
  const int32_t* perm;  // [n]
  const void* ptrs[kGatherPtrs];
};
static_assert(sizeof(GatherDesc) <= 32764, "K15's descriptor must fit the kernel parameters");

// The gather's tuning (tools/gather_variants.py times copies with these
// rewritten): kGatherCtas CTAs an SM (the register cap), a thread keeping
// kGatherLoads loads in flight, R rows of its tile x P planes at a time (R
// = kGatherLoads / planes, a power of two from 1 to 4; P = kGatherLoads /
// R).
constexpr int kGatherCtas = 4;
constexpr int kGatherLoads = 8;

// Source loads through the read-only path with L2 asked for the 128 B
// around the element: a source sector holds the rows of neighbouring
// timestamps of one host, which the next tiles read.
__device__ __forceinline__ unsigned long long load_src(const unsigned long long* p) {
  unsigned long long v;
  asm("ld.global.nc.L2::128B.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int load_src(const unsigned int* p) {
  unsigned int v;
  asm("ld.global.nc.L2::128B.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned char load_src(const unsigned char* p) {
  unsigned int v;
  asm("ld.global.nc.L2::128B.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return (unsigned char)v;
}

template <int R, int P, typename T>
__device__ __forceinline__ void move_planes(const GatherDesc& a, const void* const* s_src, int p0,
                                            int p1, const bool (&in)[R], const uint32_t (&sc)[R],
                                            const uint32_t (&so)[R], uint32_t dc,
                                            const uint32_t (&dof)[R]) {
  const int nc = a.n_chunks;
  for (int p = p0; p < p1; p += P) {  // uniform
    T v[P][R];
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (in[r] && p + k < p1) v[k][r] = load_src((const T*)s_src[(p + k) * nc + sc[r]] + so[r]);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (in[r] && p + k < p1) ((T*)a.ptrs[(2 * (p + k) + 1) * nc + dc])[dof[r]] = v[k][r];
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, kGatherCtas)
    gather_kernel(const __grid_constant__ GatherDesc a, uint32_t tiles_per_chunk) {
  constexpr int P = kGatherLoads / R;
  // each plane's source chunks: a lane indexes them by its own row's chunk
  extern __shared__ const void* s_src[];
  const int nc = a.n_chunks;
  const int n_planes = a.n8 + a.n4 + a.n1;
  for (int i = threadIdx.x; i < n_planes * nc; i += kThreads) {
    s_src[i] = a.ptrs[2 * (i / nc) * nc + i % nc];
  }
  __syncthreads();
  const uint32_t tile = blockIdx.x;
  const uint32_t dc = tile / tiles_per_chunk;  // uniform per CTA
  const uint32_t rows = (int)dc == nc - 1 ? a.n - dc * a.chunk_rows : a.chunk_rows;
  const uint32_t off = (tile - dc * tiles_per_chunk) * (kThreads * R) + threadIdx.x;
  bool in[R];
  uint32_t dof[R], src[R], sc[R], so[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dof[r] = off + r * kThreads;
    in[r] = dof[r] < rows;
    src[r] = in[r] ? (uint32_t)__ldg(a.perm + dc * a.chunk_rows + dof[r]) : 0u;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sc[r] = a.chunk_shift >= 0 ? src[r] >> a.chunk_shift : src[r] / a.chunk_rows;
    so[r] = src[r] - sc[r] * a.chunk_rows;
  }
  move_planes<R, P, unsigned long long>(a, s_src, 0, a.n8, in, sc, so, dc, dof);
  move_planes<R, P, unsigned int>(a, s_src, a.n8, a.n8 + a.n4, in, sc, so, dc, dof);
  move_planes<R, P, unsigned char>(a, s_src, a.n8 + a.n4, n_planes, in, sc, so, dc, dof);
}

// CTAs of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory each (the last answer kept per kernel and size).
template <typename K>
static int64_t resident_ctas(K kernel, size_t smem, size_t& last_smem, int64_t& last) {
  if (last == 0 || last_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    last = sms * per_sm > 0 ? (int64_t)sms * per_sm : 1;
    last_smem = smem;
  }
  return last;
}

template <int R>
static int launch_gather(const GatherDesc& a, int n_planes, cudaStream_t stream) {
  constexpr uint32_t kTile = kThreads * R;
  const uint32_t tpc = (a.chunk_rows + kTile - 1) / kTile;
  const uint32_t tail = a.n - (uint32_t)(a.n_chunks - 1) * a.chunk_rows;
  const uint32_t n_tiles = (uint32_t)(a.n_chunks - 1) * tpc + (tail + kTile - 1) / kTile;
  const size_t smem = (size_t)n_planes * a.n_chunks * sizeof(void*);
  gather_kernel<R><<<n_tiles, kThreads, smem, stream>>>(a, tpc);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_gather_planes(const GatherDesc* desc, void* stream) {
  const GatherDesc& a = *desc;
  const int n_planes = a.n8 + a.n4 + a.n1;
  if (a.desc_bytes != (int32_t)sizeof(GatherDesc) || a.n8 < 0 || a.n4 < 0 || a.n1 < 0 ||
      n_planes <= 0 || a.n_chunks <= 0 || 2 * n_planes * a.n_chunks > kGatherPtrs ||
      a.chunk_rows == 0 || a.n > 0x7fffffffu ||
      (a.chunk_shift >= 0 && (1u << a.chunk_shift) != a.chunk_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n == 0) return (int)cudaSuccess;
  // R rows a thread: kGatherLoads / planes, a power of two in [1, 4]
  const int per = kGatherLoads / (n_planes < kGatherLoads ? n_planes : kGatherLoads);
  const int rows_a_thread = per >= 4 ? 4 : per >= 2 ? 2 : 1;
  switch (rows_a_thread) {
    case 4: return launch_gather<(kGatherLoads >= 4 ? 4 : 1)>(a, n_planes, (cudaStream_t)stream);
    case 2: return launch_gather<(kGatherLoads >= 2 ? 2 : 1)>(a, n_planes, (cudaStream_t)stream);
    default: return launch_gather<1>(a, n_planes, (cudaStream_t)stream);
  }
}

GT_EXPORT int gt_remap_codes(const RemapArgs* args, void* stream) {
  const RemapArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  if (a.n > 0x7fffffffLL || a.n_table < 0 || a.n_table > 0x7fffffffLL || a.codes.chunk_rows <= 0 ||
      a.codes.chunk_rows > 0x7fffffffLL || a.codes.n_chunks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t cr = (uint32_t)a.codes.chunk_rows;
  const uint32_t tpc = (cr + kRemapTile - 1) / kRemapTile;
  const uint32_t tail = (uint32_t)(a.n - (int64_t)(a.codes.n_chunks - 1) * cr);
  const uint32_t n_tiles = (uint32_t)(a.codes.n_chunks - 1) * tpc + (tail + kRemapTile - 1) / kRemapTile;
  const int staged = a.n_table > 0 && a.n_table <= kSmemTable;
  const size_t smem = staged ? (size_t)a.n_table * sizeof(int32_t) : 0;
  static size_t last_smem = 0;
  static int64_t last = 0;
  const int64_t res = resident_ctas(remap_kernel, smem, last_smem, last);
  const int64_t grid = n_tiles < res ? n_tiles : res;
  remap_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(a, tpc, n_tiles, staged);
  return (int)cudaGetLastError();
}
