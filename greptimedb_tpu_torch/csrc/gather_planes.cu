// K15 gather_planes: one chunked plane through an int32 index, two modes.
//
// * gather (B13's time-major copies): out[i] = src[perm[i]], src and out
//   chunked at the entry's bounds, elements of 1, 4 or 8 bytes.  Replaces
//   the `jnp.concatenate(chunks)[perm]` of
//   greptimedb_tpu/parallel/tile_cache.py:2161 `ensure_time_major`.
// * remap (B12's dictionary repair): out[i] = take(table, codes[i],
//   mode="fill", fill_value=-1) over int32 code planes.  Replaces the
//   `jnp.take(pdev, c, mode="fill", fill_value=-1)` of
//   greptimedb_tpu/parallel/tile_cache.py:2127 `repair_super`.  JAX's
//   fill mode wraps a negative index in [-n, -1] (Python style) and fills
//   only outside [-n, n); this kernel does the same.
//
// Bound on the H100: bytes.  Gather reads the index (4 B) and writes the
// element once a row; the source reads are random, one element each
// (a 32 B sector a row at worst).  Remap reads the code and writes it
// (8 B a row); the table (one entry per tag value) stays in L1/L2.  A
// grid-stride loop, one row a thread a step, consecutive threads on
// consecutive rows, so index reads and output writes are coalesced.
#include "common.cuh"

struct GatherArgs {
  ChunkTable src;
  ChunkTable dst;
  const int32_t* perm;  // [n]
  int64_t n;
  int32_t esize;        // 1, 4 or 8
  int32_t reserved;
};

struct RemapArgs {
  ChunkTable codes;     // int32
  ChunkTable dst;       // int32
  const int32_t* table; // [n_table]
  int64_t n_table;
  int64_t n;
};

template <typename T>
__global__ void gather_kernel(const GatherArgs a) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    chunk_store<T>(a.dst, i, chunk_load<T>(a.src, (int64_t)a.perm[i]));
  }
}

__global__ void remap_kernel(const RemapArgs a) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t c = chunk_load<int32_t>(a.codes, i);
    if (c < 0) c += a.n_table;
    chunk_store<int32_t>(a.dst, i, (c >= 0 && c < a.n_table) ? a.table[c] : -1);
  }
}

static int grid_for(int64_t n) {
  int64_t g = (n + 255) / 256;
  if (g > 132 * 32) g = 132 * 32;
  return g < 1 ? 1 : (int)g;
}

GT_EXPORT int gt_gather_plane(const GatherArgs* args, void* stream) {
  if (args->n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = grid_for(args->n);
  switch (args->esize) {
    case 1: gather_kernel<uint8_t><<<g, 256, 0, s>>>(*args); break;
    case 4: gather_kernel<uint32_t><<<g, 256, 0, s>>>(*args); break;
    case 8: gather_kernel<unsigned long long><<<g, 256, 0, s>>>(*args); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_remap_codes(const RemapArgs* args, void* stream) {
  if (args->n <= 0) return (int)cudaSuccess;
  remap_kernel<<<grid_for(args->n), 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
