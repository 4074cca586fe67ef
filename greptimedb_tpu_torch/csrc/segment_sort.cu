// K18 segment_sort: the stable sort of a tile's masked group ids that K3
// and K4's sorted-run form reduce over,
//   key = where(mask & 0 <= gid < G, gid, G);  skeys, perm = sort(key, stable)
// -> sorted ids int32 [n] and the row of each int64 [n].
//
// Index plumbing of K3 (csrc/segment_reduce_scatter.cu), which replaces
// greptimedb_tpu/ops/aggregate.py:598 `_segment_scatter`: the reference's
// XLA segment_sum needs no sort, K3 reduces runs of equal ids instead, so
// the rows of one group must form one run, in row order.  Until now the
// port sorted with torch.sort, which cannot be told to skip; behind K2's
// and K6's layout guards this sort runs only on the card's verdict
// (Gate, common.cuh), so the choice between the blocked fold and K3 needs
// no host read and a CUDA graph can hold it.
//
// Design: the stable LSD radix passes of radix.cuh (shared with K14) over
// u64 keys, as many 8-bit passes as G + 1 needs (known from the plan, so
// the host reads nothing), then one pass that narrows the keys to int32
// and widens the indices to int64.  A stable sort's output is unique, so
// this is torch.sort(key, stable=True) exactly.
//
// Bound on the H100: bytes.  The least traffic is the ids (4 B) and mask
// (1 B) read and the sorted ids (4 B) and rows (8 B) written once, 17 B a
// row; each pass moves keys and indices in and out (24 B a row) plus a
// histogram read of the keys.
#include "radix.cuh"

// Mirrored field for field by _SortArgs in ops/aggregate.py (ctypes).
struct SortArgs {
  int64_t n;
  const int32_t* gids;   // [n]
  const uint8_t* mask;   // [n]
  u64* keys[2];          // [n] scratch, ping-pong
  int32_t* idx[2];       // [n] scratch, ping-pong
  int32_t* hist;         // [kRadix * n_tiles] scratch
  int32_t* seg_sums;     // scratch
  int32_t* skeys;        // [n] out: the sorted ids
  int64_t* perm;         // [n] out: the row of each
  int32_t num_groups;
  int32_t n_passes;      // 8-bit passes covering keys up to G
  Gate gate;             // behind a layout guard: runs when it failed
};

__global__ void __launch_bounds__(kThreads) sort_prepare_kernel(const SortArgs a) {
  if (gate_shut(a.gate)) return;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t g = a.gids[i];
    const bool in = a.mask[i] != 0 && g >= 0 && g < a.num_groups;
    a.keys[0][i] = (u64)(in ? g : a.num_groups);
    a.idx[0][i] = (int32_t)i;
  }
}

__global__ void __launch_bounds__(kThreads) sort_emit_kernel(const SortArgs a, const u64* keys,
                                                              const int32_t* idx) {
  if (gate_shut(a.gate)) return;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    a.skeys[i] = (int32_t)keys[i];
    a.perm[i] = (int64_t)idx[i];
  }
}

GT_EXPORT int gt_segment_sort(const SortArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const SortArgs& a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  sort_prepare_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a);
  // the last pass lands in the buffers the passes would use next
  const int fin = a.n_passes & 1;
  const RadixScratch r = {{a.keys[0], a.keys[1]}, {a.idx[0], a.idx[1]}, a.hist, a.seg_sums};
  cudaError_t err = radix_passes(r, a.n, a.n_passes, a.idx[fin], a.keys[fin], a.gate, s);
  if (err != cudaSuccess) return (int)err;
  sort_emit_kernel<<<grid_for(a.n, kThreads), kThreads, 0, s>>>(a, a.keys[fin], a.idx[fin]);
  return (int)cudaGetLastError();
}
