// K18 segment_sort: the stable sort of a tile's masked group ids that K3
// and K4's sorted-run form reduce over,
//   key = where(mask & 0 <= gid < G, gid, G);  skeys, perm = sort(key, stable)
// -> sorted ids int32 [n] and the row of each int64 [n].
//
// Index plumbing of K3 (csrc/segment_reduce_scatter.cu), which replaces
// greptimedb_tpu/ops/aggregate.py:598 `_segment_scatter`: the reference's
// XLA segment_sum needs no sort, K3 reduces runs of equal ids instead, so
// the rows of one group must form one run, in row order.  Behind K2's and
// K6's layout guards this sort runs only on the card's verdict (Gate,
// common.cuh), so the choice between the blocked fold and K3 needs no
// host read and a CUDA graph can hold it.
//
// Design: the one-sweep LSD radix sort of radix.cuh (shared with K14 and
// K19's large-k branch) over u32 keys, planned from G alone (ops/radix.py,
// so the host reads nothing): G + 1 keys up to 2^11 take one pass (G =
// 720: one 10-bit digit), 2^24 slots three.  The histogram kernel and the
// first pass compute the keys from the ids and the mask; the last pass
// writes the int32 ids and the int64 rows.  A stable sort's output is
// unique, so this is torch.sort(key, stable=True) exactly.
//
// Bound on the H100: bytes.  The least traffic is the ids (4 B) and mask
// (1 B) read and the sorted ids (4 B) and rows (8 B) written once, 17 B a
// row.  In one pass (G = 720) the kernels move about 25 B a row: the
// histogram reads the ids and mask (5 B) and zeroes the look-back words
// (1 B), the pass reads them again and writes the outputs (17 B), the
// look-back words about 2 B more (1024 digits a tile of 4096 rows).  Each
// further pass adds a u32 key and a row written and read (16 B).
#include "radix.cuh"

// Mirrored field for field by _SortArgs in ops/aggregate.py (ctypes).
struct SortArgs {
  int64_t n;
  const int32_t* gids;   // [n]
  const uint8_t* mask;   // [n]
  int32_t* skeys;        // [n] out: the sorted ids
  int64_t* perm;         // [n] out: the row of each
  int32_t num_groups;
  int32_t reserved;
  Gate gate;             // behind a layout guard: runs when it failed
  RadixPlan plan;        // from radix_plan(num_groups)
  RadixScratch scratch;
};

// The sort's source: key = mask & 0 <= gid < G ? gid : G, row = i.
struct SegmentSrc {
  const int32_t* gids;
  const uint8_t* mask;
  int32_t num_groups;

  __device__ __forceinline__ void load_items(int64_t base, int64_t n, uint32_t (&key)[kItems],
                                             int32_t (&row)[kItems]) const {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + (int64_t)k * 32;
      if (i < n) {
        const int32_t g = gids[i];
        const bool in = mask[i] != 0 && g >= 0 && g < num_groups;
        key[k] = (uint32_t)(in ? g : num_groups);
        row[k] = (int32_t)i;
      }
    }
  }
};

// The sort's sink: the id and the row, in the types K3 and K4 read.
struct SegmentDst {
  int32_t* skeys;
  int64_t* perm;
  __device__ __forceinline__ void put(int64_t pos, uint32_t key, int32_t row) const {
    skeys[pos] = (int32_t)key;
    perm[pos] = (int64_t)row;
  }
};

GT_EXPORT int gt_segment_sort(SortArgs* args, void* stream) {
  SortArgs& a = *args;
  const SegmentSrc src = {a.gids, a.mask, a.num_groups};
  const SegmentDst dst = {a.skeys, a.perm};
  return (int)onesweep_sort<uint32_t>(src, dst, a.n, a.plan, a.scratch, a.gate,
                                      (cudaStream_t)stream);
}
