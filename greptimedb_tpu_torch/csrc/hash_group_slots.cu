// K17 hash_group_slots: insert-or-find every active row's group id in a
// linear-probing slot table of H int64 keys, deterministically.
//
// Replaces greptimedb_tpu/ops/aggregate.py:118 `hash_group_slots` (B18),
// the hash strategy's group-id step (parallel/executor.py:299-312): the
// tile program threads one [H] table through every source of a query, so
// each gid gets one slot for the whole query, and the states reduce over
// [H] slot ids instead of the dense [G] space.
//
// The result must be the reference's table and slots bit for bit, so a
// slot depends only on the set of gids and the order of the sources, never
// on thread timing.  The reference's rounds are kept as they are; one round
// is three grid-wide launches:
//   1. claim: every active row does a 64-bit atomicMin of its gid into
//      claim[pos], pos = (h0 + probe) & (H - 1).  The minimum is the same
//      in any order, so the winner of a position is the smallest gid that
//      probes it this round (the reference's scatter-min);
//   2. land: where table[pos] is HASH_EMPTY and the position was claimed,
//      table[pos] = claim[pos].  Only claimed positions are visited (one
//      thread per active row; threads of one position store the same
//      value);
//   3. find: a row whose table[pos] holds its gid records slot = pos and
//      retires; every other row advances its probe.  The row also resets
//      claim[pos] for the next round (every claimer of pos is still active
//      here), and each block adds its count of rows still active to one
//      counter, which the host reads after the round.
// The host loop stops when no row is active or after min(2H, 1024) rounds;
// rows still active then keep slot H and are the overflow count.  Masked
// rows never probe and keep slot H.  Gids are >= 0 and below 2^62 (the
// planner's bound), and the claim is a signed minimum like the reference's.
//
// Hash: h0 = min(int32((uint64(gid) * 0x9E3779B97F4A7C15) >> (64 - bits)),
// H - 1), bits = max(bit_length(H) - 1, 1); the multiply wraps mod 2^64.
//
// Bound on the H100: bytes.  The work is the gids (8 B) and active flags
// (1 B) read, the slots (4 B) written, the table read and written; each
// round rereads the probe state (4 B) and gid of every row and touches one
// random 8-byte word per active row in the table and the claim array, so
// a round costs a few passes over the rows.  At load <= 0.5 a few rounds
// place every key.  The table updates in place (the reference returns a
// new array; the caller threads the same tensor).
#include "common.cuh"

constexpr long long kHashEmpty = -1;
constexpr long long kClaimNone = 0x7fffffffffffffffLL;
constexpr unsigned long long kHashMult = 0x9E3779B97F4A7C15ULL;

// Mirrored field for field by _HashArgs in ops/aggregate.py (ctypes).
struct HashArgs {
  int64_t n;
  int64_t h;
  long long* table;       // [h] keys, HASH_EMPTY where unoccupied (in place)
  const long long* gids;  // [n]
  const uint8_t* active;  // [n]
  int32_t* slots;         // [n] out: slot, or h for masked / unplaced rows
  int32_t* probe;         // [n] scratch: probe offset, -1 once retired
  long long* claim;       // [h] scratch: kClaimNone between rounds
  int32_t* n_active;      // [1] rows still active after the last round
  int32_t bits;
  int32_t reserved;
};

__device__ __forceinline__ int32_t probe_pos(const HashArgs& a, long long gid, int32_t p) {
  const unsigned long long x = (unsigned long long)gid * kHashMult;
  int32_t h0 = (int32_t)(x >> (64 - a.bits));  // the reference's astype(int32)
  const int32_t last = (int32_t)(a.h - 1);
  h0 = h0 < last ? h0 : last;
  return (h0 + p) & last;
}

__global__ void __launch_bounds__(256) hash_init_kernel(const HashArgs a) {
  const int64_t width = a.n > a.h ? a.n : a.h;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < width; i += stride) {
    if (i < a.n) {
      a.slots[i] = (int32_t)a.h;
      a.probe[i] = a.active[i] != 0 ? 0 : -1;
    }
    if (i < a.h) a.claim[i] = kClaimNone;
  }
}

__global__ void __launch_bounds__(256) hash_claim_kernel(const HashArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int32_t p = a.probe[i];
  if (p < 0) return;
  const long long gid = a.gids[i];
  atomicMin(a.claim + probe_pos(a, gid, p), gid);
}

__global__ void __launch_bounds__(256) hash_land_kernel(const HashArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int32_t p = a.probe[i];
  if (p < 0) return;
  const int32_t pos = probe_pos(a, a.gids[i], p);
  const long long c = a.claim[pos];
  if (c != kClaimNone && a.table[pos] == kHashEmpty) a.table[pos] = c;
}

__global__ void __launch_bounds__(256) hash_find_kernel(const HashArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int still = 0;
  if (i < a.n) {
    const int32_t p = a.probe[i];
    if (p >= 0) {
      const long long gid = a.gids[i];
      const int32_t pos = probe_pos(a, gid, p);
      a.claim[pos] = kClaimNone;
      if (a.table[pos] == gid) {
        a.slots[i] = pos;
        a.probe[i] = -1;
      } else {
        a.probe[i] = p + 1;
        still = 1;
      }
    }
  }
  const int c = __syncthreads_count(still);
  if (threadIdx.x == 0 && c != 0) atomicAdd(a.n_active, c);
}

GT_EXPORT int gt_hash_init(const HashArgs* args, void* stream) {
  const int64_t width = args->n > args->h ? args->n : args->h;
  if (width <= 0) return (int)cudaSuccess;
  int64_t blocks = (width + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 CTAs per SM
  hash_init_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// One probe round: claim, land, find.  The host reads n_active afterwards.
GT_EXPORT int gt_hash_round(const HashArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (args->n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((args->n + 255) / 256);
  hash_claim_kernel<<<blocks, 256, 0, s>>>(*args);
  hash_land_kernel<<<blocks, 256, 0, s>>>(*args);
  cudaError_t err = cudaMemsetAsync(args->n_active, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  hash_find_kernel<<<blocks, 256, 0, s>>>(*args);
  return (int)cudaGetLastError();
}
