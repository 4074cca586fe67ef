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
// is three grid-wide phases:
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
//      here), and each block adds its count of rows still active to the
//      round's counter.
// The reference loops rounds in a lax.while_loop on the device; here one
// cooperative launch (`gt_hash_rounds`) runs every round, a grid-wide
// sync between the phases, and stops when the round's counter is 0 or
// after min(2H, 1024) rounds, so no host reads a count between rounds and
// a CUDA graph can hold the call.  The counters rotate over three words:
// round r adds into word r % 3 and clears word (r + 1) % 3, which every
// thread last read two syncs earlier.  Rows still active at the end keep
// slot H and are the overflow count; the rounds run are written to a
// device word that the host reads after the query's readback.  Masked
// rows never probe and keep slot H.  Gids are >= 0 and below 2^62 (the
// planner's bound), and the claim is a signed minimum like the
// reference's.
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
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
  int32_t* state;         // [5]: rows still active after the last round,
                          // rounds run, three rotating round counters
  int32_t bits;
  int32_t max_rounds;     // min(2h, 1024)
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
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 < 5) a.state[t0] = 0;
  for (int64_t i = t0; i < width; i += stride) {
    if (i < a.n) {
      a.slots[i] = (int32_t)a.h;
      a.probe[i] = a.active[i] != 0 ? 0 : -1;
    }
    if (i < a.h) a.claim[i] = kClaimNone;
  }
}

__global__ void __launch_bounds__(256) hash_rounds_kernel(const HashArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t* counters = a.state + 2;
  int32_t rounds = 0, left = 0;
  while (rounds < a.max_rounds) {
    const int r3 = rounds % 3;
    // claim
    if (t0 == 0) counters[(r3 + 1) % 3] = 0;
    for (int64_t i = t0; i < a.n; i += stride) {
      const int32_t p = a.probe[i];
      if (p < 0) continue;
      const long long gid = a.gids[i];
      atomicMin(a.claim + probe_pos(a, gid, p), gid);
    }
    grid.sync();
    // land
    for (int64_t i = t0; i < a.n; i += stride) {
      const int32_t p = a.probe[i];
      if (p < 0) continue;
      const int32_t pos = probe_pos(a, a.gids[i], p);
      const long long c = a.claim[pos];
      if (c != kClaimNone && a.table[pos] == kHashEmpty) a.table[pos] = c;
    }
    grid.sync();
    // find
    int still = 0;
    for (int64_t i = t0; i < a.n; i += stride) {
      const int32_t p = a.probe[i];
      if (p < 0) continue;
      const long long gid = a.gids[i];
      const int32_t pos = probe_pos(a, gid, p);
      a.claim[pos] = kClaimNone;
      if (a.table[pos] == gid) {
        a.slots[i] = pos;
        a.probe[i] = -1;
      } else {
        a.probe[i] = p + 1;
        ++still;
      }
    }
    const int c = (int)__reduce_add_sync(0xffffffffu, (unsigned)still);
    if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(counters + r3, c);
    grid.sync();
    ++rounds;
    left = *(volatile int32_t*)(counters + r3);
    if (left == 0) break;  // the same value in every thread: a uniform exit
  }
  if (t0 == 0) {
    a.state[0] = left;
    a.state[1] = rounds;
  }
}

GT_EXPORT int gt_hash_init(const HashArgs* args, void* stream) {
  const int64_t width = args->n > args->h ? args->n : args->h;
  int64_t blocks = (width + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 CTAs per SM
  hash_init_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// Every probe round in one cooperative launch: the grid is at most the
// blocks that can be resident at once, so the grid-wide syncs cannot
// deadlock; rows are walked grid-stride.
GT_EXPORT int gt_hash_rounds(const HashArgs* args, void* stream) {
  if (args->n <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_rounds_kernel, 256, 0);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (args->n + 255) / 256;
  const int64_t resident = (int64_t)sms * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  HashArgs a = *args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)hash_rounds_kernel, dim3((unsigned)blocks),
                                    dim3(256), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
