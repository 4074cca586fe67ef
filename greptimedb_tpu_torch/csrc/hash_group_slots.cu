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
// on thread timing.  The reference's rounds are kept: in round r every row
// still active claims pos = (h0 + r) & (H - 1), the smallest gid claiming
// an empty position lands there (a scatter-min), the rows whose position
// then holds their gid are found, and the others advance one position.
//
// Claims in the table itself.  Gids are >= 0 and below 2^62 (the
// planner's bound) and HASH_EMPTY (-1) is the largest unsigned 64-bit
// value, so a row claims with an unsigned atomicMin(table + pos,
// 2^62 + gid), its tag.  On an empty position the smallest claiming tag
// stays; a landed gid is below every tag and stays.  After the claims,
// table[pos] decoded (w = t >= 2^62 ? t - 2^62 : t) is what the
// reference's table holds after its land step: the landed gid, or the
// smallest gid that claimed an empty position.  So in the same phase a row
// reads t = table[pos] and is found when w is its gid; a found row that
// read a tag stores w, and every writer of a position stores the same
// value, which every reader decodes alike.  Every tag's winner is active
// in its round and reads its own position there, so no tag outlives the
// round, and the next round's claims see only gids and HASH_EMPTY.  No
// claim array, no init of one and no reset: two grid-wide syncs a round.
//
// A worklist after the first round.  Round 0 reads gids and active
// directly (every active row's probe is 0), writes each row's slot once
// (its position, or H when masked or not found) and appends the rows not
// found, with their gids, to a list.  Round r walks only the list that
// round r - 1 wrote (every row on it has probe r) and appends to the
// other; the list's order does not matter, since a claim is a minimum and
// each row's find is its own.  A list's length is its counter, so the
// rounds stop when it is 0, or after min(2H, 1024) rounds; the rows still
// listed then keep slot H and are the overflow.  The round's length is
// read only after the sync that ends it, and a counter is zeroed by one
// thread a round before the sync after which it is written again (round
// r zeroes the list it appends to, which round r - 1 read).
//
// Warp-aggregated atomics.  Lanes with the same tag (runs of one gid:
// H1's rows are in (namespace, pod, container, ts) order, about ten a
// 5-minute gid) issue one atomicMin, from the lowest lane of the
// __match_any_sync group; a warp's appends are one atomicAdd.  A lane
// loads kAhead rows (their flags, then their gids, then their positions'
// words) before it claims or finds any, so a warp keeps kAhead loads in
// flight where one row at a time kept one.
//
// One cooperative launch (`gt_hash_slots`) runs every round, no host read
// between them, so a CUDA graph can hold the call.  The rows still active
// at the end and the rounds run are written to device words that the host
// reads after the query's readback; the rounds are 0 when no row is
// active, as the reference's loop runs none.  Masked rows never probe.
//
// Hash: h0 = min(int32((uint64(gid) * 0x9E3779B97F4A7C15) >> (64 - bits)),
// H - 1), bits = max(bit_length(H) - 1, 1); the multiply wraps mod 2^64.
//
// Bound on the H100: bytes.  The gids (8 B) and active flags (1 B) are
// read, the slots (4 B) written, the table read and written; round 0
// reads the rows twice (its claims, then its finds), later rounds only
// their lists, and each claim and find touches one random 8-byte word of
// the table.  The table updates in place (the reference returns a new
// array; the caller threads the same tensor).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr unsigned long long kTag = 1ULL << 62;
constexpr unsigned long long kHashMult = 0x9E3779B97F4A7C15ULL;
constexpr unsigned kFull = 0xffffffffu;

// Mirrored field for field by _HashArgs in ops/aggregate.py (ctypes).
struct HashArgs {
  int64_t n;
  int64_t h;
  unsigned long long* table;  // [h] keys, HASH_EMPTY where unoccupied (in place)
  const long long* gids;      // [n]
  const uint8_t* active;      // [n]
  int32_t* slots;             // [n] out: slot, or h for masked / unplaced rows
  int32_t* rows[2];           // two worklists of rows not yet found, [n] each
  long long* keys[2];         // their gids
  int32_t* state;             // [5]: rows still active after the last round,
                              // rounds run, the two lists' lengths, any row active
  int32_t bits;
  int32_t max_rounds;         // min(2h, 1024)
  int32_t kernels;            // out: the kernels this call launched (0 or 1)
};

// The kernel's arguments in registers: the helpers take this by value
// from locals, so no argument is read through a copy of the parameter
// block in local memory (a list picked by a runtime index would force one).
struct Probe {
  unsigned long long* table;
  int32_t last;  // h - 1
  int32_t shift;  // 64 - bits
};

__device__ __forceinline__ int32_t probe_pos(const Probe& q, long long gid, int32_t p) {
  const unsigned long long x = (unsigned long long)gid * kHashMult;
  int32_t h0 = (int32_t)(x >> q.shift);  // the reference's astype(int32)
  h0 = h0 < q.last ? h0 : q.last;
  return (h0 + p) & q.last;
}

// Rows a lane loads before it claims or finds any of them (each pass
// walks rows b + u * stride + lane, u < kAhead, of its warp's stride).
constexpr int kAhead = 4;

// One atomicMin per distinct tag among the warp's claiming lanes; every
// lane of the warp calls it.
__device__ __forceinline__ void claim(const Probe& q, bool act, long long gid, int32_t pos) {
  const unsigned am = __ballot_sync(kFull, act);
  if (!act) return;
  const unsigned long long tag = kTag + (unsigned long long)gid;
  const unsigned same = __match_any_sync(am, tag);
  const unsigned lower = same & ((1u << (threadIdx.x & 31)) - 1u);
  if (lower == 0) atomicMin(q.table + pos, tag);
}

// Whether the row of `gid` whose position read `t` is found: the
// position's winner decoded; a found row that read a tag writes the gid
// back.
__device__ __forceinline__ bool found_at(const Probe& q, unsigned long long t, long long gid,
                                         int32_t pos) {
  const unsigned long long w = t >= kTag ? t - kTag : t;
  if (w != (unsigned long long)gid) return false;
  if (t >= kTag) q.table[pos] = w;
  return true;
}

// Append the lanes with `p` set to a list (its rows, gids and length):
// one atomicAdd a warp; every lane of the warp calls it.
__device__ __forceinline__ void push(int32_t* rows, long long* keys, int32_t* len, bool p,
                                     int32_t row, long long gid) {
  const unsigned pm = __ballot_sync(kFull, p);
  if (pm == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(pm) - 1;
  int32_t base = 0;
  if (lane == leader) base = atomicAdd(len, __popc(pm));
  base = __shfl_sync(kFull, base, leader);
  if (p) {
    const int32_t at = base + __popc(pm & ((1u << lane) - 1u));
    rows[at] = row;
    keys[at] = gid;
  }
}

__global__ void __launch_bounds__(256) hash_slots_kernel(const HashArgs a) {
  cg::grid_group grid = cg::this_grid();
  const Probe q = {a.table, (int32_t)(a.h - 1), 64 - a.bits};
  const int64_t n = a.n;
  const int32_t h = (int32_t)a.h;
  const long long* gids = a.gids;
  const uint8_t* active = a.active;
  int32_t* slots = a.slots;
  int32_t* const rows0 = a.rows[0];
  int32_t* const rows1 = a.rows[1];
  long long* const keys0 = a.keys[0];
  long long* const keys1 = a.keys[1];
  int32_t* const state = a.state;
  const int32_t max_rounds = a.max_rounds;
  const int lane = threadIdx.x & 31;
  const bool first_thread = blockIdx.x == 0 && threadIdx.x == 0;
  // warp-uniform loops: every lane takes part in the votes and shuffles
  const int64_t w0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (first_thread) {
    state[2] = 0;
    state[4] = 0;
  }
  // round 0: every active row at its home position
  for (int64_t b = w0; b < n; b += kAhead * stride) {
    bool act[kAhead];
    long long gid[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = b + u * stride + lane;
      act[u] = i < n && active[i] != 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) gid[u] = act[u] ? gids[b + u * stride + lane] : 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) claim(q, act[u], gid[u], act[u] ? probe_pos(q, gid[u], 0) : 0);
  }
  grid.sync();
  bool any = false;
  for (int64_t b = w0; b < n; b += kAhead * stride) {
    bool act[kAhead];
    long long gid[kAhead];
    int32_t pos[kAhead];
    unsigned long long t[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = b + u * stride + lane;
      act[u] = i < n && active[i] != 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      gid[u] = act[u] ? gids[b + u * stride + lane] : 0;
      pos[u] = act[u] ? probe_pos(q, gid[u], 0) : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) t[u] = act[u] ? __ldcg(q.table + pos[u]) : 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = b + u * stride + lane;
      const bool found = act[u] && found_at(q, t[u], gid[u], pos[u]);
      if (i < n) slots[i] = found ? pos[u] : h;
      push(rows0, keys0, state + 2, act[u] && !found, (int32_t)i, gid[u]);
      any = any || act[u];
    }
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) state[4] = 1;
  grid.sync();
  int32_t rounds = 1;
  int32_t left = *(volatile int32_t*)(state + 2);
  while (left != 0 && rounds < max_rounds) {  // the same values in every thread
    // round r reads the list round r - 1 wrote and appends to the other
    const bool odd = rounds & 1;
    const int32_t* src_rows = odd ? rows0 : rows1;
    const long long* src_keys = odd ? keys0 : keys1;
    int32_t* dst_rows = odd ? rows1 : rows0;
    long long* dst_keys = odd ? keys1 : keys0;
    int32_t* dst_len = state + (odd ? 3 : 2);
    if (first_thread) *dst_len = 0;
    for (int64_t b = w0; b < left; b += kAhead * stride) {
      bool act[kAhead];
      long long gid[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t j = b + u * stride + lane;
        act[u] = j < left;
        gid[u] = act[u] ? __ldcg(src_keys + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        claim(q, act[u], gid[u], act[u] ? probe_pos(q, gid[u], rounds) : 0);
    }
    grid.sync();
    for (int64_t b = w0; b < left; b += kAhead * stride) {
      bool act[kAhead];
      long long gid[kAhead];
      int32_t pos[kAhead], row[kAhead];
      unsigned long long t[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t j = b + u * stride + lane;
        act[u] = j < left;
        row[u] = act[u] ? __ldcg(src_rows + j) : 0;
        gid[u] = act[u] ? __ldcg(src_keys + j) : 0;
        pos[u] = act[u] ? probe_pos(q, gid[u], rounds) : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) t[u] = act[u] ? __ldcg(q.table + pos[u]) : 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool found = act[u] && found_at(q, t[u], gid[u], pos[u]);
        if (found) slots[row[u]] = pos[u];
        push(dst_rows, dst_keys, dst_len, act[u] && !found, row[u], gid[u]);
      }
    }
    grid.sync();
    ++rounds;
    left = *(volatile int32_t*)dst_len;
  }
  if (first_thread) {
    state[0] = left;
    state[1] = *(volatile int32_t*)(state + 4) != 0 ? rounds : 0;
  }
}

// The SM count and the resident CTAs an SM of each device, asked once.
constexpr int kMaxDevices = 64;
static int g_resident[kMaxDevices];

// Every probe round in one cooperative launch: the grid is at most the
// blocks that can be resident at once, so the grid-wide syncs cannot
// deadlock; rows are walked grid-stride.
GT_EXPORT int gt_hash_slots(HashArgs* args, void* stream) {
  args->kernels = 0;
  if (args->n <= 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int resident = g_resident[dev];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_slots_kernel, 256, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
    g_resident[dev] = resident;
  }
  int64_t blocks = (args->n + 255) / 256;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  HashArgs a = *args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)hash_slots_kernel, dim3((unsigned)blocks),
                                    dim3(256), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  args->kernels = 1;
  return (int)cudaGetLastError();
}
