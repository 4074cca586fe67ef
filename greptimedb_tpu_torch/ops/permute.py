"""Row permutations of the tile cache's planes: kernels K14-K16.

Counterpart of the device halves of the reference's plane maintenance in
`greptimedb_tpu/parallel/tile_cache.py`: the ts-ascending permutation of
a super-tile (`ensure_perm`), its time-major copies (`ensure_time_major`),
the dictionary-growth repair of the tag code planes (`repair_super`) and
the patch that merges a flushed delta into resident planes
(`_delta_patch`).  Each wrapper launches its hand-written CUDA kernel for
CUDA tensors and runs its plain torch version for CPU tensors; there is
no fallback from one to the other.

* K14 `ts_argsort` (csrc/ts_argsort.cu): the stable argsort of
  `where(valid, ts, INT64_MAX)` over a chunked entry, int32 [pad];
* K15 `gather_planes` (csrc/gather_planes.cu): chunked planes gathered
  through that permutation, all the planes of a time-major build in one
  launch (`gather_planes_multi`; gather mode), or an int32 code plane
  mapped through a dictionary permutation with JAX's `take(mode="fill",
  fill_value=-1)` semantics (remap mode);
* K16 `delta_patch` (csrc/delta_patch.cu): old rows and a sorted delta
  run merged into new padded chunks by the merge positions.

Planes are lists of chunk tensors cut at uniform bounds (every chunk but
the last has the first chunk's length), as `ops/tiles.py::chunk_bounds`
cuts them.  Each wrapper's `.launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .radix import _RadixPlan, _RadixScratch, plan_struct, radix_plan, radix_scratch, sort_record
from .tiles import chunk_bounds

INT64_MAX = (1 << 63) - 1
_MAX_CHUNKS = 64


class _ChunkTable(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p * _MAX_CHUNKS), ("chunk_rows", ctypes.c_int64),
        ("n_chunks", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


def _rows(chunks) -> int:
    return sum(int(c.shape[0]) for c in chunks)


def _chunk_table(chunks, dtype, dev) -> _ChunkTable:
    """The kernel's view of a chunked plane; raises on what the kernel
    does not take (another device or dtype, a non-contiguous chunk,
    uneven bounds, too many chunks)."""
    if not chunks or len(chunks) > _MAX_CHUNKS:
        raise ValueError(f"a chunked plane needs 1..{_MAX_CHUNKS} chunks, got {len(chunks)}")
    first = int(chunks[0].shape[0])
    for i, c in enumerate(chunks):
        if c.device != dev or c.dtype != dtype or c.dim() != 1 or not c.is_contiguous():
            raise ValueError(
                f"chunk {i} must be a contiguous 1-d {dtype} tensor on {dev}; got "
                f"{c.dtype} {tuple(c.shape)} on {c.device}"
            )
        n = int(c.shape[0])
        if (i < len(chunks) - 1 and n != first) or n > first:
            raise ValueError("chunks must share the first chunk's length (the last may be shorter)")
    t = _ChunkTable()
    for i, c in enumerate(chunks):
        t.ptr[i] = c.data_ptr()
    t.chunk_rows = max(first, 1)
    t.n_chunks = len(chunks)
    return t


def _split_like(full: torch.Tensor, like) -> list:
    out, o = [], 0
    for c in like:
        n = int(c.shape[0])
        out.append(full[o:o + n].clone())
        o += n
    return out


def _empty_like_chunks(chunks, dtype, dev) -> list:
    return [torch.empty(int(c.shape[0]), dtype=dtype, device=dev) for c in chunks]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---- K14: the stable ts argsort ----------------------------------------------------


def ts_argsort_plain(ts_chunks, valid_chunks) -> torch.Tensor:
    """Torch-op version of K14: a stable argsort of the padded key."""
    key = torch.where(torch.cat(valid_chunks), torch.cat(ts_chunks), INT64_MAX)
    return torch.sort(key, stable=True).indices.to(torch.int32)


class _RangeArgs(ctypes.Structure):
    # mirrored field for field by RangeArgs in csrc/ts_argsort.cu
    _fields_ = [
        ("ts", _ChunkTable), ("valid", _ChunkTable), ("n", ctypes.c_int64),
        ("range", ctypes.c_void_p), ("kernels", ctypes.c_int32),
    ]


class _ArgsortArgs(ctypes.Structure):
    # mirrored field for field by ArgsortArgs in csrc/ts_argsort.cu
    _fields_ = [
        ("ts", _ChunkTable), ("valid", _ChunkTable), ("n", ctypes.c_int64),
        ("out", ctypes.c_void_p), ("lo", ctypes.c_int64), ("fill", ctypes.c_uint64),
        ("plan", _RadixPlan), ("scratch", _RadixScratch),
    ]


def argsort_keys(lo: int, hi: int) -> tuple[int, int]:
    """K14's key from the min and max of the valid ts (lo > hi when no row
    is valid): (offset, fill), key = ts - offset for a valid row and fill
    for an invalid one.  The fill sorts after every valid key, as INT64_MAX
    does in the reference, and ties with real rows at INT64_MAX.  The fill
    is also the largest key, which plans the sort."""
    if lo > hi:  # no valid row: every key is INT64_MAX
        return 0, 0
    return lo, hi - lo if hi == INT64_MAX else hi - lo + 1


def ts_argsort(ts_chunks, valid_chunks) -> torch.Tensor:
    """K14: int32 [n] ts-ascending permutation of a chunked entry (n = its
    padded rows), stable, with invalid rows after every valid one — the
    reference's `jnp.argsort(jnp.where(valid, ts, INT64_MAX))`.  CUDA
    chunks launch csrc/ts_argsort.cu (one range pass, whose min and max
    the host reads to plan the one-sweep radix sort, then the sort; what
    it ran lands in `ts_argsort.last_sort`); CPU chunks run
    `ts_argsort_plain`."""
    if ts_chunks[0].device.type == "cpu":
        return ts_argsort_plain(ts_chunks, valid_chunks)
    from ..kernels._build import launch

    dev = ts_chunks[0].device
    n = _rows(ts_chunks)
    if _rows(valid_chunks) != n:
        raise ValueError("ts and valid planes differ in rows")
    if n >= 1 << 31:
        raise ValueError(f"ts_argsort takes fewer than 2^31 rows, got {n}")
    ts_t = _chunk_table(ts_chunks, torch.int64, dev)
    valid_t = _chunk_table(valid_chunks, torch.bool, dev)
    stream = _stream(dev)
    rng = torch.empty(2, dtype=torch.int64, device=dev)
    ts_argsort.launches += 1
    ra = _RangeArgs(ts_t, valid_t, n, rng.data_ptr(), 0)
    launch("ts_argsort", "gt_argsort_range", ra, stream)
    lo, fill = argsort_keys(*(int(v) for v in rng.cpu()))
    plan = radix_plan(fill)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    keep, scratch = radix_scratch(n, plan, dev)
    a = _ArgsortArgs(ts_t, valid_t, n, out.data_ptr(), lo, fill, plan_struct(plan), scratch)
    launch("ts_argsort", "gt_argsort_passes", a, stream)
    ts_argsort.last_sort = sort_record(plan, ra.kernels + a.scratch.kernels)
    # the scratch is freed into the caching allocator and reused only by
    # work queued after these launches on the same stream
    del keep
    return out


ts_argsort.launches = 0
ts_argsort.last_sort = None


# ---- K15: gather / remap ---------------------------------------------------------


def gather_planes_plain(chunks, index: torch.Tensor, remap: bool = False) -> list:
    """Torch-op version of K15.  Gather: the concatenated plane indexed by
    `index` (the permutation, one entry per row), cut like `chunks`.
    Remap: `take(index, code, mode="fill", fill_value=-1)` of each code,
    a negative code in [-n, -1] counting from the end as JAX does."""
    if not remap:
        return _split_like(torch.cat(chunks)[index.to(torch.int64)], chunks)
    n = int(index.shape[0])
    out = []
    for c in chunks:
        i = c.to(torch.int64)
        i = torch.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        safe = torch.clamp(i, 0, max(n - 1, 0))
        picked = index[safe] if n else torch.zeros_like(c)
        out.append(torch.where(ok, picked, -1).to(torch.int32))
    return out


def gather_planes_multi_plain(planes, perm: torch.Tensor) -> list:
    """Torch-op version of K15's multi-plane gather: each plane through
    `gather_planes_plain`."""
    return [gather_planes_plain(p, perm) for p in planes]


# K15's gather descriptor (GatherDesc in csrc/gather_planes.cu): its
# pointers, two per chunk of each plane of a launch, fill sm_90's kernel
# parameter space
_GATHER_PTRS = 4080


class _GatherDesc(ctypes.Structure):
    # mirrored field for field by GatherDesc in csrc/gather_planes.cu
    _fields_ = [
        ("desc_bytes", ctypes.c_int32), ("n8", ctypes.c_int32), ("n4", ctypes.c_int32),
        ("n1", ctypes.c_int32), ("n_chunks", ctypes.c_int32), ("chunk_shift", ctypes.c_int32),
        ("chunk_rows", ctypes.c_uint32), ("n", ctypes.c_uint32), ("perm", ctypes.c_void_p),
        ("ptrs", ctypes.c_void_p * _GATHER_PTRS),
    ]


class _RemapArgs(ctypes.Structure):
    # mirrored field for field by RemapArgs in csrc/gather_planes.cu
    _fields_ = [
        ("codes", _ChunkTable), ("dst", _ChunkTable), ("table", ctypes.c_void_p),
        ("n_table", ctypes.c_int64), ("n", ctypes.c_int64), ("vec", ctypes.c_int32),
        ("reserved", ctypes.c_int32),
    ]


def gather_launch_plan(n_planes: int, n_chunks: int) -> list[list[int]]:
    """K15's gather launches for `n_planes` planes of `n_chunks` chunks
    each (a pure function of the shape): consecutive runs of plane
    indices, each as many planes as the descriptor's pointers hold (two a
    chunk of each plane: at 64 chunks, 31 planes a launch)."""
    per = _GATHER_PTRS // (2 * max(int(n_chunks), 1))
    return [list(range(o, min(o + per, n_planes))) for o in range(0, n_planes, per)]


def _gather_on_card(planes, outs, perm: torch.Tensor, dev) -> None:
    """The launches of `gather_launch_plan` for planes already checked
    (cut alike, elements of 1, 4 or 8 bytes) into their outputs `outs`."""
    from ..kernels._build import launch

    nc = len(planes[0])
    rows = int(planes[0][0].shape[0])
    chunk_rows = max(rows, 1)
    n = _rows(planes[0])
    stream = _stream(dev)
    for units in gather_launch_plan(len(planes), nc):
        # the descriptor holds the 8 B planes first, then the 4 B, then the 1 B
        order = sorted(units, key=lambda p: -planes[p][0].element_size())
        d = _GatherDesc()
        d.desc_bytes = ctypes.sizeof(_GatherDesc)
        sizes = [planes[p][0].element_size() for p in order]
        d.n8, d.n4, d.n1 = sizes.count(8), sizes.count(4), sizes.count(1)
        d.n_chunks = nc
        d.chunk_shift = chunk_rows.bit_length() - 1 if chunk_rows & (chunk_rows - 1) == 0 else -1
        d.chunk_rows = chunk_rows
        d.n = n
        d.perm = perm.data_ptr()
        for slot, p in enumerate(order):
            for c in range(nc):
                d.ptrs[2 * slot * nc + c] = planes[p][c].data_ptr()
                d.ptrs[(2 * slot + 1) * nc + c] = outs[p][c].data_ptr()
        gather_planes.launches += 1
        launch("gather_planes", "gt_gather_planes", d, stream)


def gather_planes_multi(planes, perm: torch.Tensor) -> list:
    """K15's gather mode over several planes at once: for each chunked
    plane (elements of 1, 4 or 8 bytes; every plane cut like the first)
    a new plane cut alike, row i being row perm[i] of the concatenated
    plane (`perm` int32, one entry per row, n < 2^31).  CUDA planes take
    one launch of csrc/gather_planes.cu for all of them, or as many as
    `gather_launch_plan` says where their chunk tables pass the
    descriptor; CPU planes run `gather_planes_multi_plain`."""
    if not planes:
        return []
    if planes[0][0].device.type == "cpu":
        return gather_planes_multi_plain(planes, perm)
    dev = planes[0][0].device
    lens = [int(c.shape[0]) for c in planes[0]]
    n = sum(lens)
    if not lens or len(lens) > _MAX_CHUNKS:
        raise ValueError(f"a chunked plane needs 1..{_MAX_CHUNKS} chunks, got {len(lens)}")
    if any(x != lens[0] for x in lens[:-1]) or lens[-1] > lens[0]:
        raise ValueError("chunks must share the first chunk's length (the last may be shorter)")
    if n >= 1 << 31:
        raise ValueError(f"gather_planes takes fewer than 2^31 rows, got {n}")
    if perm.device != dev or perm.dtype != torch.int32 or not perm.is_contiguous() \
            or tuple(perm.shape) != (n,):
        raise ValueError(f"gather_planes index must be a contiguous int32 [{n}] on {dev}")
    for i, plane in enumerate(planes):
        dtype = plane[0].dtype
        if plane[0].element_size() not in (1, 4, 8):
            raise ValueError(f"gather_planes takes 1, 4 or 8 byte elements, got {dtype}")
        if [int(c.shape[0]) for c in plane] != lens or any(
                c.device != dev or c.dtype != dtype or c.dim() != 1 or not c.is_contiguous()
                for c in plane):
            raise ValueError(f"plane {i} must be cut like the first, in contiguous 1-d {dtype} "
                             f"chunks on {dev}")
    outs = [_empty_like_chunks(p, p[0].dtype, dev) for p in planes]
    _gather_on_card(planes, outs, perm, dev)
    return outs


def gather_planes(chunks, index: torch.Tensor, remap: bool = False) -> list:
    """K15: a new chunked plane cut like `chunks`.  Gather mode (B13):
    row i is row index[i] of the concatenated plane (elements of 1, 4 or
    8 bytes; `index` int32, one entry per row): the one-plane case of
    `gather_planes_multi`.  Remap mode (B12): an int32 code plane mapped
    through the int32 table `index` with JAX's fill semantics.  CUDA
    chunks launch csrc/gather_planes.cu once; CPU chunks run
    `gather_planes_plain`."""
    if chunks[0].device.type == "cpu":
        return gather_planes_plain(chunks, index, remap)
    if not remap:
        return gather_planes_multi([chunks], index)[0]
    from ..kernels._build import launch

    dev = chunks[0].device
    n = _rows(chunks)
    if index.device != dev or index.dtype != torch.int32 or not index.is_contiguous():
        raise ValueError(f"gather_planes index must be contiguous int32 on {dev}")
    if chunks[0].dtype != torch.int32:
        raise ValueError(f"remap takes int32 code planes, got {chunks[0].dtype}")
    if n >= 1 << 31 or int(index.shape[0]) >= 1 << 31:
        raise ValueError(f"remap takes fewer than 2^31 codes and table rows, got {n}")
    src = _chunk_table(chunks, torch.int32, dev)
    out = _empty_like_chunks(chunks, torch.int32, dev)
    dst = _chunk_table(out, torch.int32, dev)
    vec = int(all(c.data_ptr() % 16 == 0 for c in (*chunks, *out)))
    a = _RemapArgs(src, dst, index.data_ptr(), int(index.shape[0]), n, vec, 0)
    gather_planes.launches += 1
    launch("gather_planes", "gt_remap_codes", a, _stream(dev))
    return out


gather_planes.launches = 0


# ---- K16: the delta patch ----------------------------------------------------------


def delta_patch_plain(old_chunks, old_n: int, delta: torch.Tensor, pos: torch.Tensor,
                      new_pad: int, chunk_rows: int) -> list:
    """Torch-op version of K16, the reference's `_delta_patch`: old row i
    to i + searchsorted(pos, i, right), delta row j to pos[j] + j, zeros
    past the merged rows; returned in chunks of `chunk_rows`."""
    full = torch.cat(old_chunks)[:old_n]
    dev = full.device
    p = pos.to(torch.int64)
    n_delta = int(p.shape[0])
    iota_old = torch.arange(old_n, dtype=torch.int64, device=dev)
    idx_old = iota_old + torch.searchsorted(p, iota_old, right=True)
    idx_new = p + torch.arange(n_delta, dtype=torch.int64, device=dev)
    out = torch.zeros(new_pad, dtype=full.dtype, device=dev)
    out[idx_old] = full
    out[idx_new] = delta.to(full.dtype)
    return [out[a:b].clone() for a, b in chunk_bounds(new_pad, chunk_rows)]


class _PatchArgs(ctypes.Structure):
    # mirrored field for field by PatchArgs in csrc/delta_patch.cu
    _fields_ = [
        ("old_rows", _ChunkTable), ("dst", _ChunkTable), ("delta", ctypes.c_void_p),
        ("pos", ctypes.c_void_p), ("old_n", ctypes.c_int64), ("n_delta", ctypes.c_int64),
        ("new_pad", ctypes.c_int64), ("esize", ctypes.c_int32), ("old_shift", ctypes.c_int32),
        ("tiles_per_chunk", ctypes.c_uint32), ("n_tiles", ctypes.c_uint32),
        ("vec_old", ctypes.c_int32), ("vec_dst", ctypes.c_int32),
    ]


PATCH_TILE = 4096  # output rows a CTA of K16 builds (kTile)


def patch_tiles(new_pad: int, chunk_rows: int) -> tuple[int, int]:
    """(tiles a destination chunk, tiles in all) of K16's grid over a
    `new_pad`-row plane cut every `chunk_rows` rows: each tile PATCH_TILE
    rows inside one chunk, a chunk's last tile shorter where PATCH_TILE
    does not divide it."""
    rows = min(int(chunk_rows), int(new_pad))
    if rows <= 0:
        return 1, 0
    tpc = -(-rows // PATCH_TILE)
    n_chunks = -(-int(new_pad) // rows)
    last = int(new_pad) - (n_chunks - 1) * rows
    return tpc, (n_chunks - 1) * tpc + -(-last // PATCH_TILE)


def _vector_aligned(chunks, elems: int) -> bool:
    """Whether 16 B copies of the chunked plane line up: every chunk
    pointer on a 16 B boundary, and a chunk's first row at a vector's
    start (one chunk, or chunk rows a multiple of `elems` = 16 / element
    size)."""
    rows = int(chunks[0].shape[0])
    return all(c.data_ptr() % 16 == 0 for c in chunks) and (len(chunks) == 1 or rows % elems == 0)


def delta_patch(old_chunks, old_n: int, delta: torch.Tensor, pos: torch.Tensor,
                new_pad: int, chunk_rows: int) -> list:
    """K16: merge the sorted delta run `delta` ([n_delta], the plane's
    dtype) into the first `old_n` rows of the chunked plane `old_chunks`
    at the merge positions `pos` (int32 [n_delta], non-decreasing: the
    old rows before each delta row).  Returns the new plane in chunks of
    `chunk_rows` over `new_pad` rows, zero past old_n + n_delta.  CUDA
    tensors launch csrc/delta_patch.cu (one launch: a CTA a tile of
    `patch_tiles`, its delta rows found by a warp search and placed by a
    scan of their flags, its old rows copied once into shared memory);
    CPU tensors run `delta_patch_plain`."""
    if delta.device.type == "cpu":
        return delta_patch_plain(old_chunks, old_n, delta, pos, new_pad, chunk_rows)
    from ..kernels._build import launch

    dev = delta.device
    dtype = old_chunks[0].dtype
    n_delta = int(delta.shape[0])
    if delta.dtype != dtype or not delta.is_contiguous() or delta.dim() != 1:
        raise ValueError(f"delta must be a contiguous 1-d {dtype} tensor")
    if pos.device != dev or pos.dtype != torch.int32 or tuple(pos.shape) != (n_delta,) \
            or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous int32 [{n_delta}] on {dev}")
    if not 0 <= old_n <= _rows(old_chunks) or old_n + n_delta > new_pad:
        raise ValueError(f"old_n {old_n} + delta {n_delta} do not fit: old plane "
                         f"{_rows(old_chunks)} rows, new pad {new_pad}")
    if new_pad >= 1 << 31:
        raise ValueError(f"delta_patch takes fewer than 2^31 rows, got {new_pad}")
    esize = old_chunks[0].element_size()
    if esize not in (1, 4, 8):
        raise ValueError(f"delta_patch takes 1, 4 or 8 byte elements, got {esize}")
    old_t = _chunk_table(old_chunks, dtype, dev)
    out = [torch.empty(b - a, dtype=dtype, device=dev)
           for a, b in chunk_bounds(new_pad, chunk_rows)]
    dst = _chunk_table(out, dtype, dev)
    tpc, n_tiles = patch_tiles(new_pad, dst.chunk_rows)
    ocr = int(old_t.chunk_rows)
    old_shift = ocr.bit_length() - 1 if ocr & (ocr - 1) == 0 else -1
    a = _PatchArgs(old_t, dst, delta.data_ptr(), pos.data_ptr(), int(old_n), n_delta,
                   int(new_pad), esize, old_shift, tpc, n_tiles,
                   int(_vector_aligned(old_chunks, 16 // esize)),
                   int(all(c.data_ptr() % 16 == 0 for c in out)))
    delta_patch.launches += 1
    launch("delta_patch", "gt_delta_patch", a, _stream(dev))
    return out


delta_patch.launches = 0
