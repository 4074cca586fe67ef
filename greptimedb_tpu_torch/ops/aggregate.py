"""Segmented (group-by) aggregation: kernels K2-K4 and the state algebra.

Counterpart of `greptimedb_tpu/ops/aggregate.py`, sort (dense) strategy.
Per-shard partial states are computed by three hand-written CUDA kernels
on a CUDA tile, and by their plain torch versions on a CPU tile:

* K2 `segment_reduce_blocked` (csrc/segment_reduce_blocked.cu): the
  blocked kernel for clustered ids, with the layout guard fused in;
* K3 `segment_reduce_scatter` (csrc/segment_reduce_scatter.cu): any id
  order, over a stable sort of the masked ids;
* K4 `segment_last` (csrc/segment_last.cu): last_value by (ts, row), in a
  blocked form and a sorted-run form.

The tile path adds four more (each again beside its plain version):

* K5 `quantize_limbs` (csrc/quantize_limbs.cu): per-block fixed-point
  encode of a value column into four base-256 bfloat16 digits;
* K6 `limb_segment_sums` (csrc/limb_segment_sums.cu): exact integer
  digit sums per group with a per-group error bound; its slow branch is
  K18's sort and its own runs kernel, and `segment_sums_scatter` runs on
  K3;
* K7 `topk_group_select` (csrc/topk_select.cu): ORDER BY / LIMIT and
  empty-group compaction over finalized [G] states;
* K8 `pack_result` (csrc/pack_result.cu): finalize and pack a query's
  outputs into the one buffer the host reads back.

The hash strategy adds K17 `hash_group_slots` (csrc/hash_group_slots.cu):
insert-or-find of int64 group ids in a linear-probing slot table threaded
through a query's sources; its states then reduce over the slot ids on K3
(`force_scatter`).

`segment_aggregate` / `segment_aggregate_multi` choose between them the
way the reference does: under 2^16 rows the scatter kernel; otherwise K2,
whose per-block guard (masked ids in range, span < 16) decides whether
its result stands or K3 reruns the reduction.  The blocked kernels' folds
(K2, K4's blocked form, K6) add each group's blocks in block order, as
the reference's scatter does, through the block layout of
csrc/block_layout.cuh (no sort of the bases).  The reference decides with
a `lax.cond` on the device; on a CUDA tile no host reads the verdict
either: both branches are launched, every kernel of each predicated on
the verdict word (a `Gate`), and both write the same outputs — K2's fold
when the guard passed; K18 `sort_segments` (csrc/segment_sort.cu, a
stable radix sort that reads the flag) and K3 when it failed.  So the
warm tile program has no host sync before its readback, and a CUDA graph
can hold it (parallel/tile_program.py `TickProgram`).

All sums are float64; every kernel adds in a fixed order, so a CUDA run
is byte-identical from run to run.  `merge_states`, `reduce_state_axes`
and `finalize` are torch ops over [G]-sized states.

Group ids are dense ints computed from time buckets and tag codes:
    gid = ((tag0 * card1 + tag1) * ... ) * n_buckets + time_bucket
(int32 on the dense path; int64 on the hash path, where only the slots of
the ids that occur are materialized).
"""

from __future__ import annotations

import ctypes
import decimal
import functools
import math
import struct
from dataclasses import dataclass, fields

import numpy as np
import torch

from .radix import (_RadixPlan, _RadixScratch, carve, plan_struct, radix_plan, radix_scratch,
                    sort_record)

SUM, COUNT, MIN, MAX, LAST = "sum", "count", "min", "max", "last"

# Blocked geometry: rows are processed in blocks of BLOCK_ROWS; a block
# may touch at most BLOCK_SPAN distinct consecutive group ids.
BLOCK_ROWS = 4096
BLOCK_SPAN = 16
_FAST_MIN_ROWS = 1 << 16
_DBL_MAX = float(np.finfo(np.float64).max)
_I64_MIN = int(np.iinfo(np.int64).min)
_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


@dataclass
class AggState:
    """Partial aggregation state over G groups (or [C, G] for C columns).
    `last_ts`/`last_val` implement last_value(value ORDER BY ts)."""

    sums: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    mins: torch.Tensor | None = None
    maxs: torch.Tensor | None = None
    last_ts: torch.Tensor | None = None
    last_val: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, device="cpu", **arrays) -> "AggState":
        """Carry a reference-package state across: its arrays as numpy
        (sums=np.asarray(state.sums), ...) -> tensors on `device`."""
        return cls(**{
            k: None if v is None else torch.from_numpy(np.array(v)).to(device)
            for k, v in arrays.items()
        })

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {
            f.name: getattr(self, f.name).cpu().numpy()
            for f in fields(self)
            if getattr(self, f.name) is not None
        }

    def row(self, i: int) -> "AggState":
        """Column i of a [C, G] state."""
        return AggState(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[i]
            for f in fields(self)
        })


def _wants(aggs) -> tuple[bool, bool, bool, bool]:
    return (
        SUM in aggs or "avg" in aggs,
        COUNT in aggs or "avg" in aggs,
        MIN in aggs,
        MAX in aggs,
    )


def _state_of(want, sums, counts, mins, maxs) -> AggState:
    w_sum, w_cnt, w_min, w_max = want
    return AggState(
        sums=sums if w_sum else None,
        counts=counts if w_cnt else None,
        mins=mins if w_min else None,
        maxs=maxs if w_max else None,
    )


def _f64(v: torch.Tensor) -> torch.Tensor:
    return v if v.dtype == torch.float64 else v.to(torch.float64)


def _pad_to(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    out = torch.full((n,), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


# ---- K2: blocked reduction ---------------------------------------------------


def block_guard_plain(gids, base_mask, num_groups: int):
    """The blocked layout guard: (ok, base [nb]).  Per 4096-row block the
    masked ids' bmin/bmax (an all-masked block: INT32_MAX / -1, which
    passes); ok when every masked id is in [0, G) and every block spans
    fewer than BLOCK_SPAN ids.  base = min(bmin, G): all-masked blocks land on
    the overflow slot.  A ragged tail is one more, partial block."""
    n = gids.shape[0]
    nb = max(-(-n // BLOCK_ROWS), 1)
    gb = _pad_to(gids.to(torch.int32), nb * BLOCK_ROWS, 0).reshape(nb, BLOCK_ROWS)
    mb = _pad_to(base_mask, nb * BLOCK_ROWS, False).reshape(nb, BLOCK_ROWS)
    in_range = torch.where(mb, (gb >= 0) & (gb < num_groups), True).all()
    bmin = torch.where(mb, gb, _I32_MAX).amin(dim=1)
    bmax = torch.where(mb, gb, -1).amax(dim=1)
    span_ok = ((bmax.to(torch.int64) - bmin.to(torch.int64)) < BLOCK_SPAN).all()
    base = torch.clamp(bmin, max=num_groups)
    return bool(in_range and span_ok), base


def segment_reduce_blocked_plain(values, gids, masks, base_mask, num_groups: int, aggs):
    """Torch-op version of K2: (ok, AggState [C, G] or None, base [nb])."""
    ok, base = block_guard_plain(gids, base_mask, num_groups)
    if not ok:
        return False, None, base
    nb = base.shape[0]
    L, K, G = BLOCK_ROWS, BLOCK_SPAN, num_groups
    dev = gids.device
    g = _pad_to(gids.to(torch.int64), nb * L, 0).reshape(nb, L)
    blk = torch.arange(nb, device=dev, dtype=torch.int64)[:, None]
    local = g - base.to(torch.int64)[:, None]
    slot = (blk * K + local).reshape(-1)
    window = (base.to(torch.int64)[:, None] + torch.arange(K, device=dev)).reshape(-1)
    want = _wants(aggs)
    out = {k: [] for k in ("sums", "counts", "mins", "maxs")}
    for v, m in zip(values, masks):
        vm = _pad_to(m & base_mask, nb * L, False).reshape(-1)
        x = _pad_to(_f64(v), nb * L, 0.0)
        s = torch.where(vm, slot, nb * K)  # masked rows -> dump slot
        if want[0]:
            p = torch.zeros(nb * K + 1, dtype=torch.float64, device=dev)
            p.index_add_(0, s, torch.where(vm, x, 0.0))
            acc = torch.zeros(G + K, dtype=torch.float64, device=dev)
            out["sums"].append(acc.index_add_(0, window, p[:-1])[:G])
        if want[1]:
            p = torch.zeros(nb * K + 1, dtype=torch.int32, device=dev)
            p.index_add_(0, s, vm.to(torch.int32))
            acc = torch.zeros(G + K, dtype=torch.int32, device=dev)
            out["counts"].append(acc.index_add_(0, window, p[:-1])[:G])
        for key, red, init, on in (
            ("mins", "amin", _DBL_MAX, want[2]),
            ("maxs", "amax", -_DBL_MAX, want[3]),
        ):
            if not on:
                continue
            p = torch.full((nb * K + 1,), init, dtype=torch.float64, device=dev)
            p.scatter_reduce_(0, s, torch.where(vm, x, init), red, include_self=True)
            acc = torch.full((G + K,), init, dtype=torch.float64, device=dev)
            acc.scatter_reduce_(0, window, p[:-1], red, include_self=True)
            out[key].append(acc[:G])
    return True, _stacked(out), base


def block_occupancy_plain(gids, base_mask, base) -> torch.Tensor:
    """occ int32 [nb]: bit j set where slot base + j of the block holds a
    masked row — what the blocked kernels write beside each base
    (csrc/block_layout.cuh); meaningful where the guard passed."""
    nb = base.shape[0]
    g = _pad_to(gids.to(torch.int64), nb * BLOCK_ROWS, 0).reshape(nb, BLOCK_ROWS)
    m = _pad_to(base_mask, nb * BLOCK_ROWS, False).reshape(nb, BLOCK_ROWS)
    slot = g - base.to(torch.int64)[:, None]
    bit = torch.where(m & (slot >= 0) & (slot < BLOCK_SPAN),
                      torch.ones_like(slot) << slot.clamp(0, BLOCK_SPAN - 1), 0)
    occ = torch.zeros(nb, dtype=torch.int64, device=gids.device)
    for j in range(BLOCK_SPAN):
        occ |= ((bit >> j) & 1).amax(dim=1) << j
    return occ.to(torch.int32)


def block_layout_plain(base, occ):
    """(keylo, keyhi, mode) of the blocked kernels' fold, in torch ops (the
    last CTA's scan in csrc/block_layout.cuh): the running maxima of the
    occupied blocks' bases and top occupied ids (INT32_MIN before the
    first), and whether some occupied block's base falls below the one
    before it."""
    on = occ != 0
    o64 = occ.to(torch.int64)
    top = torch.zeros_like(o64)
    for j in range(BLOCK_SPAN):
        top = torch.where(((o64 >> j) & 1) == 1, j, top)
    b64 = base.to(torch.int64)
    lo = torch.where(on, b64, _I32_MIN)
    hi = torch.where(on, b64 + top, _I32_MIN)
    keylo = torch.cummax(lo, 0).values
    keyhi = torch.cummax(hi, 0).values
    prev = torch.cat([keylo.new_full((1,), _I32_MIN), keylo[:-1]])
    mode = bool((on & (b64 < prev)).any())
    return keylo.to(torch.int32), keyhi.to(torch.int32), mode


def covering_blocks_plain(base, occ, keylo, keyhi, mode: bool, g: int) -> list:
    """[(block, slot)] the fold of group g adds, in the order it adds them:
    blocks [lo, hi) in block order (lo the first with keyhi >= g; hi the
    first with keylo > g, or nb when the bases fall), those whose slot
    g - base is occupied."""
    nb = int(base.shape[0])
    lo = int(torch.searchsorted(keyhi.to(torch.int64), g, right=False))
    hi = nb if mode else int(torch.searchsorted(keylo.to(torch.int64), g, right=True))
    out = []
    for b in range(lo, hi):
        s = g - int(base[b])
        if 0 <= s < BLOCK_SPAN and (int(occ[b]) >> s) & 1:
            out.append((b, s))
    return out


def _stacked(out: dict) -> AggState:
    return AggState(**{k: torch.stack(v) if v else None for k, v in out.items()})


class _Gate(ctypes.Structure):
    """Mirror of `Gate` (csrc/common.cuh): a predicated launch runs only
    when the guard verdict word (0 = passed) says its branch is taken."""

    _fields_ = [("verdict", ctypes.c_void_p), ("on_fail", ctypes.c_int32),
                ("reserved", ctypes.c_int32)]


def _gate(verdict, on_fail: bool) -> _Gate:
    """The Gate of a launch behind `verdict` (int32 [1] on the card, or
    None: always run)."""
    if verdict is None:
        return _Gate(None, 0, 0)
    return _Gate(verdict.data_ptr(), int(on_fail), 0)


class _BlockLayout(ctypes.Structure):
    """Mirror of `BlockLayout` (csrc/block_layout.cuh): a blocked kernel's
    per-block bases and occupied slots, the fold's keys, the verdict and
    the mode word."""

    _fields_ = [
        ("base", ctypes.c_void_p), ("keylo", ctypes.c_void_p), ("keyhi", ctypes.c_void_p),
        ("occ", ctypes.c_void_p), ("verdict", ctypes.c_void_p), ("mode", ctypes.c_void_p),
        ("nb", ctypes.c_int64), ("num_groups", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


def _block_layout(nb: int, G: int, dev, base=None, scratch=()):
    """(buffer, _BlockLayout, scratch addresses) of one call, in one
    allocation: the bases (unless `base` is given: K4 reads K2's), keylo,
    keyhi, occ, the verdict and mode words — all written on the card, no
    memset — then the call's scratch pieces (byte sizes).  The bases are
    buf[:4 nb] and the verdict buf[16 nb:16 nb + 4] as int32 (`_words`)."""
    own = base is None
    buf, (p, *rest) = carve([4 * ((4 if own else 3) * nb + 2), *scratch], dev)
    w = 4 * nb
    if own:
        base_ptr, p = p, p + w
    else:
        base_ptr = base.data_ptr()
    lay = _BlockLayout(base_ptr, p, p + w, p + 2 * w, p + 3 * w if own else None,
                       p + 3 * w + (4 if own else 0), nb, G, 0)
    return buf, lay, rest


def _words(buf, lo: int, hi: int) -> torch.Tensor:
    """int32 words [lo, hi) of a block layout's buffer."""
    return buf[4 * lo:4 * hi].view(torch.int32)


_K2_MAX_COLS = 32  # kMaxCols of csrc/segment_reduce_blocked.cu


class _BlockedArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("gids", ctypes.c_void_p), ("base_mask", ctypes.c_void_p),
        ("values", ctypes.c_void_p * _K2_MAX_COLS), ("masks", ctypes.c_void_p * _K2_MAX_COLS),
        ("layout", _BlockLayout),
        ("psum", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("pmin", ctypes.c_void_p), ("pmax", ctypes.c_void_p),
        ("n_cols", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


class _FoldArgs(ctypes.Structure):
    _fields_ = [
        ("layout", _BlockLayout),
        ("psum", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("pmin", ctypes.c_void_p), ("pmax", ctypes.c_void_p),
        ("sums", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("mins", ctypes.c_void_p), ("maxs", ctypes.c_void_p),
        ("n_cols", ctypes.c_int32), ("reserved", ctypes.c_int32),
        ("gate", _Gate),
    ]


def segment_reduce_blocked(values, gids, masks, base_mask, num_groups: int, aggs, outs=None):
    """K2: blocked sum/count/min/max of C columns.

    values: C float tensors [n]; gids int32 [n]; masks: C bool [n] column
    masks, each a subset of `base_mask` (bool [n]) — the guard runs on the
    base mask.  A CPU tile runs `segment_reduce_blocked_plain` and returns
    (ok, AggState [C, G] or None, base int32 [nb]): ok is False when the
    layout guard failed, and the caller must use K3.

    A CUDA tile launches csrc/segment_reduce_blocked.cu and returns
    (verdict, AggState [C, G], base): verdict is the guard's int32 [1]
    word on the card (0 = passed), which no host reads; the fold that
    writes the state is predicated on it, so the state holds the blocked
    result when it is 0 and is left for the predicated K3 branch to write
    (`segment_aggregate`) when it is not.  `outs` optionally gives the
    [C, G] output tensors (sums, counts, mins, maxs) to write.  A launch
    takes up to 32 columns (their pointers ride in its arguments); more
    run as further launches over the same ids, each with its own guard
    pass, which gives the same verdict."""
    if gids.device.type == "cpu":
        return segment_reduce_blocked_plain(values, gids, masks, base_mask, num_groups, aggs)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    nb = max(-(-n // BLOCK_ROWS), 1)
    C, G = len(values), int(num_groups)
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(base_mask, torch.bool, n, dev)
    vals, mptrs = _column_ptrs(values, masks, base_mask, n, dev)
    want = _wants(aggs)
    outs = _state_outs(want, C, G, dev, outs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = None
    for c0 in range(0, C, _K2_MAX_COLS):
        cc = min(_K2_MAX_COLS, C - c0)
        # the [nb, cc, 16] partials of the wanted aggregates beside the layout
        sizes = [nb * cc * BLOCK_SPAN * b for on, b in zip(want, (8, 4, 8, 8)) if on]
        buf, lay, ptrs = _block_layout(nb, G, dev, scratch=sizes)
        it = iter(ptrs)
        parts = [next(it) if on else None for on in want]
        a = _BlockedArgs(
            n, gids.data_ptr(), base_mask.data_ptr(),
            (ctypes.c_void_p * _K2_MAX_COLS)(*(v.data_ptr() for v in vals[c0:c0 + cc])),
            (ctypes.c_void_p * _K2_MAX_COLS)(*mptrs[c0:c0 + cc]),
            lay, *parts, cc, 0,
        )
        segment_reduce_blocked.launches += 1
        launch("segment_reduce_blocked", "gt_blocked_partials", a, stream)
        verdict = _words(buf, 4 * nb, 4 * nb + 1)
        f = _FoldArgs(
            lay, *parts, *(None if o is None else o[c0:c0 + cc].data_ptr() for o in outs),
            cc, 0, _gate(verdict, on_fail=False),
        )
        launch("segment_reduce_blocked", "gt_blocked_fold", f, stream)
        if first is None:
            first = (verdict, _words(buf, 0, nb))
    return first[0], _state_of(want, *outs), first[1]


def _state_outs(want, C: int, G: int, dev, outs=None) -> list:
    """The [C, G] (sums f64, counts int32, mins f64, maxs f64) outputs a
    reduction writes: `outs` where given (two branches of one guard write
    the same tensors), else new ones."""
    if outs is not None:
        return [o if on else None for o, on in zip(outs, want)]
    return [
        torch.empty((C, G), dtype=dt, device=dev) if on else None
        for on, dt in zip(want, (torch.float64, torch.int32, torch.float64, torch.float64))
    ]


segment_reduce_blocked.launches = 0


# ---- K3: scatter reduction over sorted runs ----------------------------------


def sort_segments_plain(gids, mask, num_groups: int):
    """Torch-op version of K18: a stable torch.sort of the masked ids."""
    G = int(num_groups)
    key = torch.where(mask & (gids >= 0) & (gids < G), gids.to(torch.int32), G)
    skeys, perm = torch.sort(key, stable=True)
    return skeys.contiguous(), perm.contiguous()


class _SortArgs(ctypes.Structure):
    # mirrored field for field by SortArgs in csrc/segment_sort.cu
    _fields_ = [
        ("n", ctypes.c_int64), ("gids", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p), ("num_groups", ctypes.c_int32),
        ("reserved", ctypes.c_int32), ("gate", _Gate), ("plan", _RadixPlan),
        ("scratch", _RadixScratch),
    ]


def sort_segments(gids, mask, num_groups: int, verdict=None):
    """K18, the index plumbing of K3/K4: a stable sort of the masked ids
    (masked and out-of-range rows carry G and sort last).  Returns (sorted
    ids int32 [n], row of each int64 [n]); rows of one group form one run,
    in row order.  A CUDA tile launches csrc/segment_sort.cu (the one-sweep
    radix sort planned from G: one pass up to G = 2047; what it ran lands
    in `sort_segments.last_sort`), predicated on `verdict` (a layout
    guard's int32 [1] word: the sort runs only when it failed) when one is
    given; a CPU tile runs `sort_segments_plain`."""
    if gids.device.type == "cpu":
        return sort_segments_plain(gids, mask, num_groups)
    dev = gids.device
    n = int(gids.shape[0])
    G = int(num_groups)
    if n >= 1 << 31:
        raise ValueError(f"sort_segments takes fewer than 2^31 rows, got {n}")
    if not 0 <= G <= _I32_MAX:
        raise ValueError(f"sort_segments takes 0 <= G < 2^31 groups, got {G}")
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(mask, torch.bool, n, dev)
    skeys = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    sort_segments.launches += 1
    _segment_sort_into(gids, mask, G, verdict, skeys, perm)
    return skeys, perm


def _segment_sort_into(gids, mask, G: int, verdict, skeys, perm) -> None:
    """Launches K18 into `skeys` and `perm` (checked CUDA tensors of n rows);
    a shut gate leaves them as they were."""
    from ..kernels._build import launch

    n = int(gids.shape[0])
    plan = radix_plan(G)
    keep, scratch = radix_scratch(n, plan, gids.device)
    a = _SortArgs(n, gids.data_ptr(), mask.data_ptr(), skeys.data_ptr(), perm.data_ptr(), G, 0,
                  _gate(verdict, on_fail=True), plan_struct(plan), scratch)
    launch("segment_sort", "gt_segment_sort", a, torch.cuda.current_stream(gids.device).cuda_stream)
    sort_segments.last_sort = sort_record(plan, a.scratch.kernels)
    # the scratch is freed into the caching allocator and reused only by
    # work queued after these launches on the same stream
    del keep


sort_segments.launches = 0
sort_segments.last_sort = None


def segment_reduce_scatter_plain(values, gids, masks, base_mask, num_groups: int, aggs):
    """Torch-op version of K3 (the reference's segment_sum/min/max with an
    overflow slot): AggState [C, G]."""
    G = int(num_groups)
    dev = gids.device
    want = _wants(aggs)
    g = gids.to(torch.int64)
    out = {k: [] for k in ("sums", "counts", "mins", "maxs")}
    for v, m in zip(values, masks):
        m = m & base_mask
        safe = torch.where(m & (g >= 0) & (g < G), g, G)
        x = _f64(v)
        if want[0]:
            acc = torch.zeros(G + 1, dtype=torch.float64, device=dev)
            out["sums"].append(acc.index_add_(0, safe, torch.where(m, x, 0.0))[:G])
        if want[1]:
            acc = torch.zeros(G + 1, dtype=torch.int32, device=dev)
            out["counts"].append(acc.index_add_(0, safe, m.to(torch.int32))[:G])
        # empty groups keep the identities of segment_min/max: +-inf
        for key, red, init, on in (
            ("mins", "amin", float("inf"), want[2]),
            ("maxs", "amax", float("-inf"), want[3]),
        ):
            if on:
                acc = torch.full((G + 1,), init, dtype=torch.float64, device=dev)
                acc.scatter_reduce_(0, safe, torch.where(m, x, init), red, include_self=True)
                out[key].append(acc[:G])
    return _stacked(out)


def _nan_min(a, b):
    nan = torch.full_like(a, float("nan"))
    return torch.where(torch.isnan(a) | torch.isnan(b), nan, torch.where(b < a, b, a))


def _nan_max(a, b):
    nan = torch.full_like(a, float("nan"))
    return torch.where(torch.isnan(a) | torch.isnan(b), nan, torch.where(b > a, b, a))


def segment_reduce_scatter_lanes(values, masks, base_mask, order, num_groups: int, aggs):
    """K3's add order in torch ops (holds the kernel byte for byte, NaN
    payloads aside): over `order` (a `sort_segments` result), lane l of a
    run folds the run's positions start + l, start + l + 32, ... in order
    from 0.0 / +inf / -inf (count 0), skipping rows its column mask drops,
    then the lanes combine as csrc/common.cuh's warp_sum, warp_min and
    warp_max do: for o = 16, 8, 4, 2, 1 lane l < o takes lane l + o, and
    lane 0 holds the result; min and max give the quiet NaN where either
    operand is NaN.  An empty group keeps (0.0, 0, +inf, -inf).  Returns
    AggState [C, G]."""
    skeys, perm = order
    G = int(num_groups)
    dev = skeys.device
    n = int(skeys.shape[0])
    want = _wants(aggs)
    in_run = skeys < G
    first = torch.searchsorted(skeys, skeys, right=False)
    off = torch.arange(n, dtype=torch.int64, device=dev) - first
    # each run's index among the runs: its partials are lanes [32 r, 32 r + 32)
    starts = in_run & (off == 0)
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    n_runs = int(starts.sum())
    slot = run * 32 + off % 32
    groups = skeys[starts].to(torch.int64)
    k = off // 32
    out = {key: [] for key in ("sums", "counts", "mins", "maxs")}
    for v, m in zip(values, masks):
        x = _f64(v)[perm]
        on = in_run & (m & base_mask)[perm]
        s = torch.zeros(n_runs * 32, dtype=torch.float64, device=dev)
        cnt = torch.zeros(n_runs * 32, dtype=torch.int32, device=dev)
        mn = torch.full((n_runs * 32,), float("inf"), dtype=torch.float64, device=dev)
        mx = torch.full((n_runs * 32,), float("-inf"), dtype=torch.float64, device=dev)
        kk, pos = torch.sort(torch.where(on, k, n), stable=True)
        _vals, per_k = torch.unique_consecutive(kk, return_counts=True)
        for part, kv in zip(torch.split(pos, per_k.tolist()), _vals.tolist()):
            if kv == n:
                break
            i, xv = slot[part], x[part]
            s[i] = s[i] + xv
            cnt[i] = cnt[i] + 1
            mn[i] = _nan_min(mn[i], xv)
            mx[i] = _nan_max(mx[i], xv)
        s, cnt, mn, mx = (t.view(n_runs, 32) for t in (s, cnt, mn, mx))
        for o in (16, 8, 4, 2, 1):
            s[:, :o] = s[:, :o] + s[:, o:2 * o]
            cnt[:, :o] = cnt[:, :o] + cnt[:, o:2 * o]
            mn[:, :o] = _nan_min(mn[:, :o], mn[:, o:2 * o])
            mx[:, :o] = _nan_max(mx[:, :o], mx[:, o:2 * o])
        for key, lanes, init, dt, on_ in (("sums", s, 0.0, torch.float64, want[0]),
                                          ("counts", cnt, 0, torch.int32, want[1]),
                                          ("mins", mn, float("inf"), torch.float64, want[2]),
                                          ("maxs", mx, float("-inf"), torch.float64, want[3])):
            if on_:
                full = torch.full((G,), init, dtype=dt, device=dev)
                full[groups] = lanes[:, 0]
                out[key].append(full)
    return _stacked(out)


_K3_MAX_COLS = 32  # kMaxCols of csrc/segment_reduce_scatter.cu


class _ScatterArgs(ctypes.Structure):
    # mirrored field for field by ScatterArgs in csrc/segment_reduce_scatter.cu
    _fields_ = [
        ("n", ctypes.c_int64), ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("values", ctypes.c_void_p * _K3_MAX_COLS), ("masks", ctypes.c_void_p * _K3_MAX_COLS),
        ("sums", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("mins", ctypes.c_void_p), ("maxs", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("n_cols", ctypes.c_int32),
        ("tile_groups", ctypes.c_int32), ("prewrite", ctypes.c_int32), ("gate", _Gate),
    ]


def column_launches(n_cols: int, per_launch: int = _K3_MAX_COLS) -> list[tuple[int, int]]:
    """[c0, c1) column ranges of a C-column reduction's launches: at most
    `per_launch` columns each, in column order."""
    return [(c0, min(c0 + per_launch, n_cols)) for c0 in range(0, n_cols, per_launch)]


def segment_reduce_scatter(values, gids, masks, base_mask, num_groups: int, aggs, order=None,
                           verdict=None, outs=None):
    """K3: sum/count/min/max of C columns for any id order.  Arguments as
    `segment_reduce_blocked`; `order` optionally reuses a
    `sort_segments(gids, base_mask, G)` result.  Returns AggState [C, G].
    A CUDA tile launches csrc/segment_reduce_scatter.cu once per 32
    columns (`column_launches`; the column pointers ride in the launch's
    arguments) — predicated on `verdict` (a layout guard's word: it runs
    only when the guard failed) when one is given, writing `outs` (the
    other branch's outputs) — and a CPU tile runs
    `segment_reduce_scatter_plain`."""
    if gids.device.type == "cpu":
        return segment_reduce_scatter_plain(values, gids, masks, base_mask, num_groups, aggs)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    C, G = len(values), int(num_groups)
    if n >= 1 << 31:
        raise ValueError(f"segment_reduce_scatter takes fewer than 2^31 rows, got {n}")
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(base_mask, torch.bool, n, dev)
    if order is None:
        order = sort_segments(gids, base_mask, G, verdict)
    skeys, perm = order
    vals, mptrs = _column_ptrs(values, masks, base_mask, n, dev)
    want = _wants(aggs)
    outs = _state_outs(want, C, G, dev, outs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gate = _gate(verdict, on_fail=True)
    for c0, c1 in column_launches(C):
        a = _ScatterArgs(
            n, skeys.data_ptr(), perm.data_ptr(),
            (ctypes.c_void_p * _K3_MAX_COLS)(*(v.data_ptr() for v in vals[c0:c1])),
            (ctypes.c_void_p * _K3_MAX_COLS)(*mptrs[c0:c1]),
            *(None if o is None else o[c0:c1].data_ptr() for o in outs), G, c1 - c0, 0, 0, gate,
        )
        segment_reduce_scatter.launches += 1
        launch("segment_reduce_scatter", "gt_scatter_reduce", a, stream)
    del vals
    return _state_of(want, *outs)


segment_reduce_scatter.launches = 0


# ---- K4: last_value -----------------------------------------------------------


def segment_last_plain(values, ts, gids, mask, num_groups: int, base=None):
    """Torch-op version of K4: (last_ts int64 [G], last_val float64 [G]).
    With `base` (the blocked guard passed) the reference's blocked
    two-pass form over [nb, BLOCK_SPAN] slots; without it the scatter form."""
    G = int(num_groups)
    dev = gids.device
    n = gids.shape[0]
    x = _f64(values)
    if base is None:
        g = gids.to(torch.int64)
        safe = torch.where(mask & (g >= 0) & (g < G), g, G)
        t = torch.where(mask, ts, _I64_MIN)
        lt = torch.full((G + 1,), _I64_MIN, dtype=torch.int64, device=dev)
        lt.scatter_reduce_(0, safe, t, "amax", include_self=True)
        last_ts = lt[:G]
        is_last = mask & (ts == last_ts[torch.clamp(safe, 0, G - 1)])
        ridx = torch.arange(n, dtype=torch.int64, device=dev)
        pick = torch.full((G + 1,), -1, dtype=torch.int64, device=dev)
        pick.scatter_reduce_(0, safe, torch.where(is_last, ridx, -1), "amax", include_self=True)
        return last_ts, x[torch.clamp(pick[:G], 0, n - 1)]
    nb = base.shape[0]
    L, K = BLOCK_ROWS, BLOCK_SPAN
    g = _pad_to(gids.to(torch.int64), nb * L, 0).reshape(nb, L)
    m = _pad_to(mask, nb * L, False).reshape(-1)
    t = _pad_to(ts, nb * L, _I64_MIN)
    b64 = base.to(torch.int64)
    slot = (torch.arange(nb, device=dev)[:, None] * K + g - b64[:, None]).reshape(-1)
    s = torch.where(m, slot, nb * K)
    # pass 1: per-slot max ts, then windowed max -> last_ts
    pt = torch.full((nb * K + 1,), _I64_MIN, dtype=torch.int64, device=dev)
    pt.scatter_reduce_(0, s, torch.where(m, t, _I64_MIN), "amax", include_self=True)
    pt = pt[:-1]
    window = (b64[:, None] + torch.arange(K, device=dev)).reshape(-1)
    lt = torch.full((G + K,), _I64_MIN, dtype=torch.int64, device=dev)
    lt.scatter_reduce_(0, window, pt, "amax", include_self=True)
    last_ts = lt[:G]
    # pass 2: highest row at the slot's max ts, kept where that slot's max
    # is the group's max
    ridx = torch.arange(nb * L, dtype=torch.int64, device=dev)
    at_max = m & (t == torch.cat([pt, pt.new_full((1,), _I64_MIN)])[s])
    pidx = torch.full((nb * K + 1,), -1, dtype=torch.int64, device=dev)
    pidx.scatter_reduce_(0, s, torch.where(at_max, ridx, -1), "amax", include_self=True)
    pidx = pidx[:-1]
    slot_is_global = pt == lt[torch.clamp(window, max=G + K - 1)]
    pidx = torch.where(slot_is_global, pidx, -1)
    pick = torch.full((G + K,), -1, dtype=torch.int64, device=dev)
    pick.scatter_reduce_(0, window, pidx, "amax", include_self=True)
    return last_ts, x[torch.clamp(pick[:G], 0, n - 1)]


class _LastBlockedArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("gids", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("ts", ctypes.c_void_p), ("layout", _BlockLayout),
        ("pts", ctypes.c_void_p), ("prow", ctypes.c_void_p), ("gate", _Gate),
        ("vec", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


class _LastFoldArgs(ctypes.Structure):
    _fields_ = [
        ("layout", _BlockLayout), ("pts", ctypes.c_void_p), ("prow", ctypes.c_void_p),
        ("values", ctypes.c_void_p), ("last_ts", ctypes.c_void_p),
        ("last_val", ctypes.c_void_p), ("n", ctypes.c_int64), ("gate", _Gate),
    ]


class _LastSortedArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("ts", ctypes.c_void_p), ("values", ctypes.c_void_p),
        ("last_ts", ctypes.c_void_p), ("last_val", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("reserved", ctypes.c_int32),
        ("gate", _Gate),
    ]


def segment_last(values, ts, gids, mask, num_groups: int, base=None, order=None, verdict=None):
    """K4: last_value(values ORDER BY ts) per group; a ts tie goes to the
    later row.  With `base` (int32 [nb] from K2's guard pass over this
    `mask`) the blocked form; otherwise the sorted-run form over `order`
    (`sort_segments(gids, mask, G)`, computed when not given).  With
    `verdict` (the int32 [1] word of that K2 call, on the card) both forms
    launch, each predicated on it, into the same outputs: no host reads
    which one stands.  Returns (last_ts int64 [G], last_val float64 [G]);
    an empty group has ts INT64_MIN and the value of row 0.  A CUDA tile
    launches csrc/segment_last.cu; a CPU tile runs `segment_last_plain`."""
    if gids.device.type == "cpu":
        return segment_last_plain(values, ts, gids, mask, num_groups, base)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    G = int(num_groups)
    if n >= 2**31:
        raise ValueError("segment_last indexes rows in int32: at most 2^31 - 1 rows")
    if verdict is not None and base is None:
        raise ValueError("a predicated segment_last needs the guard's bases")
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(mask, torch.bool, n, dev)
    _check_rows(ts, torch.int64, n, dev)
    x = _f64(values).contiguous()
    _check_rows(x, torch.float64, n, dev)
    last_ts = torch.empty(G, dtype=torch.int64, device=dev)
    last_val = torch.empty(G, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    segment_last.launches += 1
    if base is not None:
        nb = int(base.shape[0])
        if nb != max(-(-n // BLOCK_ROWS), 1) or base.dtype != torch.int32 or base.device != dev:
            raise ValueError("segment_last's bases must be K2's int32 [nb] of these rows")
        blocked = _gate(verdict, on_fail=False)
        # this call's keys and occupied slots beside K2's bases (no sort),
        # and the [nb, 16] (ts, row) partials
        keep, lay, (pts, prow) = _block_layout(nb, G, dev, base=base,
                                               scratch=(nb * BLOCK_SPAN * 8, nb * BLOCK_SPAN * 4))
        # 16 B loads of ids and ts, 4 B of masks, where the planes allow
        vec = int(gids.data_ptr() % 16 == 0 and ts.data_ptr() % 16 == 0
                  and mask.data_ptr() % 4 == 0)
        a = _LastBlockedArgs(n, gids.data_ptr(), mask.data_ptr(), ts.data_ptr(), lay, pts, prow,
                             blocked, vec, 0)
        launch("segment_last", "gt_last_partials", a, stream)
        f = _LastFoldArgs(lay, pts, prow, x.data_ptr(), last_ts.data_ptr(), last_val.data_ptr(),
                          n, blocked)
        launch("segment_last", "gt_last_fold", f, stream)
        del keep
        if verdict is None:
            return last_ts, last_val
    if order is None:
        order = sort_segments(gids, mask, G, verdict)
    skeys, perm = order
    a = _LastSortedArgs(n, skeys.data_ptr(), perm.data_ptr(), ts.data_ptr(), x.data_ptr(),
                        last_ts.data_ptr(), last_val.data_ptr(), G, 0,
                        _gate(verdict, on_fail=True))
    launch("segment_last", "gt_last_sorted", a, stream)
    return last_ts, last_val


segment_last.launches = 0



# ---- kernel plumbing ----------------------------------------------------------


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_rows(t: torch.Tensor, dtype, n: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} [{n}] on {dev}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _column_ptrs(values, masks, base_mask, n: int, dev):
    """The C-column kernels' operands: (f64 columns, their masks' pointers).
    A column mask that IS the base mask is a null pointer (no second
    read)."""
    if len(values) != len(masks) or not values:
        raise ValueError("one mask per value column, at least one column")
    vals = [_f64(v).contiguous() for v in values]
    for v in vals:
        _check_rows(v, torch.float64, n, dev)
    mptrs = []
    for m in masks:
        if m is base_mask or m.data_ptr() == base_mask.data_ptr():
            mptrs.append(None)
        else:
            _check_rows(m, torch.bool, n, dev)
            mptrs.append(m.data_ptr())
    return vals, mptrs


# ---- the reference's entry points ----------------------------------------------


def segment_aggregate(
    values: torch.Tensor,
    gids: torch.Tensor,
    num_groups: int,
    aggs: tuple[str, ...],
    mask: torch.Tensor | None = None,
    ts: torch.Tensor | None = None,
    force_scatter: bool = False,
) -> AggState:
    """Per-shard partial aggregation of one column (the lower/state
    stage), float64 accumulation.  Under 2^16 rows, or with
    `force_scatter` (hash slot ids, which are never clustered: the guard
    and its sync are skipped), the scatter kernels; otherwise K2, whose
    guard picks the blocked result or a K3 rerun.  LAST takes K4 in the
    matching form."""
    if mask is None:
        mask = gids < num_groups
    n = values.shape[0]
    other = tuple(a for a in aggs if a != LAST)
    if LAST in aggs and ts is None:
        raise ValueError("LAST aggregation requires ts")
    guarded = n >= _FAST_MIN_ROWS and not force_scatter
    if guarded and gids.device.type != "cpu":
        # both branches, predicated on the guard's word: no host read
        verdict, st, base = segment_reduce_blocked(
            [values], gids, [mask], mask, num_groups, other or (COUNT,))
        order = sort_segments(gids, mask, num_groups, verdict)
        state = AggState()
        if other:
            state = segment_reduce_scatter(
                [values], gids, [mask], mask, num_groups, other, order, verdict,
                outs=_outs_of(st)).row(0)
        if LAST in aggs:
            state.last_ts, state.last_val = segment_last(
                values, ts, gids, mask, num_groups, base=base, order=order, verdict=verdict)
        return state
    base = None
    state = None
    if guarded:
        ok, st, b = segment_reduce_blocked(
            [values], gids, [mask], mask, num_groups, other or (COUNT,)
        )
        if ok:
            base = b
            state = st.row(0) if other else AggState()
    order = None
    if state is None:
        if gids.device.type != "cpu":
            order = sort_segments(gids, mask, num_groups)
        state = (
            segment_reduce_scatter([values], gids, [mask], mask, num_groups, other, order).row(0)
            if other else AggState()
        )
    if LAST in aggs:
        state.last_ts, state.last_val = segment_last(
            values, ts, gids, mask, num_groups, base=base, order=order
        )
    return state


def _outs_of(st: AggState) -> list:
    return [st.sums, st.counts, st.mins, st.maxs]


def segment_aggregate_multi(
    values: list,
    gids: torch.Tensor,
    num_groups: int,
    aggs: tuple[str, ...],
    masks: list,
    base_mask: torch.Tensor,
    force_scatter: bool = False,
) -> AggState:
    """C value columns sharing ONE layout guard and one kernel launch:
    arrays in the result are [C, G].  `masks[c]` must be a subset of
    `base_mask` (the guard runs on the base mask); `force_scatter` skips
    the guard for K3 (hash slot ids).  On a CUDA tile the K3 branch is
    predicated on the guard's word, as in `segment_aggregate`.  LAST is
    not supported here (callers route last_value per column)."""
    if LAST in aggs:
        raise ValueError("segment_aggregate_multi does not support LAST")
    n = values[0].shape[0]
    if n >= _FAST_MIN_ROWS and not force_scatter:
        ok, st, _base = segment_reduce_blocked(
            values, gids, masks, base_mask, num_groups, aggs
        )
        if gids.device.type != "cpu":
            return segment_reduce_scatter(values, gids, masks, base_mask, num_groups, aggs,
                                          verdict=ok, outs=_outs_of(st))
        if ok:
            return st
    return segment_reduce_scatter(values, gids, masks, base_mask, num_groups, aggs)


def reduce_state_axes(
    state: AggState,
    layout_cards: tuple[int, ...],
    keep_axes: tuple[int, ...],
) -> AggState:
    """Fold a [prod(layout_cards)] state down to the kept axes, in the
    requested order (hierarchical grouping, stage 2).  LAST states allow
    a pure axis permutation only."""
    drop = tuple(i for i in range(len(layout_cards)) if i not in keep_axes)
    if state.last_ts is not None and drop:
        raise ValueError("reduce_state_axes cannot drop axes of LAST states")
    if not drop and keep_axes == tuple(range(len(layout_cards))):
        return state

    def fold(arr, op):
        a = arr.reshape(layout_cards)
        if drop:
            a = op(a, drop)
        remaining = [i for i in range(len(layout_cards)) if i in keep_axes]
        perm = [remaining.index(i) for i in keep_axes]
        if perm != list(range(len(perm))):
            a = a.permute(perm)
        return a.reshape(-1)

    out = AggState()
    if state.sums is not None:
        out.sums = fold(state.sums, lambda a, d: a.sum(dim=d))
    if state.counts is not None:
        out.counts = fold(state.counts, lambda a, d: a.sum(dim=d, dtype=a.dtype))
    if state.mins is not None:
        out.mins = fold(state.mins, lambda a, d: a.amin(dim=d))
    if state.maxs is not None:
        out.maxs = fold(state.maxs, lambda a, d: a.amax(dim=d))
    if state.last_ts is not None:
        out.last_ts = fold(state.last_ts, None)
        out.last_val = fold(state.last_val, None)
    return out


def merge_states(a: AggState, b: AggState) -> AggState:
    """Combine two partials (the upper/merge stage)."""
    out = AggState()
    if a.sums is not None:
        out.sums = a.sums + b.sums
    if a.counts is not None:
        out.counts = a.counts + b.counts
    if a.mins is not None:
        out.mins = torch.minimum(a.mins, b.mins)
    if a.maxs is not None:
        out.maxs = torch.maximum(a.maxs, b.maxs)
    if a.last_ts is not None:
        # ties go to b: sources merge in write order, so the later write wins
        newer_or_tie = b.last_ts >= a.last_ts
        out.last_ts = torch.maximum(a.last_ts, b.last_ts)
        out.last_val = torch.where(newer_or_tie, b.last_val, a.last_val)
    return out


def finalize(state: AggState, aggs: tuple[str, ...], counts=None) -> dict[str, torch.Tensor]:
    """State -> final outputs; `non_empty` marks groups with any row.
    `counts` supplies the group counts when the state skipped its own
    count pass (a column with no null mask counts the group presence)."""
    out: dict[str, torch.Tensor] = {}
    counts = state.counts if state.counts is not None else counts
    if counts is not None:
        out["count"] = counts
    if SUM in aggs or "avg" in aggs:
        out["sum"] = state.sums
    if "avg" in aggs:
        out["avg"] = state.sums / torch.clamp(counts, min=1)
    if MIN in aggs:
        out["min"] = state.mins
    if MAX in aggs:
        out["max"] = state.maxs
    if LAST in aggs:
        out["last"] = state.last_val
        out["last_ts"] = state.last_ts
    if counts is not None:
        out["non_empty"] = counts > 0
    else:
        probe = state.mins if state.mins is not None else state.maxs
        if probe is not None:
            extreme = _DBL_MAX if probe is state.mins else -_DBL_MAX
            out["non_empty"] = probe != extreme
    return out


# ---- K17: the hash group-by's slot table ------------------------------------------
#
# The alternative to the dense mixed-radix group space: when the padded
# group space G = prod(tag_cards) * n_buckets dwarfs the groups that occur,
# dense [G] states waste memory, readback and finalize work, and past the
# dense bound the sort path refuses outright.  The planner then sizes a
# slot table at about twice the distinct keys and the states reduce over
# [H] slot ids.

HASH_EMPTY = -1  # table sentinel; real gids are >= 0
_HASH_MULT = 0x9E3779B97F4A7C15
_I64_MAX = (1 << 63) - 1


def _hash_home(gids: torch.Tensor, h: int) -> torch.Tensor:
    """int32 home position of each gid: the top `bits` bits of the
    wrapping uint64 product gid * 0x9E3779B97F4A7C15, clamped to h - 1.
    int64 arithmetic wraps like uint64; the shift is logical via a mask."""
    bits = max(int(h).bit_length() - 1, 1)
    prod = gids.to(torch.int64) * (_HASH_MULT - (1 << 64))
    h0 = ((prod >> (64 - bits)) & ((1 << bits) - 1)).to(torch.int32)
    return torch.clamp(h0, max=h - 1)


def hash_group_slots_plain(table_keys, gids, active):
    """Torch-op version of K17, line for line the reference's rounds
    (see `hash_group_slots`)."""
    h = table_keys.shape[0]
    h0 = _hash_home(gids, h)
    n = gids.shape[0]
    dev = gids.device
    max_rounds = min(2 * h, 1024)
    table = table_keys.clone()
    slots = torch.full((n,), h, dtype=torch.int32, device=dev)
    probe = torch.zeros(n, dtype=torch.int32, device=dev)
    act = active.clone()
    rounds = 0
    while bool(act.any()) and rounds < max_rounds:
        pos = (h0 + probe) & (h - 1)
        safe_pos = torch.where(act, pos, 0).to(torch.int64)
        claim = torch.full((h,), _I64_MAX, dtype=torch.int64, device=dev).scatter_reduce_(
            0, safe_pos, torch.where(act, gids, _I64_MAX), "amin", include_self=True
        )
        table = torch.where((table == HASH_EMPTY) & (claim != _I64_MAX), claim, table)
        found = act & (table[pos.to(torch.int64)] == gids)
        slots = torch.where(found, pos, slots)
        act = act & ~found
        probe = torch.where(act, probe + 1, probe)
        rounds += 1
    hash_group_slots.last_rounds = torch.tensor([rounds], dtype=torch.int32)
    table_keys.copy_(table)
    return table_keys, slots, act.sum(dtype=torch.int32)


class _HashArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("h", ctypes.c_int64), ("table", ctypes.c_void_p),
        ("gids", ctypes.c_void_p), ("active", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("rows0", ctypes.c_void_p), ("rows1", ctypes.c_void_p), ("keys0", ctypes.c_void_p),
        ("keys1", ctypes.c_void_p), ("state", ctypes.c_void_p),
        ("bits", ctypes.c_int32), ("max_rounds", ctypes.c_int32),
        ("kernels", ctypes.c_int32),  # out: the kernels the call launched
    ]


def hash_group_slots(table_keys: torch.Tensor, gids: torch.Tensor, active: torch.Tensor):
    """K17: insert-or-find every active row's group id in a linear-probing
    slot table.

    table_keys: int64 [H], HASH_EMPTY where unoccupied; updated IN PLACE
                (the reference returns a new array) and returned
    gids:       int64 [n] raw group ids (>= 0, below 2^62)
    active:     bool [n] rows that participate

    Returns (table_keys, slots int32 [n], overflow int32 []): slot H for
    masked rows and for rows that found no slot within min(2H, 1024)
    probe rounds, and overflow the count of the latter.  Deterministic:
    per round the smallest gid claiming a position wins it, so threading
    one table through a query's sources gives every gid one slot.  A CUDA
    tensor launches csrc/hash_group_slots.cu: one cooperative launch runs
    every round (claims in the table itself, the rows not found on a
    worklist) and stops on the card's own count, so no host read sits
    between the rounds; a CPU tensor runs `hash_group_slots_plain`.  The
    rounds of the last call stay on the tensors' device until asked for
    (`last_hash_rounds`), after the query's readback."""
    if gids.device.type == "cpu":
        return hash_group_slots_plain(table_keys, gids, active)
    from ..kernels._build import launch

    hash_group_slots.calls += 1
    dev = gids.device
    n, h = int(gids.shape[0]), int(table_keys.shape[0])
    if not 1 <= h < (1 << 31):
        raise ValueError(f"hash table size {h} outside [1, 2^31)")
    if n >= 1 << 31:
        raise ValueError(f"hash_group_slots takes fewer than 2^31 rows, not {n}")
    _check_rows(table_keys, torch.int64, h, dev)
    _check_rows(gids, torch.int64, n, dev)
    _check_rows(active, torch.bool, n, dev)
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        state = torch.zeros(2, dtype=torch.int32, device=dev)
    else:
        # one scratch buffer: the two worklists' gids and rows, then the
        # state words [rows still active, rounds run, the lists' lengths,
        # any row active], all written by the kernel before it reads them
        scratch = torch.empty(3 * n + 4, dtype=torch.int64, device=dev)
        base = scratch.data_ptr()
        state = scratch[3 * n:].view(torch.int32)
        args = _HashArgs(n, h, table_keys.data_ptr(), gids.data_ptr(), active.data_ptr(),
                         slots.data_ptr(), base + 16 * n, base + 20 * n, base, base + 8 * n,
                         state.data_ptr(), max(h.bit_length() - 1, 1), min(2 * h, 1024))
        hash_group_slots.launches += 1
        launch("hash_group_slots", "gt_hash_slots", args, torch.cuda.current_stream(dev).cuda_stream)
    hash_group_slots.last_rounds = state[1:2]
    return table_keys, slots, state[0]


hash_group_slots.launches = 0
hash_group_slots.calls = 0  # calls with CUDA tensors
hash_group_slots.last_rounds = None


def last_hash_rounds() -> int:
    """The probe rounds of the last `hash_group_slots` call (a host read of
    its device word: call it after the query's readback)."""
    rounds = hash_group_slots.last_rounds
    return 0 if rounds is None else int(rounds.reshape(-1)[0])


# ---- K5: limb quantization ------------------------------------------------------
#
# The tile path's default sum/avg accumulation (query.tile_acc_dtype =
# "limb"): every value is encoded per 4096-row block as q = round(v / s)
# + 2^29 with a power-of-two-sized scale s, split into four base-256
# digits that bfloat16 holds exactly.  Per-(block, group) digit sums are
# then exact integers (K6), and the only error is quantization: at most
# s / 2 per row, which K6 bounds per group so the tile program can rerun
# in exact f64 when the bound is too loose for a group's sum.

N_LIMBS = 4
_LIMB_Q_EXP = 29
# the block exponent e = ceil(log2(max(amax, 1e-30))) ranges over these
_E_MIN, _E_MAX = -99, 1024
_LN2 = math.log(2.0)
_LN2_HI = 6.93147180369123816490e-01  # 32 significant bits: k * hi is exact
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.0 / _LN2


@functools.lru_cache(maxsize=None)
def _exp2_tables() -> tuple[np.ndarray, np.ndarray]:
    """(2^(29 - e), 2^(e - 29)) for every e, as the reference computes
    them: its exp2(x) is exp(log 2 * x) (not an exact power of two), so
    the table holds the correctly rounded exp of the rounded product —
    the values the reference's exp gives at these points."""
    ctx = decimal.Context(prec=60)

    def exp2(x: float) -> float:
        return float(ctx.exp(decimal.Decimal(_LN2 * x)))

    es = range(_E_MIN, _E_MAX + 1)
    inv = np.array([exp2(float(_LIMB_Q_EXP - e)) for e in es], np.float64)
    scale = np.array([exp2(float(e - _LIMB_Q_EXP)) for e in es], np.float64)
    return inv, scale


@functools.lru_cache(maxsize=None)
def _device_tables(dev: str) -> tuple[torch.Tensor, torch.Tensor]:
    inv, scale = _exp2_tables()
    return torch.from_numpy(inv).to(dev), torch.from_numpy(scale).to(dev)


def _tables(dev) -> tuple[torch.Tensor, torch.Tensor]:
    return _device_tables(str(dev))


def limb_exponent(amax: torch.Tensor) -> torch.Tensor:
    """The reference's ceil(log(a) * (1 / log 2)) for a >= 1e-30, as int64.

    Away from a power of two the rounded log cannot reach an integer and
    the answer is the frexp exponent; within 2^-30 of 2^k the correctly
    rounded log is k * ln2_hi + (k * ln2_lo + log1p(d)), every operation
    rounded on its own, as in csrc/quantize_limbs.cu."""
    m, E = torch.frexp(amax)
    near_lo = m < 0.75
    k = torch.where(near_lo, E - 1, E).to(torch.float64)
    d = torch.where(near_lo, 2.0 * m - 1.0, m - 1.0)
    l1p = d - (0.5 * d) * d
    L = k * _LN2_HI + (k * _LN2_LO + l1p)
    e_near = torch.ceil(L * _INV_LN2)
    return torch.where(d.abs() < 2.0**-30, e_near, E.to(torch.float64)).to(torch.int64)


def quantize_limbs_plain(values: torch.Tensor):
    """Torch-op version of K5: (limbs bfloat16 [nb, 4096, 4], scale f64 [nb])."""
    n = values.shape[0]
    if n % BLOCK_ROWS:
        raise ValueError(f"quantize_limbs needs a multiple of {BLOCK_ROWS} rows, got {n}")
    nb = n // BLOCK_ROWS
    vv = _f64(values).reshape(nb, BLOCK_ROWS)
    vv = torch.nan_to_num(vv, nan=0.0, posinf=1e308, neginf=-1e308)
    amax = vv.abs().amax(dim=1) if nb else vv.new_zeros(0)
    e = limb_exponent(torch.clamp(amax, min=1e-30)) - _E_MIN
    inv_t, scale_t = _tables(values.device)
    q = torch.round(vv * inv_t[e][:, None]).to(torch.int32) + (1 << _LIMB_Q_EXP)
    limbs = torch.stack(
        [((q >> (8 * j)) & 0xFF).to(torch.bfloat16) for j in range(N_LIMBS)], dim=-1
    )
    return limbs, scale_t[e]


class _QuantizeArgs(ctypes.Structure):
    _fields_ = [
        ("nb", ctypes.c_int64), ("values", ctypes.c_void_p),
        ("inv_tab", ctypes.c_void_p), ("scale_tab", ctypes.c_void_p),
        ("limbs", ctypes.c_void_p), ("scale", ctypes.c_void_p),
    ]


def quantize_limbs(values: torch.Tensor):
    """K5: per-block fixed-point encode of one value column (length a
    multiple of 4096).  Returns (limbs bfloat16 [nb, 4096, 4], scale f64
    [nb]).  A CUDA tensor launches csrc/quantize_limbs.cu; a CPU tensor
    runs `quantize_limbs_plain`."""
    if values.device.type == "cpu":
        return quantize_limbs_plain(values)
    from ..kernels._build import launch

    dev = values.device
    n = int(values.shape[0])
    if n % BLOCK_ROWS:
        raise ValueError(f"quantize_limbs needs a multiple of {BLOCK_ROWS} rows, got {n}")
    nb = n // BLOCK_ROWS
    x = _f64(values).contiguous()
    _check_rows(x, torch.float64, n, dev)
    inv_t, scale_t = _tables(dev)
    limbs = torch.empty((nb, BLOCK_ROWS, N_LIMBS), dtype=torch.bfloat16, device=dev)
    scale = torch.empty(nb, dtype=torch.float64, device=dev)
    a = _QuantizeArgs(nb, x.data_ptr(), inv_t.data_ptr(), scale_t.data_ptr(),
                      limbs.data_ptr(), scale.data_ptr())
    quantize_limbs.launches += 1
    launch("quantize_limbs", "gt_quantize_limbs", a, torch.cuda.current_stream(dev).cuda_stream)
    return limbs, scale


quantize_limbs.launches = 0


# ---- K6: limb segment sums -------------------------------------------------------


def _limb_q(limbs: torch.Tensor) -> torch.Tensor:
    """The int32 q of every row from its four digits ([nb, 4096])."""
    q = torch.zeros(limbs.shape[:2], dtype=torch.int32, device=limbs.device)
    for j in range(N_LIMBS):
        q = q + (limbs[:, :, j].to(torch.int32) << (8 * j))
    return q


def dequantize_limbs_plain(limbs: torch.Tensor, scale: torch.Tensor):
    """(v-hat f64 [n], half step f64 [n]): the values the digits encode,
    (q - 2^29) * s, and each row's error bound s / 2."""
    vhat = (_limb_q(limbs) - (1 << _LIMB_Q_EXP)).to(torch.float64) * scale[:, None]
    half = (scale * 0.5)[:, None].expand(limbs.shape[:2])
    return vhat.reshape(-1), half.reshape(-1).contiguous()


def _counted_rows(values, gids, mask, num_groups: int, count01, presence):
    """[C, G] int32 counts on K3: the null-gated count of every column with
    a `count01` entry, the presence row for the others; None without
    `count01`."""
    if count01 is None:
        return None
    counted = [i for i, c in enumerate(count01) if c is not None]
    rows = [presence] * len(values)
    if counted:
        cst = segment_reduce_scatter(
            [values[i] for i in counted], gids, [mask & count01[i] for i in counted], mask,
            num_groups, (COUNT,))
        for j, i in enumerate(counted):
            rows[i] = cst.counts[j]
    return torch.stack(rows)


def _limb_slow(limb_cols, gids, mask, num_groups: int, count01):
    """The guard failed: aggregate the dequantized values with the plain
    scatter (row order) — sums, error bounds, counts and presence."""
    C = len(limb_cols)
    vals, halves = [], []
    for limbs, scale in limb_cols:
        vhat, half = dequantize_limbs_plain(limbs, scale)
        vals.append(vhat)
        halves.append(half)
    st = segment_reduce_scatter_plain(vals + halves, gids, [mask] * (2 * C), mask, num_groups,
                                      (SUM, COUNT))
    presence = st.counts[0]
    counts = _counted_rows(vals, gids, mask, num_groups, count01, presence)
    return st.sums[:C], st.sums[C:], counts, presence


def limb_segment_sums_plain(limb_cols, gids, mask, num_groups: int, count01=None):
    """Torch-op version of K6 (see `limb_segment_sums`)."""
    G = int(num_groups)
    ok, base = block_guard_plain(gids, mask, G)
    if not ok:
        return _limb_slow(limb_cols, gids, mask, G, count01)
    nb = base.shape[0]
    L, K = BLOCK_ROWS, BLOCK_SPAN
    dev = gids.device
    g = gids.to(torch.int64).reshape(nb, L)
    mb = mask.reshape(nb, L)
    blk = torch.arange(nb, device=dev, dtype=torch.int64)[:, None]
    slot = torch.where(mb, blk * K + g - base.to(torch.int64)[:, None], nb * K).reshape(-1)
    window = (base.to(torch.int64)[:, None] + torch.arange(K, device=dev)).reshape(-1)

    def slot_sum(x):  # [n] int -> [nb * K] int64 exact
        p = torch.zeros(nb * K + 1, dtype=torch.int64, device=dev)
        return p.index_add_(0, slot, x.reshape(-1).to(torch.int64))[:-1]

    def fold(p):  # [nb * K] -> [G], blocks added in block order
        acc = torch.zeros(G + K, dtype=p.dtype, device=dev)
        return acc.index_add_(0, window, p)[:G]

    pres_b = slot_sum(mb)
    presence = fold(pres_b.to(torch.int32))
    counts = None
    if count01 is not None:
        counts = torch.stack([
            presence if c01 is None else fold(slot_sum(mb & c01.reshape(nb, L)).to(torch.int32))
            for c01 in count01
        ])
    pres64 = pres_b.to(torch.float64)
    sums, errs = [], []
    for limbs, scale in limb_cols:
        acc = -pres64 * float(1 << _LIMB_Q_EXP)
        for j in range(N_LIMBS):
            acc = acc + slot_sum(limbs[:, :, j].to(torch.int32)).to(torch.float64) * float(1 << (8 * j))
        sc = scale.repeat_interleave(K)
        sums.append(fold(acc * sc))
        errs.append(fold(pres64 * (sc * 0.5)))
    return torch.stack(sums), torch.stack(errs), counts, presence


_K6_MAX_COLS = 16  # kMaxCols of csrc/limb_segment_sums.cu (value and counted columns)


def _ptr_array(ptrs):
    return (ctypes.c_void_p * _K6_MAX_COLS)(*ptrs)


class _LimbArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("gids", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("limbs", ctypes.c_void_p * _K6_MAX_COLS), ("scales", ctypes.c_void_p * _K6_MAX_COLS),
        ("count01", ctypes.c_void_p * _K6_MAX_COLS), ("layout", _BlockLayout),
        ("ppres", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("psum", ctypes.c_void_p), ("perr", ctypes.c_void_p),
        ("n_cols", ctypes.c_int32), ("n_counted", ctypes.c_int32),
    ]


class _LimbFoldArgs(ctypes.Structure):
    _fields_ = [
        ("layout", _BlockLayout),
        ("ppres", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("psum", ctypes.c_void_p), ("perr", ctypes.c_void_p),
        ("presence", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("sums", ctypes.c_void_p), ("errs", ctypes.c_void_p),
        ("n_cols", ctypes.c_int32), ("n_counted", ctypes.c_int32),
        ("gate", _Gate),
    ]


class _LimbRunsArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("limbs", ctypes.c_void_p * _K6_MAX_COLS), ("scales", ctypes.c_void_p * _K6_MAX_COLS),
        ("count01", ctypes.c_void_p * _K6_MAX_COLS),
        ("presence", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("sums", ctypes.c_void_p), ("errs", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("n_cols", ctypes.c_int32),
        ("n_counted", ctypes.c_int32), ("reserved", ctypes.c_int32),
        ("gate", _Gate),
    ]


def _limb_operands(limb_cols, gids, mask, count01):
    """Checks K6's operands on the card; returns (n, nb, counted indices)."""
    dev = gids.device
    n = int(gids.shape[0])
    if n % BLOCK_ROWS or not limb_cols:
        raise ValueError("limb_segment_sums needs a multiple of 4096 rows and a column")
    nb = n // BLOCK_ROWS
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(mask, torch.bool, n, dev)
    for limbs, scale in limb_cols:
        if (limbs.device != dev or limbs.dtype != torch.bfloat16
                or tuple(limbs.shape) != (nb, BLOCK_ROWS, N_LIMBS) or not limbs.is_contiguous()
                or scale.device != dev or scale.dtype != torch.float64
                or tuple(scale.shape) != (nb,) or not scale.is_contiguous()):
            raise ValueError("limb planes must be K5 outputs of this tile's length")
    counted = [] if count01 is None else [i for i, c in enumerate(count01) if c is not None]
    for i in counted:
        _check_rows(count01[i], torch.bool, n, dev)
    return n, nb, counted


def _limb_outputs(C: int, Cc: int, G: int, dev):
    """The outputs both branches write: sums and errs (rows [:C] and [C:] of
    one [2C, G] f64 tensor), presence [G] and the counted columns' counts."""
    return (torch.empty((2 * C, G), dtype=torch.float64, device=dev),
            torch.empty(G, dtype=torch.int32, device=dev),
            torch.empty((max(Cc, 1), G), dtype=torch.int32, device=dev))


def _limb_result(sums2, presence, cnts, C: int, count01, counted):
    counts = None
    if count01 is not None:
        rows = [presence] * C
        for j, i in enumerate(counted):
            rows[i] = cnts[j]
        counts = torch.stack(rows)
    return sums2[:C], sums2[C:], counts, presence


def _launch_limb_runs(limb_cols, gids, G: int, count01, counted, order, verdict, sums2,
                      presence, cnts) -> None:
    from ..kernels._build import launch

    C, n = len(limb_cols), int(gids.shape[0])
    skeys, perm = order
    a = _LimbRunsArgs(
        n, skeys.data_ptr(), perm.data_ptr(),
        _ptr_array(lb.data_ptr() for lb, _s in limb_cols),
        _ptr_array(sc.data_ptr() for _l, sc in limb_cols),
        _ptr_array(count01[i].data_ptr() for i in counted),
        presence.data_ptr(), cnts.data_ptr(), sums2.data_ptr(), sums2[C:].data_ptr(),
        G, C, len(counted), 0, _gate(verdict, on_fail=True),
    )
    launch("limb_segment_sums", "gt_limb_runs", a, torch.cuda.current_stream(gids.device).cuda_stream)


def limb_segment_runs(limb_cols, gids, mask, num_groups: int, count01=None):
    """K6's slow branch alone on the card (what runs when the layout guard
    fails): K18's stable sort of the masked ids, then `gt_limb_runs`, a warp
    per group adding its rows' dequantized values, error bounds and counts
    in row order.  The result of `limb_segment_sums` on any layout, equal to
    `_limb_slow` (the plain version's slow branch) byte for byte."""
    if gids.device.type == "cpu":
        return _limb_slow(limb_cols, gids, mask, int(num_groups), count01)
    G = int(num_groups)
    if len(limb_cols) > _K6_MAX_COLS or (count01 is not None and len(count01) != len(limb_cols)):
        raise ValueError(f"limb_segment_runs takes up to {_K6_MAX_COLS} columns")
    _n, _nb, counted = _limb_operands(limb_cols, gids, mask, count01)
    sums2, presence, cnts = _limb_outputs(len(limb_cols), len(counted), G, gids.device)
    order = sort_segments(gids, mask, G)
    _launch_limb_runs(limb_cols, gids, G, count01, counted, order, None, sums2, presence, cnts)
    return _limb_result(sums2, presence, cnts, len(limb_cols), count01, counted)


def limb_segment_sums(limb_cols, gids, mask, num_groups: int, count01=None):
    """K6: segmented sum + count of C limb-encoded columns.

    limb_cols: C (limbs bfloat16 [nb, 4096, 4], scale f64 [nb]) from K5;
    gids int32 [n] and mask bool [n] with n = nb * 4096; count01: optional
    C-list of bool [n] non-null indicators (None entries count presence).
    Returns (sums [C, G] f64, errs [C, G] f64 — the per-group worst-case
    quantization error, counts [C, G] int32 or None, presence [G] int32).
    When the layout guard (masked ids in range, block span < 16) fails,
    the digits are dequantized and summed per group in row order — both
    branches share the quantized values, so the result does not depend on
    the branch.  A CUDA tile launches csrc/limb_segment_sums.cu: the
    per-block pass, the fold (blocks in block order) and the slow branch
    (K18's sort of the ids, then `gt_limb_runs`), each predicated on the
    guard's word on the card, into the same outputs (no host read).  A
    launch takes up to 16 value columns (their pointers ride in its
    arguments); more run as further calls over the same ids.  A CPU tile
    runs `limb_segment_sums_plain`."""
    if gids.device.type == "cpu":
        return limb_segment_sums_plain(limb_cols, gids, mask, num_groups, count01)
    if count01 is not None and len(count01) != len(limb_cols):
        raise ValueError("one count01 entry per limb column")
    if len(limb_cols) > _K6_MAX_COLS:
        parts = [
            limb_segment_sums(limb_cols[c0:c0 + _K6_MAX_COLS], gids, mask, num_groups,
                              None if count01 is None else count01[c0:c0 + _K6_MAX_COLS])
            for c0 in range(0, len(limb_cols), _K6_MAX_COLS)
        ]
        counts = None if count01 is None else torch.cat([p[2] for p in parts])
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]), counts,
                parts[0][3])
    from ..kernels._build import launch

    dev = gids.device
    n, nb, counted = _limb_operands(limb_cols, gids, mask, count01)
    C, G, Cc = len(limb_cols), int(num_groups), len(counted)
    # the [nb, 16] presence, [nb, Cc, 16] counts and [nb, C, 16] sums and
    # error bounds per block, beside the layout
    k = nb * BLOCK_SPAN
    buf, lay, (ppres, pcnt, psum, perr) = _block_layout(
        nb, G, dev, scratch=(k * 4, k * max(Cc, 1) * 4, k * C * 8, k * C * 8))
    limbs = _ptr_array(lb.data_ptr() for lb, _s in limb_cols)
    scales = _ptr_array(sc.data_ptr() for _l, sc in limb_cols)
    c01 = _ptr_array(count01[i].data_ptr() for i in counted)
    a = _LimbArgs(n, gids.data_ptr(), mask.data_ptr(), limbs, scales, c01, lay,
                  ppres, pcnt, psum, perr, C, Cc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    limb_segment_sums.launches += 1
    launch("limb_segment_sums", "gt_limb_partials", a, stream)
    verdict = _words(buf, 4 * nb, 4 * nb + 1)
    sums2, presence, cnts = _limb_outputs(C, Cc, G, dev)
    f = _LimbFoldArgs(lay, ppres, pcnt, psum, perr, presence.data_ptr(), cnts.data_ptr(),
                      sums2.data_ptr(), sums2[C:].data_ptr(), C, Cc,
                      _gate(verdict, on_fail=False))
    launch("limb_segment_sums", "gt_limb_fold", f, stream)
    # the slow branch (the guard failed): sort the ids, then the runs
    order = sort_segments(gids, mask, G, verdict)
    _launch_limb_runs(limb_cols, gids, G, count01, counted, order, verdict, sums2, presence,
                      cnts)
    return _limb_result(sums2, presence, cnts, C, count01, counted)


limb_segment_sums.launches = 0


def segment_sums_scatter(values_list, gids, mask, num_groups: int, count01=None):
    """The small-source companion of `limb_segment_sums` (memtable tails,
    chunks below the limb geometry): the same (sums, errs, counts,
    presence) tuple over the RAW values, exact (errs = 0), on K3."""
    C = len(values_list)
    st = segment_reduce_scatter(list(values_list), gids, [mask] * C, mask, num_groups,
                                (SUM, COUNT))
    presence = st.counts[0]
    counts = _counted_rows(values_list, gids, mask, num_groups, count01, presence)
    return st.sums, torch.zeros_like(st.sums), counts, presence


# ---- f64 words -------------------------------------------------------------------


_DBL_MIN = float(np.finfo(np.float64).tiny)


def pack_f64_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bits of float64 values as two int32 words (..., [hi, lo]),
    with the reference's canonicalization: every NaN becomes the quiet NaN
    with its sign kept, subnormals become a zero of their sign."""
    xf = _f64(x)
    bits = xf.contiguous().view(torch.int64)
    sign = bits & _I64_MIN
    qnan = sign | 0x7FF8000000000000
    bits = torch.where(torch.isnan(xf), qnan, bits)
    bits = torch.where(xf.abs() < _DBL_MIN, sign, bits)
    hi = (bits >> 32).to(torch.int32)
    lo = (bits & 0xFFFFFFFF).to(torch.int32)  # wraps into int32
    return torch.stack([hi, lo], dim=-1)


def unpack_f64_bits(hilo) -> np.ndarray:
    """Host inverse of `pack_f64_bits`: (..., [hi, lo]) int32 -> float64."""
    arr = np.asarray(hilo, dtype=np.int32)
    hi = arr[..., 0].astype(np.uint32).astype(np.uint64)
    lo = arr[..., 1].astype(np.uint32).astype(np.uint64)
    bits = np.ascontiguousarray((hi << np.uint64(32)) | lo)
    return bits.view(np.float64)


# ---- K7: top-k over finalized states ---------------------------------------------

TOPK_MAX_KEYS = 4
# keyed selection keeps `cap` of every 1024-candidate chunk per round
TOPK_MAX_KEYED_CAP = 512
# keyed caps up to this take the select (csrc/topk_select.cu): one launch of
# a cluster of CTAs up to TOPK_ONE_LAUNCH_GROUPS groups, past it a grid of
# _TOPK_GRID_UNITS clusters and one merge launch (tools/select_variants.py
# on the H100: one cluster was fastest up to 2^16 groups and even at 2^17,
# eight from 2^18 to 2^22); larger caps the bitonic rounds
TOPK_SELECT_CAP = 32
TOPK_ONE_LAUNCH_GROUPS = 1 << 17
_TOPK_GRID_UNITS = 8
_I64_MAX = int(np.iinfo(np.int64).max)


def _order_key(values: torch.Tensor, isnull, ascending: bool) -> torch.Tensor:
    """Int64 whose signed order is lax.sort's order of the key column
    (floats canonicalized: -0.0 == 0.0, one NaN above +inf; descending
    is -v, wrapping for int64)."""
    if values.is_floating_point():
        v = _f64(values)
        if isnull is not None:
            v = torch.where(isnull, 0.0, v)
        v = v if ascending else -v
        bits = v.contiguous().view(torch.int64)
        ordered = torch.where(bits >= 0, bits, bits ^ _I64_MAX)
        ordered = torch.where(v == 0, 0, ordered)
        return torch.where(torch.isnan(v), 0x7FF8000000000000, ordered)
    v = values.to(torch.int64)
    if isnull is not None:
        v = torch.where(isnull, 0, v)
    return v if ascending else -v  # torch int64 negation wraps


def _resolved_key(key, g: int, dev) -> tuple:
    """(values, isnull, ascending, nulls_first) of an ORDER BY key given
    either so or as (HavingRef, ascending, nulls_first)."""
    if len(key) == 3:
        ref, ascending, nulls_first = key
        values, isnull = ref.resolve(g, dev)
        return values, isnull, ascending, nulls_first
    return key


def topk_group_select_plain(mask, order_keys, cap: int):
    """Torch-op version of K7: stable sorts, least significant key first."""
    G = mask.shape[0]
    dev = mask.device
    if mask.dtype != torch.bool:
        mask = mask > 0
    keys = [torch.where(mask, 0, 1).to(torch.int64)]
    for values, isnull, ascending, nulls_first in (_resolved_key(k, G, dev) for k in order_keys):
        if isnull is not None:
            keys.append(torch.where(isnull, -1 if nulls_first else 1, 0).to(torch.int64))
        keys.append(_order_key(values, isnull, ascending))
    perm = torch.arange(G, dtype=torch.int64, device=dev)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm[:cap].to(torch.int32), mask.sum().to(torch.int32).reshape(1)


# ---- the select stage's per-group operands (csrc/group_ref.cuh), K7 and K13 ----------

_GROUP_VTYPE = {torch.float64: 0, torch.float32: 1, torch.int32: 2, torch.int64: 3,
                torch.bool: 4, torch.uint8: 4}
_NULL_PLANE = 1
_COUNT_NTYPE = {torch.int32: 2, torch.int64: 3}
_U31 = (1 << 31) - 1


class _GroupRef(ctypes.Structure):
    _fields_ = [
        ("values", ctypes.c_void_p), ("nulls", ctypes.c_void_p), ("vtype", ctypes.c_int32),
        ("ntype", ctypes.c_int32), ("nan_null", ctypes.c_int32), ("card", ctypes.c_uint32),
        ("div_mul", ctypes.c_uint32), ("div_shift", ctypes.c_uint32),
        ("card_mul", ctypes.c_uint32), ("card_shift", ctypes.c_uint32),
    ]


# a _GroupRef's two pointers, packed in one call at its offset in an array
_REF_PTRS = struct.Struct("<QQ")
_REF_SIZE = ctypes.sizeof(_GroupRef)


def _div_magic(d: int) -> tuple[int, int]:
    """(mul, shift) with n // d == (n * mul) >> shift for every 0 <= n <
    2^31 and 1 <= d < 2^31 (Granlund-Montgomery thm 4.2, N = 31: mul =
    floor(2^(31 + l) / d) + 1 with l = ceil(log2 d), below 2^32)."""
    if not 1 <= d <= _U31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    lg = (d - 1).bit_length()
    return (1 << (31 + lg)) // d + 1, 31 + lg


def _ref_structure(ref: "HavingRef") -> tuple:
    """What of a HavingRef a cached K7 / K13 structure depends on."""
    if ref.values is None:
        return ("dim", int(ref.div), max(int(ref.card), 1))
    return (ref.values.dtype, None if ref.counts is None else ref.counts.dtype,
            bool(ref.nan_null) and ref.values.is_floating_point())


def _fill_group_ref(c: _GroupRef, structure: tuple) -> None:
    """A _GroupRef's fields but its pointers, from `_ref_structure` (or a
    key's (values dtype, "plane" or None, False))."""
    if structure[0] == "dim":
        div, card = (min(x, _U31) for x in structure[1:])
        c.card = card
        c.div_mul, c.div_shift = _div_magic(div)
        c.card_mul, c.card_shift = _div_magic(card)
        return
    vdtype, nulls, nan_null = structure
    if vdtype not in _GROUP_VTYPE:
        raise ValueError(f"select-stage operand of dtype {vdtype}")
    c.vtype = _GROUP_VTYPE[vdtype]
    if nulls == "plane":
        c.ntype = _NULL_PLANE
    elif nulls is not None:
        if nulls not in _COUNT_NTYPE:
            raise ValueError(f"count plane of dtype {nulls}")
        c.ntype = _COUNT_NTYPE[nulls]
    c.nan_null = int(nan_null)


def _rows_ptr(t: torch.Tensor, g: int, dev) -> int:
    _check_rows(t, t.dtype, g, dev)
    return t.data_ptr()


class _TopkArgs(ctypes.Structure):
    _fields_ = [
        ("keys", _GroupRef * TOPK_MAX_KEYS), ("gate", ctypes.c_void_p), ("cand", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("n_out", ctypes.c_void_p), ("counts_out", ctypes.c_void_p),
        ("counts_in", ctypes.c_void_p), ("gate_type", ctypes.c_int32), ("n_keys", ctypes.c_int32),
        ("ascending", ctypes.c_int32), ("nulls_first", ctypes.c_int32), ("n_cand", ctypes.c_int32),
        ("cap", ctypes.c_int32), ("n_counts_in", ctypes.c_int32), ("units", ctypes.c_int32),
        ("num_groups", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


_TOPK_CHUNK = 1024
_GATE_TYPE = {torch.bool: 4, torch.uint8: 4, torch.int32: 2, torch.int64: 3}


def topk_launch_plan(num_groups: int, cap: int, n_keys: int) -> list[tuple[str, int]]:
    """The launches of one K7 call, in order: (entry point, grid units) —
    "compact" (one CTA), "select" (clusters of 8 CTAs) or "round" (a CTA
    a chunk of 1024 candidates)."""
    if n_keys == 0:
        return [("gt_topk_compact", 1)]
    if cap <= TOPK_SELECT_CAP:
        if num_groups <= TOPK_ONE_LAUNCH_GROUPS:
            return [("gt_topk_select", 1)]
        return [("gt_topk_select", _TOPK_GRID_UNITS), ("gt_topk_select", 1)]
    plan, n = [], num_groups
    while True:
        chunks = -(-n // _TOPK_CHUNK)
        plan.append(("gt_topk_round", chunks))
        if chunks == 1:
            return plan
        n = chunks * cap


class _TopkLayout:
    """The structure of a K7 call, built once and reused: the argument
    struct with every field but the pointers and the per-launch counts,
    the launch plan and its entry points."""

    __slots__ = ("template", "plan", "fns", "converts")

    def __init__(self, gate_dtype, structures, cap: int, g: int):
        a = _TopkArgs()
        if gate_dtype not in _GATE_TYPE:
            raise ValueError(f"topk survivor gate of dtype {gate_dtype}")
        a.gate_type = _GATE_TYPE[gate_dtype]
        a.n_keys, a.cap, a.num_groups = len(structures), cap, g
        self.converts = []
        for i, (structure, ascending, nulls_first) in enumerate(structures):
            vdtype = structure[0]
            convert = None
            if vdtype != "dim" and vdtype not in _GROUP_VTYPE:
                # taken as the parent took every key: f64 or int64
                convert = torch.float64 if vdtype.is_floating_point else torch.int64
                structure = (convert, *structure[1:])
            self.converts.append(convert)
            _fill_group_ref(a.keys[i], structure)
            a.ascending |= int(bool(ascending)) << i
            a.nulls_first |= int(bool(nulls_first)) << i
        self.template = bytes(a)
        self.plan = topk_launch_plan(g, cap, len(structures))
        self.fns = None


_TOPK_LAYOUTS: dict[tuple, _TopkLayout] = {}
_MAX_LAYOUTS = 256


def _key_structure(key) -> tuple:
    """(GroupRef structure, ascending, nulls_first) of an ORDER BY key."""
    if len(key) == 3:
        ref, ascending, nulls_first = key
        return _ref_structure(ref), bool(ascending), bool(nulls_first)
    values, isnull, ascending, nulls_first = key
    return ((values.dtype, None if isnull is None else "plane", False), bool(ascending),
            bool(nulls_first))


def _key_planes(key, convert) -> tuple:
    """(values or None, NULL or count plane or None) a key's GroupRef reads."""
    if len(key) == 3:
        ref = key[0]
        values, nulls = ref.values, ref.counts
    else:
        values, nulls = key[0], key[1]
    if convert is not None:
        values = values.to(convert)
    return values, nulls


def topk_layout(gate_dtype, order_keys: list, cap: int, g: int) -> _TopkLayout:
    """The cached `_TopkLayout` of a K7 call's structure: the gate's dtype,
    each key's form, dtypes, NULL rule, direction and dim divisors, the cap
    and G; the operands themselves are not part of it."""
    structures = tuple(_key_structure(k) for k in order_keys)
    key = (gate_dtype, structures, int(cap), int(g))
    lay = _TOPK_LAYOUTS.get(key)
    if lay is None:
        lay = _TopkLayout(gate_dtype, structures, int(cap), int(g))
        if len(_TOPK_LAYOUTS) >= _MAX_LAYOUTS:
            _TOPK_LAYOUTS.clear()
        _TOPK_LAYOUTS[key] = lay
    return lay


def _launch_cached(name: str, fn, args, stream: int) -> None:
    """One launch through an entry point a cached layout took once (K7,
    K13); raises on a launch error."""
    err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def topk_group_select(mask: torch.Tensor, order_keys: list, cap: int):
    """K7: the first `cap` groups ordered survivors first, then by each
    key with an explicit null bucket, ties broken by group id ascending —
    the order of the reference's multi-operand lax.sort.  `mask` is the
    survivor gate: bool [G], or a count plane (int32 / int64 [G], a
    survivor where > 0).  Each key is (values [G], isnull [G] bool or
    None, ascending, nulls_first), or (HavingRef, ascending, nulls_first):
    the kernel then reads the ref's planes as they lie (its count plane
    NULL where 0, NaN as NULL, or a dim coordinate of the group id).
    Returns (sel int32 [cap], n_out int32 [1], the survivor count).  A CUDA
    tensor launches csrc/topk_select.cu as `topk_launch_plan` says (keyed
    caps above TOPK_MAX_KEYED_CAP raise); the call's structure is built
    once and reused.  A CPU tensor runs `topk_group_select_plain`."""
    if mask.device.type == "cpu":
        return topk_group_select_plain(mask, order_keys, cap)
    dev = mask.device
    G = int(mask.shape[0])
    cap = int(cap)
    if not 0 < cap <= G:
        raise ValueError(f"topk cap {cap} outside (0, {G}]")
    if G > _U31:
        raise ValueError(f"topk over {G} groups: at most 2^31 - 1")
    if len(order_keys) > TOPK_MAX_KEYS or (order_keys and cap > TOPK_MAX_KEYED_CAP):
        raise ValueError(
            f"topk_select takes at most {TOPK_MAX_KEYS} keys and a keyed cap of "
            f"{TOPK_MAX_KEYED_CAP}; got {len(order_keys)} keys, cap {cap}"
        )
    lay = topk_layout(mask.dtype, order_keys, cap, G)
    if lay.fns is None:
        from ..kernels._build import load

        lib = load("topk_select")
        lay.fns = [getattr(lib, fn) for fn, _units in lay.plan]
    a = _TopkArgs.from_buffer_copy(lay.template)
    a.gate = _rows_ptr(mask, G, dev)
    keep = []  # converted planes: alive until the launches are enqueued
    for i, (key, convert) in enumerate(zip(order_keys, lay.converts)):
        values, nulls = _key_planes(key, convert)
        if convert is not None:
            keep.append(values)
        _REF_PTRS.pack_into(a, i * _REF_SIZE, 0 if values is None else _rows_ptr(values, G, dev),
                            0 if nulls is None else _rows_ptr(nulls, G, dev))
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    n_out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    topk_group_select.launches += 1  # one per call, however many launches
    plan = lay.plan
    if len(plan) == 1:
        a.out, a.n_out, a.n_cand, a.units = sel.data_ptr(), n_out.data_ptr(), G, plan[0][1]
        _launch_cached("topk_select", lay.fns[0], a, stream)
        return sel, n_out
    # more launches: the first over every group writes a list of `cap` a
    # unit and the unit's survivor count; each later one merges the lists
    first = plan[0][1]
    lists = [first * cap]
    for _fn, units in plan[1:-1]:
        lists.append(units * cap)
    scratch = torch.empty(sum(lists) + first, dtype=torch.int32, device=dev)
    base, counts = scratch.data_ptr(), scratch.data_ptr() + 4 * sum(lists)
    cand, n_cand, off = 0, G, 0
    for i, ((_fn, units), fn) in enumerate(zip(plan, lay.fns)):
        last = i == len(plan) - 1
        a.cand, a.n_cand, a.units = cand, n_cand, units
        a.out = sel.data_ptr() if last else base + 4 * off
        a.n_out = n_out.data_ptr() if last else 0
        a.counts_out = counts if i == 0 else 0
        a.counts_in, a.n_counts_in = (counts, first) if i > 0 else (0, 0)
        _launch_cached("topk_select", fn, a, stream)
        if not last:
            cand, n_cand, off = base + 4 * off, lists[i], off + lists[i]
    del keep
    return sel, n_out


topk_group_select.launches = 0


# ---- K8: finalize + pack ---------------------------------------------------------

_PACK = {"int32": 0, "bits": 1, "avg_f32": 2, "f64_words": 3, "avg_f64_words": 4,
         "raw_int32": 5, "f64_dense": 6, "avg_f64_dense": 7, "scalar_int32": 8, "verdict": 9,
         "overflow": 10}


def _avg(sums, counts):
    return sums / torch.clamp(counts, min=1)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def pack_result_plain(int_rows, acc32_rows, acc64_rows, bit_packed: bool, sel=None,
                      n_out=None, verdict_rows=None, overflow=None):
    """Torch-op version of K8 (see `pack_result`)."""

    def pick(row):
        return row if sel is None else row[sel.to(torch.int64)]

    def value(spec):
        return spec[1] if spec[0] == "value" else _avg(spec[1], spec[2])

    parts = []
    if bit_packed:
        for row in int_rows:
            g = row.shape[0]
            gp = -(-g // 8) * 8
            bits = torch.zeros(gp, dtype=torch.int32, device=row.device)
            bits[:g] = (row > 0).to(torch.int32)
            w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=row.device)
            parts.append((bits.reshape(-1, 8) * w).sum(dim=1).to(torch.uint8))
    else:
        parts.extend(_as_bytes(pick(row.to(torch.int32))) for row in int_rows)
    parts.extend(_as_bytes(pick(_avg(s, c)).to(torch.float32)) for s, c in acc32_rows)
    if sel is not None:
        parts.append(_as_bytes(sel.to(torch.int32)))
        parts.append(_as_bytes(n_out.to(torch.int32).reshape(1)))
        parts.extend(_as_bytes(pack_f64_bits(pick(value(spec)))) for spec in acc64_rows)
    if verdict_rows is not None:
        ok = torch.ones((), dtype=torch.bool, device=parts[0].device)
        for err, s in verdict_rows:
            lim = torch.maximum(s.abs() * 1e-7, torch.full_like(s, 1e-12))
            ok = ok & (err <= lim).all()
        parts.append(ok.to(torch.uint8).reshape(1))
    if overflow is not None:
        parts.append((overflow.reshape(1) > 0).to(torch.uint8))
    buf = torch.cat(parts) if len(parts) > 1 else parts[0]
    if sel is not None:
        return (buf,)
    G = int_rows[0].shape[0]
    if acc64_rows:
        accs64 = torch.stack([_f64(value(spec)) for spec in acc64_rows])
    else:
        accs64 = torch.zeros((0, G), dtype=torch.float64, device=buf.device)
    return buf, accs64


_PACK_MAX_ROWS = 64  # kMaxRows of csrc/pack_result.cu
_PACK_WORDS_PER_CTA = 256 * 4  # kWordsPerCta: elements a CTA of a word or verdict row
_PACK_BITS_PER_CTA = 256 * 32  # kBitsPerCta: groups a CTA of a bit row


class _PackRow(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("align", ctypes.c_int32), ("n", ctypes.c_int64),
                ("out", ctypes.c_int64)]


class _PackDesc(ctypes.Structure):
    # mirrored field for field by PackDesc in csrc/pack_result.cu
    _fields_ = [
        ("desc_bytes", ctypes.c_int32), ("n_rows", ctypes.c_int32), ("verdict_at", ctypes.c_int64),
        ("sel", ctypes.c_void_p), ("buf", ctypes.c_void_p), ("accs64", ctypes.c_void_p),
        ("blk_end", ctypes.c_uint32 * _PACK_MAX_ROWS), ("rows", _PackRow * _PACK_MAX_ROWS),
        ("ptrs", ctypes.c_void_p * (2 * _PACK_MAX_ROWS)),
    ]


_PACK_HEAD = struct.Struct("<QQQ")  # sel, buf, accs64
_PACK_HEAD_AT = _PackDesc.sel.offset
_PACK_PTRS_AT = _PackDesc.ptrs.offset


@dataclass(frozen=True)
class PackLayout:
    """What a result's structure decides for K8, built once per structure
    (`pack_layout`): the rows (kind code, elements, byte offset in buf or
    row of accs64, alignment of that offset) in launch order, the buffer's
    bytes, the accs64 rows, the verdict byte (-1: none), the launches
    (`pack_launch_plan`) and each launch's descriptor without its
    pointers."""

    rows: tuple
    nbytes: int
    n64: int
    verdict_at: int
    launches: tuple
    templates: tuple
    ptr_packers: tuple


def pack_launch_plan(n_rows: int) -> list[tuple[int, int]]:
    """K8's launches for a result of `n_rows` rows: [lo, hi) ranges of whole
    rows, in row order, at most the descriptor's 64 rows each (one launch
    for every result the tile program builds from up to 63 columns)."""
    return [(lo, min(lo + _PACK_MAX_ROWS, n_rows)) for lo in range(0, n_rows, _PACK_MAX_ROWS)]


def _pack_align(out: int) -> int:
    return 8 if out % 8 == 0 else 4 if out % 4 == 0 else 1


def _pack_ctas(kind: int, n: int) -> int:
    if kind == _PACK["bits"]:
        return -(-n // _PACK_BITS_PER_CTA)
    if kind in (_PACK["scalar_int32"], _PACK["overflow"]):
        return 1
    return -(-n // _PACK_WORDS_PER_CTA)


@functools.lru_cache(maxsize=256)
def pack_layout(bit_packed: bool, compact: bool, n_int: int, n_acc32: int, acc64: tuple,
                n_verdict: int, overflow: bool, n: int, G: int) -> PackLayout:
    """K8's layout of one result structure (a pure function, cached): the
    byte layout `pack_result_plain` produces, row by row.  `acc64` gives
    each f64 row's kind ("value" or "avg"), `n_verdict` the verdict rows
    (-1: no verdict byte), `n` the elements of a gathered row (the
    selection's cap on the compact path, else G)."""
    if compact and bit_packed:
        raise ValueError("the compact result is never bit-packed")
    rows, off = [], 0

    def row(kind, elems, out):
        rows.append((_PACK[kind], elems, out, _pack_align(out)))

    for _ in range(n_int):
        if bit_packed:
            row("bits", G, off)
            off += -(-G // 8)
        else:
            row("int32", n, off)
            off += 4 * n
    for _ in range(n_acc32):
        row("avg_f32", n, off)
        off += 4 * n
    if compact:
        row("raw_int32", n, off)
        off += 4 * n
        row("scalar_int32", 1, off)
        off += 4
    for i, kind in enumerate(acc64):
        if kind not in ("value", "avg"):
            raise ValueError(f"an f64 row is 'value' or 'avg', not {kind!r}")
        name = ("f64_words" if kind == "value" else "avg_f64_words") if compact else (
            "f64_dense" if kind == "value" else "avg_f64_dense")
        if compact:
            row(name, n, off)
            off += 8 * n
        else:
            rows.append((_PACK[name], G, i, 8))
    verdict_at = -1
    if n_verdict >= 0:
        verdict_at = off
        for _ in range(n_verdict):
            row("verdict", G, off)
        off += 1
    if overflow:
        row("overflow", 1, off)
        off += 1
    launches = tuple(pack_launch_plan(len(rows)))
    templates, packers = [], []
    for li, (lo, hi) in enumerate(launches):
        d = _PackDesc()
        d.desc_bytes, d.n_rows = ctypes.sizeof(_PackDesc), hi - lo
        d.verdict_at = verdict_at if li == 0 else -1
        blocks = 0
        for j, (kind, elems, out, align) in enumerate(rows[lo:hi]):
            blocks += _pack_ctas(kind, elems)
            d.blk_end[j] = blocks
            d.rows[j] = _PackRow(kind, align, elems, out)
        templates.append(bytes(d))
        packers.append(struct.Struct(f"<{2 * (hi - lo)}Q"))
    return PackLayout(tuple(rows), off, 0 if compact else len(acc64), verdict_at, launches,
                      tuple(templates), tuple(packers))


def pack_result(int_rows, acc32_rows, acc64_rows, bit_packed: bool, sel=None, n_out=None,
                verdict_rows=None, overflow=None):
    """K8: finalize merged [G] states into the tile program's result.

    int_rows: int32 [G] rows (presence, null-gated counts), shipped as
    int32 or, with `bit_packed`, as 1 bit per group MSB-first;
    acc32_rows: (sums f64 [G], counts int32 [G]) shipped as f32 averages;
    acc64_rows: ("value", f64 [G]) or ("avg", sums, counts) f64 rows;
    sel/n_out: K7's selection, int32 [cap] and [1] (the compact path: every
    row is gathered by `sel`, the f64 rows join the byte buffer as [hi, lo]
    int32 words);
    verdict_rows: (errs f64 [G], sums f64 [G]) of the limb columns,
    appending one byte, 1 iff every err <= max(|sum| * 1e-7, 1e-12);
    overflow: the hash plan's int32 [1] count of rows that found no slot,
    appending one byte, 1 iff it is > 0.
    Returns (buf uint8,) on the compact path, else (buf, accs64 [K, G]).
    A CUDA tensor launches csrc/pack_result.cu, once for up to 64 rows
    (`pack_launch_plan`); the operands are read where they lie, so each
    must have its dtype above (a wrong one raises); a CPU tensor runs
    `pack_result_plain`."""
    first = int_rows[0]
    if first.device.type == "cpu":
        return pack_result_plain(int_rows, acc32_rows, acc64_rows, bit_packed, sel, n_out,
                                 verdict_rows, overflow)
    dev = first.device
    G = int(first.shape[0])
    compact = sel is not None
    n = int(sel.shape[0]) if compact else G
    layout = pack_layout(bool(bit_packed), compact, len(int_rows), len(acc32_rows),
                         tuple(spec[0] for spec in acc64_rows),
                         -1 if verdict_rows is None else len(verdict_rows), overflow is not None,
                         n, G)
    didx = first.get_device()
    checked: dict = {}

    def ptr(t, dtype, elems):
        key = (id(t), dtype, elems)  # a tensor passed as several rows is checked once
        p = checked.get(key)
        if p is None:
            if (t.dtype is not dtype or t.numel() != elems or t.get_device() != didx
                    or not t.is_contiguous()):
                raise ValueError(f"K8 operand must be a contiguous {dtype} of {elems} elements "
                                 f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
            p = checked[key] = t.data_ptr()
        return p

    ptrs = pack_operands(int_rows, acc32_rows, acc64_rows, sel, n_out, verdict_rows, overflow,
                         ptr, G, n)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    accs64 = None if compact else torch.empty((layout.n64, G), dtype=torch.float64, device=dev)
    _pack_on_card(layout, ptrs, ptr(sel, torch.int32, n) if compact else 0, buf.data_ptr(),
                  0 if accs64 is None or accs64.numel() == 0 else accs64.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return (buf,) if compact else (buf, accs64)


def pack_operands(int_rows, acc32_rows, acc64_rows, sel, n_out, verdict_rows, overflow, ptr,
                  G: int, n: int) -> list:
    """The (a, b) operands of each row of `pack_layout`, in row order, as
    ptr(tensor, dtype, elements) gives them (0 for a row's missing b)."""
    i32, f64 = torch.int32, torch.float64
    ptrs = []
    for row in int_rows:
        ptrs += (ptr(row, i32, G), 0)
    for s, c in acc32_rows:
        ptrs += (ptr(s, f64, G), ptr(c, i32, G))
    if sel is not None:
        ptrs += (ptr(sel, i32, n), 0, ptr(n_out, i32, 1), 0)
    for spec in acc64_rows:
        ptrs += (ptr(spec[1], f64, G), 0 if spec[0] == "value" else ptr(spec[2], i32, G))
    for err, s in verdict_rows or ():
        ptrs += (ptr(err, f64, G), ptr(s, f64, G))
    if overflow is not None:
        ptrs += (ptr(overflow, i32, 1), 0)
    return ptrs


def pack_descriptors(layout: PackLayout, ptrs: list, sel: int, buf: int,
                     accs64: int) -> list[bytearray]:
    """The `PackDesc` of each of a call's launches: the layout's cached
    template with the call's pointers written in (row r of a launch reads
    its ptrs[2r] and ptrs[2r + 1])."""
    out = []
    for (lo, hi), template, packer in zip(layout.launches, layout.templates, layout.ptr_packers):
        raw = bytearray(template)
        _PACK_HEAD.pack_into(raw, _PACK_HEAD_AT, sel, buf, accs64)
        packer.pack_into(raw, _PACK_PTRS_AT, *ptrs[2 * lo:2 * hi])
        out.append(raw)
    return out


def _pack_on_card(layout: PackLayout, ptrs: list, sel: int, buf: int, accs64: int,
                  stream: int) -> None:
    """K8's launches of one call, as `pack_launch_plan` splits its rows."""
    from ..kernels._build import launch

    for raw in pack_descriptors(layout, ptrs, sel, buf, accs64):
        pack_result.launches += 1
        launch("pack_result", "gt_pack_result", _PackDesc.from_buffer(raw), stream)


pack_result.launches = 0



# ---- K13: HAVING on the card -------------------------------------------------------


@dataclass(eq=False)
class HavingRef:
    """What a HAVING tree's ref reads, per group: an aggregate output
    `values` [G] (NULL where `counts` [G] is 0 and, with `nan_null`, where
    the value is NaN), or, with `values` None, the group's dimension
    coordinate (gid // div) % card."""

    values: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    nan_null: bool = False
    div: int = 1
    card: int = 1

    def resolve(self, g: int, dev):
        """(value [G], isnull [G] | None) over G groups on `dev`."""
        if self.values is None:
            gid = torch.arange(g, dtype=torch.int64, device=dev)
            return (gid // self.div) % self.card, None
        isnull = None if self.counts is None else self.counts == 0
        if self.nan_null and self.values.is_floating_point():
            nan = torch.isnan(self.values)
            isnull = nan if isnull is None else isnull | nan
        return self.values, isnull


def having_refs(tree) -> list:
    """The refs of an encoded HAVING tree, in order of first use."""
    out: list = []

    def walk(node):
        kind = node[0]
        if kind in ("and", "or", "not"):
            for child in node[1:]:
                walk(child)
            return
        found = {"cmp": node[2:3], "cmpref": node[2:4], "isnull": node[1:2]}[kind]
        out.extend(r for r in found if r not in out)

    walk(tree)
    return out


_HAVING_CMP = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_HAVING_MAX_REFS, _HAVING_MAX_CODE, _HAVING_MAX_STACK = 16, 64, 16


def having_mask_plain(tree, refs: dict, values: torch.Tensor, presence: torch.Tensor):
    """Torch-op version of K13: the reference's Kleene evaluation of the
    encoded tree (ops/aggregate.py `having_mask`) ANDed with presence > 0.
    `refs` maps each ref of the tree to its HavingRef; `values` holds the
    comparison literals by slot (f64)."""
    g = int(presence.shape[0])
    dev = presence.device
    ones = torch.ones(g, dtype=torch.bool, device=dev)

    def ev(node):
        kind = node[0]
        if kind in ("cmp", "cmpref"):
            if kind == "cmp":
                _k, op, ref, slot = node
                x, xnull = refs[ref].resolve(g, dev)
                y, ynull = values[slot], None
            else:
                _k, op, ref1, ref2 = node
                x, xnull = refs[ref1].resolve(g, dev)
                y, ynull = refs[ref2].resolve(g, dev)
            x = x.to(torch.float64)
            y = y.to(torch.float64)
            v = {
                "=": lambda: x == y, "!=": lambda: x != y, "<": lambda: x < y,
                "<=": lambda: x <= y, ">": lambda: x > y, ">=": lambda: x >= y,
            }[op]()
            valid = ones
            if xnull is not None:
                valid = valid & ~xnull
            if ynull is not None:
                valid = valid & ~ynull
            return v, valid
        if kind == "isnull":
            _k, ref, neg = node
            _v, isn = refs[ref].resolve(g, dev)
            isn = torch.zeros(g, dtype=torch.bool, device=dev) if isn is None else isn
            return (~isn if neg else isn), ones
        if kind == "not":
            v, valid = ev(node[1])
            return ~v, valid
        av, avalid = ev(node[1])
        bv, bvalid = ev(node[2])
        if kind == "and":
            return av & bv, (avalid & bvalid) | (avalid & ~av) | (bvalid & ~bv)
        return av | bv, (avalid & bvalid) | (avalid & av) | (bvalid & bv)

    v, valid = ev(tree)
    return v & valid & (presence > 0)


class _HavingArgs(ctypes.Structure):
    _fields_ = [
        ("refs", _GroupRef * _HAVING_MAX_REFS),
        ("code", (ctypes.c_int16 * 4) * _HAVING_MAX_CODE),
        ("literals", ctypes.c_void_p), ("presence", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("ptype", ctypes.c_int32), ("n_code", ctypes.c_int32), ("num_groups", ctypes.c_int32),
        ("reserved", ctypes.c_int32),
    ]


_HAVING_TAIL = struct.Struct("<QQQ")  # literals, presence, out
_HAVING_TAIL_AT = _HavingArgs.literals.offset


@functools.lru_cache(maxsize=256)
def _having_program(tree) -> tuple[tuple, tuple]:
    """Postfix code ((op, a, b, c), ...) and the refs it indexes, in order
    of first use; raises when the tree exceeds the kernel's fixed tables.
    Built once per tree."""
    order = having_refs(tree)
    ref_index = order.index
    code: list = []

    def depth_of(node) -> int:
        if node[0] in ("cmp", "cmpref", "isnull"):
            return 1
        if node[0] == "not":
            return depth_of(node[1])
        return max(depth_of(node[1]), 1 + depth_of(node[2]))

    def emit(node):
        kind = node[0]
        if kind == "cmp":
            code.append((0, _HAVING_CMP[node[1]], ref_index(node[2]), int(node[3])))
        elif kind == "cmpref":
            code.append((1, _HAVING_CMP[node[1]], ref_index(node[2]), ref_index(node[3])))
        elif kind == "isnull":
            code.append((2, ref_index(node[1]), int(bool(node[2])), 0))
        elif kind == "not":
            emit(node[1])
            code.append((3, 0, 0, 0))
        elif kind in ("and", "or"):
            emit(node[1])
            emit(node[2])
            code.append((4 if kind == "and" else 5, 0, 0, 0))
        else:
            raise ValueError(f"unknown HAVING node {kind!r}")

    emit(tree)
    if len(code) > _HAVING_MAX_CODE or len(order) > _HAVING_MAX_REFS \
            or depth_of(tree) > _HAVING_MAX_STACK or any(not 0 <= w < 1 << 15 for c in code
                                                         for w in c):
        raise ValueError(
            f"HAVING program of {len(code)} ops over {len(order)} refs exceeds K13's "
            f"tables ({_HAVING_MAX_CODE} ops, {_HAVING_MAX_REFS} refs, stack "
            f"{_HAVING_MAX_STACK}, literal slots below 2^15)"
        )
    return tuple(code), tuple(order)


def having_fits(tree) -> bool:
    """Whether K13's fixed tables hold the tree (the planner leaves a
    larger HAVING to the host)."""
    try:
        _having_program(tree)
    except ValueError:
        return False
    return True


class _HavingLayout:
    """The structure of a K13 call, built once and reused: the argument
    struct with its program, the refs' kinds and dim multipliers and the
    presence type filled in (every field but the pointers and G), and the
    refs in the program's order."""

    __slots__ = ("template", "order", "fn")

    def __init__(self, tree, structures: tuple, presence_dtype):
        code, self.order = _having_program(tree)
        a = _HavingArgs()
        for i, structure in enumerate(structures):
            _fill_group_ref(a.refs[i], structure)
        for i, ins in enumerate(code):
            for j, w in enumerate(ins):
                a.code[i][j] = w
        if presence_dtype not in _COUNT_NTYPE:
            raise ValueError(f"presence of dtype {presence_dtype}")
        a.ptype, a.n_code = _GROUP_VTYPE[presence_dtype], len(code)
        self.template = bytes(a)
        self.fn = None


_HAVING_LAYOUTS: dict[tuple, _HavingLayout] = {}


def having_layout(tree, refs: dict, presence_dtype) -> _HavingLayout:
    """The cached `_HavingLayout` of a K13 call's structure: the tree and,
    for each of its refs, its form, dtypes, NULL rule and dim divisors; the
    literals and the operands themselves are not part of it."""
    order = _having_program(tree)[1]
    key = (tree, presence_dtype, tuple(_ref_structure(refs[r]) for r in order))
    lay = _HAVING_LAYOUTS.get(key)
    if lay is None:
        lay = _HavingLayout(tree, key[2], presence_dtype)
        if len(_HAVING_LAYOUTS) >= _MAX_LAYOUTS:
            _HAVING_LAYOUTS.clear()
        _HAVING_LAYOUTS[key] = lay
    return lay


def having_mask(tree, refs: dict, values: torch.Tensor, presence: torch.Tensor):
    """K13: bool [G] keep mask of the encoded HAVING tree (the reference's
    query/device_finalize.py encoding: cmp / cmpref / isnull / not / and /
    or) with SQL's three-valued logic, ANDed with presence > 0 — the
    survivor mask K7 takes.  `refs` maps each ref to a HavingRef; `values`
    holds the literals by slot (read on the card where it lies).  A CUDA
    tensor launches csrc/having_mask.cu with the tree as a postfix program
    passed by value, its structure built once and reused; a CPU tensor
    runs `having_mask_plain`."""
    if presence.device.type == "cpu":
        return having_mask_plain(tree, refs, values, presence)
    dev = presence.device
    g = int(presence.shape[0])
    if g > _U31:
        raise ValueError(f"HAVING over {g} groups: at most 2^31 - 1")
    lay = having_layout(tree, refs, presence.dtype)
    if lay.fn is None:
        from ..kernels._build import load

        lay.fn = load("having_mask").gt_having_mask
    a = _HavingArgs.from_buffer_copy(lay.template)
    for i, name in enumerate(lay.order):
        r = refs[name]
        if r.values is not None:
            _REF_PTRS.pack_into(a, i * _REF_SIZE, _rows_ptr(r.values, g, dev),
                                0 if r.counts is None else _rows_ptr(r.counts, g, dev))
    lits = values
    if lits.device != dev or lits.dtype != torch.float64 or not lits.is_contiguous():
        lits = values.to(device=dev, dtype=torch.float64).contiguous()
    if lits.numel() == 0:
        lits = torch.zeros(1, dtype=torch.float64, device=dev)
    out = torch.empty(g, dtype=torch.bool, device=dev)  # one byte a group, 0 or 1
    _HAVING_TAIL.pack_into(a, _HAVING_TAIL_AT, lits.data_ptr(), _rows_ptr(presence, g, dev),
                           out.data_ptr())
    a.num_groups = g
    having_mask.launches += 1
    _launch_cached("having_mask", lay.fn, a, torch.cuda.current_stream(dev).cuda_stream)
    return out


having_mask.launches = 0


# ---- K22: the mesh fold of partial states ---------------------------------------------
#
# B20 (the reference's `psum_states` and its mesh merges): the partial
# states of one AggState key from M = D * n_local sources, gathered on the
# first mesh slot as [M, rows] (source m on slot m // n_local, dummies
# included), folded into one [rows] state.  `order` lists the rows of the
# real sources in global source order.  See csrc/fold_states.cu for the
# rules each field follows.

_FOLD_KINDS = {"sums": 1, "counts": 2, "mins": 3, "maxs": 4}
_FOLD_DTYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}
_FOLD_RULES = {"fold": 0, "psum": 1}


def _ieee_min(a, b):
    """jnp.minimum as the reference's CPU backend computes it (LLVM's x86
    lowering): the operands ordered by the first one's sign, MINSD (the
    second on a NaN or a tie), the first ordered one when it is a NaN.
    -0 < +0; a NaN propagates unquieted."""
    pos = ~torch.signbit(a)
    x, y = torch.where(pos, a, b), torch.where(pos, b, a)
    return torch.where(torch.isnan(x), x, torch.where(x < y, x, y))


def _ieee_max(a, b):
    """jnp.maximum, as `_ieee_min` with the sign test and MAXSD."""
    neg = torch.signbit(a)
    x, y = torch.where(neg, a, b), torch.where(neg, b, a)
    return torch.where(torch.isnan(x), x, torch.where(x > y, x, y))


def _add_x86(a, b):
    """a + b with the NaN rules of x86 (the reference's CPU backend), which
    K22 follows on the card too: a NaN operand comes out quieted (the first
    when both are), an invalid sum is the sign-set default NaN."""
    if not a.dtype.is_floating_point:
        return a + b
    if a.dtype == torch.float64:
        bits, quiet, default = torch.int64, 1 << 51, 0xFFF8000000000000 - (1 << 64)
    else:
        bits, quiet, default = torch.int32, 1 << 22, 0xFFC00000 - (1 << 32)
    default = torch.tensor(default, dtype=bits).view(a.dtype)

    def quieted(x):
        return (x.view(bits) | quiet).view(a.dtype)

    r = a + b
    r = torch.where(torch.isnan(r), default.to(r.device), r)
    r = torch.where(torch.isnan(b), quieted(b), r)
    return torch.where(torch.isnan(a), quieted(a), r)


def _coll_max(acc, b):
    """XLA CPU pmax across slots (psum_states' LAST): NaN skipped, ties
    keep acc."""
    out = torch.where(b > acc, b, acc)
    out = torch.where(torch.isnan(b), acc, out)
    return torch.where(torch.isnan(acc), b, out)


def _type_max(dtype) -> float | int:
    return (torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)).max


def _fold_dense_plain(name, g, order, rule: str):
    if name == "sums":
        acc = g[order[0]].clone()
        for k in order[1:]:
            # psum keeps the later source's NaN where two meet, the fold the
            # earlier one's: the same sum otherwise
            acc = _add_x86(g[k], acc) if rule == "psum" else _add_x86(acc, g[k])
        return acc
    if name == "counts":
        return g.sum(0, dtype=g.dtype)
    op = _ieee_min if name == "mins" else _ieee_max
    acc = g[0].clone()
    for m in range(1, g.shape[0]):
        acc = op(acc, g[m])
    return acc


def _fold_keyed_plain(name, g, n_local: int, order, inv):
    rows = g.shape[1]
    h = inv.shape[1]
    top = _type_max(g.dtype)
    fill = {"mins": top, "maxs": -top}.get(name, 0)
    acc = torch.full((rows,), fill, dtype=g.dtype, device=g.device)
    # the scatter's add keeps the update's NaN where two meet
    op = {"mins": _ieee_min, "maxs": _ieee_max}.get(name, lambda a, v: _add_x86(v, a))
    for m in order:
        j = inv[m // n_local].to(torch.int64)
        hit = j >= 0
        v = g[m].index_select(0, j.clamp(min=0))
        acc[:h] = torch.where(hit, op(acc[:h], v), acc[:h])
        if rows > h:
            acc[h:] = op(acc[h:], g[m, h:])
    return acc


def _last_plain(ts, val, order, rule: str):
    if rule == "fold":
        lt, lv = ts[order[0]].clone(), val[order[0]].clone()
        for k in order[1:]:
            bt, bv = ts[k], val[k]
            lv = torch.where(bt >= lt, bv, lv)
            lt = torch.maximum(lt, bt)
        return lt, lv
    lt = ts.amax(0)
    lv = None
    for m in range(ts.shape[0]):
        c = torch.where(ts[m] == lt, val[m], torch.full_like(val[m], -_DBL_MAX))
        lv = c if lv is None else _coll_max(lv, c)
    return lt, lv


def stack_states(states: list, dev) -> AggState:
    """The gather before a fold: one key's partial states from M sources,
    each field stacked [M, rows] on `dev` (plumbing: copies only)."""
    first = states[0]
    return AggState(**{
        f.name: torch.stack([getattr(st, f.name).to(dev) for st in states])
        for f in fields(first) if getattr(first, f.name) is not None
    })


def _fold_check(state: AggState, n_local: int, order, inv, rule: str):
    m = next(getattr(state, f.name) for f in fields(state)
             if getattr(state, f.name) is not None).shape[0]
    if n_local < 1 or m % n_local or not order:
        raise ValueError(f"fold of {m} sources at {n_local} per slot, {len(order)} real")
    if rule not in _FOLD_RULES:
        raise ValueError(f"fold rule {rule!r}: use 'fold' or 'psum'")
    if inv is not None and state.last_ts is not None:
        raise ValueError("a keyed fold has no LAST states")
    return m


def fold_states_plain(state: AggState, n_local: int, order, inv=None,
                      rule: str = "fold") -> AggState:
    """Torch-op version of K22 (see `fold_states`), field for field the
    reference's fold."""
    _fold_check(state, n_local, order, inv, rule)
    order = [int(k) for k in order]
    out = AggState()
    for name in _FOLD_KINDS:
        g = getattr(state, name)
        if g is not None:
            setattr(out, name, _fold_dense_plain(name, g, order, rule) if inv is None
                    else _fold_keyed_plain(name, g, n_local, order, inv))
    if state.last_ts is not None:
        out.last_ts, out.last_val = _last_plain(state.last_ts, state.last_val, order, rule)
    return out


def invert_slot_maps_plain(slot_map: torch.Tensor) -> torch.Tensor:
    """inv[d, u] = the row j of slot d's table with slot_map[d, j] == u < H,
    else -1 (each device table holds distinct keys, so it is injective)."""
    d, h = slot_map.shape
    inv = torch.full((d, h), -1, dtype=torch.int32, device=slot_map.device)
    rows = torch.arange(h, dtype=torch.int32, device=slot_map.device)
    for i in range(d):
        sm = slot_map[i].to(torch.int64)
        ok = (sm >= 0) & (sm < h)
        inv[i, sm[ok]] = rows[ok]
    return inv


# The descriptor of one K22 launch (csrc/fold_states.cu's FoldDesc), passed
# by value in the kernel's parameter space: its capacity fills sm_90's
# 32,764 bytes.  Field f of a key is bit f of `present`, in _FOLD_FIELDS
# order; per present field `ptrs` holds its output, then its M sources.  A
# staged launch (more real sources or pointers than the descriptor holds)
# has its pointers, each real source's row of inv and `order` in a device
# table (`table`) instead.
_FOLD_FIELDS = ("sums", "counts", "mins", "maxs", "last_ts", "last_val")
_FOLD_MAX_KEYS = 64
_FOLD_MAX_ORDER = 512
_FOLD_MAX_PTRS = 3734
_FOLD_THREADS = 256
_FOLD_ALIGN = 16  # between the merge's outputs of one type and the next
_FOLD_ELEM = {torch.float64: 8, torch.float32: 4, torch.int64: 8, torch.int32: 4}
_FOLD_KEY = struct.Struct("<qiBB4B6x")  # a _FoldKey


class _FoldKey(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64), ("ptr0", ctypes.c_int32), ("present", ctypes.c_uint8),
                ("keyed", ctypes.c_uint8), ("dtype", ctypes.c_uint8 * 4),
                ("reserved", ctypes.c_uint8 * 6)]


class _FoldDesc(ctypes.Structure):
    _fields_ = [
        ("desc_bytes", ctypes.c_int32), ("n_keys", ctypes.c_int32), ("m", ctypes.c_int32),
        ("n_local", ctypes.c_int32), ("n_order", ctypes.c_int32), ("rule", ctypes.c_int32),
        ("n_ptrs", ctypes.c_int32), ("n_slots", ctypes.c_int32), ("h", ctypes.c_int64),
        ("total_rows", ctypes.c_int64), ("n_blocks", ctypes.c_int64), ("inv", ctypes.c_void_p),
        ("table", ctypes.c_void_p),
        ("blk_end", ctypes.c_uint32 * _FOLD_MAX_KEYS), ("keys", _FoldKey * _FOLD_MAX_KEYS),
        ("order", ctypes.c_uint16 * _FOLD_MAX_ORDER), ("ptrs", ctypes.c_void_p * _FOLD_MAX_PTRS),
    ]


class _InvertArgs(ctypes.Structure):
    _fields_ = [("slot_map", ctypes.c_void_p), ("inv", ctypes.c_void_p), ("h", ctypes.c_int64),
                ("d", ctypes.c_int32), ("reserved", ctypes.c_int32)]


_FOLD_PTRS_AT = _FoldDesc.ptrs.offset


def fold_launch_plan(keys, m: int, n_order: int) -> list[list[tuple[str, tuple]]]:
    """K22's launches for one merge (a pure function of its shape).

    keys: (key, fields) in the merge's key order, `fields` the names of
    the key's present fields; m: the sources; n_order: the real ones.
    Returns the launches, each a list of whole keys (key, fields) in key
    order.  A launch closes at the descriptor's 64 keys, or where the next
    key would pass its 3734 pointers (one output and m sources a field); a
    key past them alone has a launch of its own.  Past the descriptor's
    512 real sources every launch is staged (`fold_launch_staged`) and only
    the key cap closes one."""
    per = int(m) + 1
    by_keys = n_order > _FOLD_MAX_ORDER
    launches, cur, used = [], [], 0
    for key, fields_ in keys:
        need = len(fields_) * per
        if cur and (len(cur) == _FOLD_MAX_KEYS or (not by_keys and used + need > _FOLD_MAX_PTRS)):
            launches.append(cur)
            cur, used = [], 0
        cur.append((key, tuple(fields_)))
        used += need
    if cur:
        launches.append(cur)
    return launches


def fold_launch_staged(units, m: int, n_order: int) -> bool:
    """Whether a launch of `fold_launch_plan` passes the descriptor, so that
    its pointers, rows of inv and `order` go in a device table."""
    return (n_order > _FOLD_MAX_ORDER
            or sum(len(f) for _k, f in units) * (int(m) + 1) > _FOLD_MAX_PTRS)


def _fold_args_check(m: int, n_local: int, order, rule: str) -> list[int]:
    order = [int(k) for k in order]
    if n_local < 1 or m % n_local or not order:
        raise ValueError(f"fold of {m} sources at {n_local} per slot, {len(order)} real")
    if rule not in _FOLD_RULES:
        raise ValueError(f"fold rule {rule!r}: use 'fold' or 'psum'")
    if min(order) < 0 or max(order) >= m:
        raise ValueError(f"fold order {order} names a source outside the {m} sources")
    return order


def _fold_on_card(dev, didx: int, items, m: int, n_local: int, order, inv, rule: str,
                  stream: int) -> dict:
    """Every key of a merge through K22 on `dev` (on `stream`), in the
    launches of `fold_launch_plan` (one when the descriptor holds them all).

    items: (key, {field: M per-source 1-D tensors}, keyed) in key order;
    `didx` is `dev`'s index as `Tensor.get_device` gives it.  A source on
    another device is copied to `dev`; the rest are read in place.  The
    merged fields are views of one allocation.  What follows from the
    merge's structure alone (the outputs' layout, the descriptors but
    their pointers, the launch plan) is built once per structure
    (`_fold_layout`); a staged launch's table is copied to the card per
    call.  Returns {key: AggState}."""
    h = 0
    if inv is not None:
        _check_rows(inv.reshape(-1), torch.int32, inv.numel(), inv.device)
        if inv.get_device() != didx or inv.dim() != 2 or inv.shape[0] * n_local != m:
            raise ValueError(f"K22 keyed: inv {tuple(inv.shape)} on {inv.device} for {m} "
                             f"sources on {dev}")
        h = int(inv.shape[1])
    # per call: each field's sources, checked, and their row bases
    keep, shape, src_ptrs = [], [], []
    for key, per_field, keyed in items:
        rows, fields_, ptrs = None, [], []
        for f, name in enumerate(_FOLD_FIELDS):
            srcs = per_field.get(name)
            if srcs is None:
                continue
            t0 = srcs[0]
            shp, dt = t0.shape, t0.dtype
            if len(srcs) != m or len(shp) != 1:
                raise ValueError(f"K22 {key}.{name}: {len(srcs)} sources of "
                                 f"{tuple(shp)}, want {m} of [rows]")
            n = shp[0]
            field_ptrs = []
            for t in srcs:
                if t.shape != shp or t.dtype is not dt:
                    raise ValueError(f"K22 {key}.{name}: {t.dtype} {tuple(t.shape)}, want "
                                     f"{dt} {tuple(shp)}")
                if t.get_device() != didx:
                    t = t.to(dev)
                    keep.append(t)
                elif not t.is_contiguous():
                    t = t.contiguous()
                    keep.append(t)
                field_ptrs.append(t.data_ptr())
            ptrs.append(field_ptrs)
            if rows is not None and n != rows:
                raise ValueError(f"K22 {key}.{name}: [{n}] beside {rows} rows")
            rows = n
            fields_.append((f, dt))
        shape.append((key, bool(keyed), rows, tuple(fields_)))
        src_ptrs.append(ptrs)
    sig = (m, n_local, tuple(order), rule, h, 0 if inv is None else int(inv.shape[0]),
           tuple(shape))
    layout = _FOLD_LAYOUTS.get(sig)
    if layout is None:
        layout = _fold_layout(sig)
        if len(_FOLD_LAYOUTS) >= 256:
            _FOLD_LAYOUTS.clear()
        _FOLD_LAYOUTS[sig] = layout
    sizes, slots, launches = layout
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    views = [{} for _ in shape]
    for slot, part in zip(slots, torch.split_with_sizes(buf, sizes)):
        if slot is not None:
            ki, name, dt = slot
            views[ki][name] = part.view(dt)
    out = {key: AggState(**v) for (key, *_r), v in zip(shape, views)}
    from ..kernels._build import launch, upload_table

    fold_states.merges += 1
    base = buf.data_ptr()
    for template, entries, staged in launches:
        a = _FoldDesc()
        ctypes.memmove(ctypes.addressof(a), ctypes.addressof(template), _FOLD_PTRS_AT)
        if inv is not None:
            a.inv = inv.data_ptr()
        flat = []
        for ki, fi, off in entries:
            flat.append(base + off)
            flat += src_ptrs[ki][fi]
        if staged:
            # ptrs, each real source's row of inv, then order (int32)
            rows_of = ([0] * len(order) if inv is None else
                       [a.inv + (k // n_local) * h * 4 for k in order])
            table = upload_table(np.asarray(flat + rows_of, dtype=np.uint64).tobytes()
                                 + np.asarray(order, dtype=np.int32).tobytes(), dev)
            keep.append(table)
            a.table = table.data_ptr()
        else:
            a.ptrs[:len(flat)] = flat
        fold_states.launches += 1
        launch("fold_states", "gt_fold_states", a, stream)
    del keep
    return out


# What a merge's structure decides, built once per structure:
# (output byte sizes, the split piece of each output field, the launches:
# (descriptor without pointers, the (key, field, output offset) of each
# of its fields in pointer order, staged)).  A staged descriptor's `order`
# and `ptrs` stay empty.
_FOLD_LAYOUTS: dict = {}


def _fold_layout(sig) -> tuple:
    m, n_local, order, rule, h, n_slots, shape = sig
    for key, keyed, rows, fields_ in shape:
        names = [_FOLD_FIELDS[f] for f, _dt in fields_]
        if not fields_:
            raise ValueError(f"K22 {key}: no state field")
        if keyed and (n_slots == 0 or "last_ts" in names):
            raise ValueError(f"K22 {key}: a keyed key needs inv and has no LAST states")
        if keyed and rows not in (h, h + 1):
            raise ValueError(f"K22 keyed {key}: {rows} rows for slot tables of {h}")
        for f, dt in fields_:
            if (dt not in _FOLD_DTYPES or (f == 4 and dt is not torch.int64)
                    or (f == 5 and dt is not torch.float64)):
                raise ValueError(f"K22 {key}.{_FOLD_FIELDS[f]}: {dt}")
    # the outputs: the fields of one type back to back, each type's run
    # aligned to _FOLD_ALIGN bytes
    by_type: dict = {}
    for ki, (_key, _keyed, rows, fields_) in enumerate(shape):
        for fi, (f, dt) in enumerate(fields_):
            by_type.setdefault(dt, []).append((ki, fi, f, dt, rows))
    sizes, slots, offset, total = [], [], {}, 0
    for group in by_type.values():
        for ki, fi, f, dt, rows in group:
            offset[ki, fi] = total
            sizes.append(rows * _FOLD_ELEM[dt])
            slots.append((ki, _FOLD_FIELDS[f], dt))
            total += sizes[-1]
        pad = -total % _FOLD_ALIGN
        if pad:
            sizes.append(pad)
            slots.append(None)
            total += pad
    # the launches: whole keys, in key order, as `fold_launch_plan` splits them
    index = {key: ki for ki, (key, *_r) in enumerate(shape)}
    plan = fold_launch_plan([(key, tuple(_FOLD_FIELDS[f] for f, _dt in fields_))
                             for key, _k, _r, fields_ in shape], m, len(order))
    rule_code = _FOLD_RULES[rule]
    launches = []
    for units in plan:
        staged = fold_launch_staged(units, m, len(order))
        a = _FoldDesc()
        a.desc_bytes, a.n_keys, a.m, a.n_local = ctypes.sizeof(_FoldDesc), len(units), m, n_local
        a.n_order, a.rule, a.h, a.n_slots = len(order), rule_code, h, n_slots
        if not staged:
            a.order[:len(order)] = order
        keys, blk, blocks, rows_sum, n_ptrs, entries = [], [], 0, 0, 0, []
        for key, names in units:
            ki = index[key]
            _key, keyed, rows, fields_ = shape[ki]
            present, dtypes = 0, [0, 0, 0, 0]
            for fi, (f, dt) in enumerate(fields_):
                if _FOLD_FIELDS[f] not in names:
                    continue
                present |= 1 << f
                if f < 4:
                    dtypes[f] = _FOLD_DTYPES[dt]
                entries.append((ki, fi, offset[ki, fi]))
            keys.append(_FOLD_KEY.pack(rows, n_ptrs, present, int(keyed), *dtypes))
            n_ptrs += len(names) * (m + 1)
            blocks += -(-rows // _FOLD_THREADS)
            rows_sum += rows
            blk.append(blocks)
        blob = b"".join(keys)
        ctypes.memmove(ctypes.addressof(a) + _FoldDesc.keys.offset, blob, len(blob))
        a.blk_end[:len(blk)] = blk
        a.n_ptrs, a.total_rows, a.n_blocks = n_ptrs, rows_sum, blocks
        launches.append((a, entries, staged))
    return sizes, slots, launches


def fold_states(state: AggState, n_local: int, order, inv=None,
                rule: str = "fold") -> AggState:
    """K22: fold the stacked partial states of one key into one state.

    state:     AggState whose fields are [M, rows] on the first mesh slot,
               source m from slot m // n_local (slots padded with dummies)
    order:     the rows of the real sources, in global source order
    inv:       None (dense mode: every source over the same rows), or int32
               [D, H] from `invert_slot_maps` (keyed mode: hash plans,
               source m's rows indexed by slot m // n_local's table; rows H
               or H + 1, the trailing row folding onto itself)
    rule:      "fold" (the tile mesh's left folds: the later source wins a
               LAST ts tie) or "psum" (`psum_states`, the table-fed route:
               LAST is the max value at the max ts); the two also differ in
               which NaN's sign a sum keeps where two NaNs meet

    Dense: sums fold left over `order`, counts add, min/max take the IEEE
    minimum/maximum over every source (a NaN propagates, -0 < +0: the
    same bytes for any slot count); keyed: every field starts at the
    scatter identity and takes the sources' rows in `order`.  A CUDA
    tensor launches csrc/fold_states.cu once (one thread per row, a fixed
    order: the same bytes every run), the one-key form of
    `fold_state_dicts`; a CPU tensor runs `fold_states_plain`."""
    first = next(getattr(state, f.name) for f in fields(state)
                 if getattr(state, f.name) is not None)
    if first.device.type == "cpu":
        return fold_states_plain(state, n_local, order, inv, rule)
    per_field = {name: list(g.unbind(0)) for name in _FOLD_FIELDS
                 if (g := getattr(state, name)) is not None}
    if inv is not None and "last_ts" in per_field:
        raise ValueError("a keyed fold has no LAST states")
    m = int(first.shape[0])
    order = _fold_args_check(m, n_local, order, rule)
    dev = first.device
    return _fold_on_card(dev, first.get_device(), [("", per_field, inv is not None)], m,
                         n_local, order, inv, rule,
                         torch.cuda.current_stream(dev).cuda_stream)[""]


fold_states.launches = 0
fold_states.merges = 0


def fold_state_dicts(states_by_source: list, n_local: int, order, inv=None, rule: str = "fold",
                     dev=None, dense_keys=()) -> dict:
    """K22 over a whole merge: the per-source state dicts {key: AggState}
    (M = D * n_local of them, slot-major, dummies included) folded key by
    key into one dict, every key and field in one launch (or as many as
    `fold_launch_plan` needs).

    Each key folds as `fold_states` folds its stacked states: dense, or
    keyed through `inv` (hash plans) unless it is in `dense_keys` (the
    `__hash_overflow` count); keys may differ in their rows.  `dev` (the
    first mesh slot; default: the device of the first source's states)
    holds the result.  On the card the sources are read in place (a source
    on another card is copied over, with no stack) and the merged fields
    are views of one allocation; on the CPU each key is stacked and folded
    by `fold_states_plain`."""
    if not states_by_source:
        raise ValueError("fold of no sources")
    first = states_by_source[0]
    if dev is None:
        dev = next(getattr(st, f.name) for st in first.values() for f in fields(st)
                   if getattr(st, f.name) is not None).device
    dev = torch.device(dev)
    if dev.type == "cpu":
        return {key: fold_states_plain(stack_states([s[key] for s in states_by_source], dev),
                                       n_local, order, None if key in dense_keys else inv, rule)
                for key in first}
    order = _fold_args_check(len(states_by_source), n_local, order, rule)
    didx = dev.index if dev.index is not None else torch.cuda.current_device()
    return _fold_on_card(dev, didx, _fold_items(states_by_source, inv, dense_keys),
                         len(states_by_source), n_local, order, inv, rule,
                         torch.cuda.current_stream(dev).cuda_stream)


def _fold_items(states_by_source: list, inv, dense_keys) -> list:
    """(key, {field: [per-source tensors]}, keyed) of a merge, in key order."""
    items = []
    for key, st0 in states_by_source[0].items():
        per_field = {}
        for name in _FOLD_FIELDS:
            if getattr(st0, name) is None:
                continue
            srcs = [getattr(s[key], name) for s in states_by_source]
            if any(t is None for t in srcs):
                raise ValueError(f"K22 {key}.{name}: absent from some sources")
            per_field[name] = srcs
        items.append((key, per_field, inv is not None and key not in dense_keys))
    return items


def invert_slot_maps(slot_map: torch.Tensor) -> torch.Tensor:
    """K22's first launch in keyed mode: int32 [D, H] slot maps (K17's
    union slot of each device-table row, H where none) -> inv [D, H] (see
    `invert_slot_maps_plain`).  Counted in `fold_states.launches`."""
    if slot_map.device.type == "cpu":
        return invert_slot_maps_plain(slot_map)
    from ..kernels._build import launch

    d, h = (int(x) for x in slot_map.shape)
    slot_map = slot_map.contiguous()
    _check_rows(slot_map.reshape(-1), torch.int32, d * h, slot_map.device)
    inv = torch.full((d, h), -1, dtype=torch.int32, device=slot_map.device)
    fold_states.launches += 1
    launch("fold_states", "gt_fold_invert", _InvertArgs(slot_map.data_ptr(), inv.data_ptr(), h, d, 0),
           torch.cuda.current_stream(slot_map.device).cuda_stream)
    return inv
