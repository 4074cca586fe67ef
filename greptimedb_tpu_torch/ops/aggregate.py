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

`segment_aggregate` / `segment_aggregate_multi` choose between them the
way the reference does: under 2^16 rows the scatter kernel; otherwise K2,
whose per-block guard (masked ids in range, span < 16) decides whether
its result stands or K3 reruns the reduction.  Reading the guard's verdict
is the one host sync per aggregate call.

All sums are float64; every kernel adds in a fixed order, so a CUDA run
is byte-identical from run to run.  `merge_states`, `reduce_state_axes`
and `finalize` are torch ops over [G]-sized states.

Group ids are dense ints computed from time buckets and tag codes:
    gid = ((tag0 * card1 + tag1) * ... ) * n_buckets + time_bucket
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import numpy as np
import torch

SUM, COUNT, MIN, MAX, LAST = "sum", "count", "min", "max", "last"

# Blocked geometry: rows are processed in blocks of BLOCK_ROWS; a block
# may touch at most BLOCK_SPAN distinct consecutive group ids.
BLOCK_ROWS = 4096
BLOCK_SPAN = 16
_FAST_MIN_ROWS = 1 << 16
_DBL_MAX = float(np.finfo(np.float64).max)
_I64_MIN = int(np.iinfo(np.int64).min)
_I32_MAX = int(np.iinfo(np.int32).max)


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


def _stacked(out: dict) -> AggState:
    return AggState(**{k: torch.stack(v) if v else None for k, v in out.items()})


class _BlockedArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("nb", ctypes.c_int64),
        ("gids", ctypes.c_void_p), ("base_mask", ctypes.c_void_p),
        ("values", ctypes.c_void_p), ("masks", ctypes.c_void_p),
        ("base_out", ctypes.c_void_p), ("verdict", ctypes.c_void_p),
        ("psum", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("pmin", ctypes.c_void_p), ("pmax", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("n_cols", ctypes.c_int32),
    ]


class _FoldArgs(ctypes.Structure):
    _fields_ = [
        ("sbase", ctypes.c_void_p), ("order", ctypes.c_void_p),
        ("psum", ctypes.c_void_p), ("pcnt", ctypes.c_void_p),
        ("pmin", ctypes.c_void_p), ("pmax", ctypes.c_void_p),
        ("sums", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("mins", ctypes.c_void_p), ("maxs", ctypes.c_void_p),
        ("nb", ctypes.c_int64),
        ("num_groups", ctypes.c_int32), ("n_cols", ctypes.c_int32),
    ]


def segment_reduce_blocked(values, gids, masks, base_mask, num_groups: int, aggs):
    """K2: blocked sum/count/min/max of C columns.

    values: C float tensors [n]; gids int32 [n]; masks: C bool [n] column
    masks, each a subset of `base_mask` (bool [n]) — the guard runs on the
    base mask.  Returns (ok, AggState [C, G] or None, base int32 [nb]):
    ok is False when the layout guard failed, and the caller must use K3.
    A CUDA tile launches csrc/segment_reduce_blocked.cu; a CPU tile runs
    `segment_reduce_blocked_plain`."""
    if gids.device.type == "cpu":
        return segment_reduce_blocked_plain(values, gids, masks, base_mask, num_groups, aggs)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    nb = max(-(-n // BLOCK_ROWS), 1)
    C, G = len(values), int(num_groups)
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(base_mask, torch.bool, n, dev)
    vals, vt, mt = _column_tables(values, masks, base_mask, n, dev)
    want = _wants(aggs)
    base = torch.empty(nb, dtype=torch.int32, device=dev)
    verdict = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = [
        torch.empty((nb, C, BLOCK_SPAN), dtype=dt, device=dev) if on else None
        for on, dt in zip(want, (torch.float64, torch.int32, torch.float64, torch.float64))
    ]
    a = _BlockedArgs(
        n, nb, gids.data_ptr(), base_mask.data_ptr(), vt.data_ptr(), mt.data_ptr(),
        base.data_ptr(), verdict.data_ptr(), *(_ptr(p) for p in parts), G, C,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    segment_reduce_blocked.launches += 1
    launch("segment_reduce_blocked", "gt_blocked_partials", a, stream)
    if int(verdict.item()) != 0:  # the one host sync: the layout guard
        return False, None, base
    sbase, order = torch.sort(base, stable=True)
    outs = [
        torch.empty((C, G), dtype=dt, device=dev) if on else None
        for on, dt in zip(want, (torch.float64, torch.int32, torch.float64, torch.float64))
    ]
    f = _FoldArgs(
        sbase.data_ptr(), order.data_ptr(), *(_ptr(p) for p in parts),
        *(_ptr(o) for o in outs), nb, G, C,
    )
    launch("segment_reduce_blocked", "gt_blocked_fold", f, stream)
    del vals
    return True, _state_of(want, *outs), base


segment_reduce_blocked.launches = 0


# ---- K3: scatter reduction over sorted runs ----------------------------------


def sort_segments(gids, mask, num_groups: int):
    """Index plumbing for K3/K4: a stable sort of the masked ids (masked
    and out-of-range rows carry G and sort last).  Returns (sorted ids
    int32 [n], row of each int64 [n]); rows of one group form one run, in
    row order."""
    G = int(num_groups)
    key = torch.where(mask & (gids >= 0) & (gids < G), gids.to(torch.int32), G)
    skeys, perm = torch.sort(key, stable=True)
    return skeys.contiguous(), perm.contiguous()


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


class _ScatterArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("values", ctypes.c_void_p), ("masks", ctypes.c_void_p),
        ("sums", ctypes.c_void_p), ("counts", ctypes.c_void_p),
        ("mins", ctypes.c_void_p), ("maxs", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("n_cols", ctypes.c_int32),
    ]


def segment_reduce_scatter(values, gids, masks, base_mask, num_groups: int, aggs, order=None):
    """K3: sum/count/min/max of C columns for any id order.  Arguments as
    `segment_reduce_blocked`; `order` optionally reuses a
    `sort_segments(gids, base_mask, G)` result.  Returns AggState [C, G].
    A CUDA tile launches csrc/segment_reduce_scatter.cu; a CPU tile runs
    `segment_reduce_scatter_plain`."""
    if gids.device.type == "cpu":
        return segment_reduce_scatter_plain(values, gids, masks, base_mask, num_groups, aggs)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    C, G = len(values), int(num_groups)
    _check_rows(gids, torch.int32, n, dev)
    _check_rows(base_mask, torch.bool, n, dev)
    if order is None:
        order = sort_segments(gids, base_mask, G)
    skeys, perm = order
    vals, vt, mt = _column_tables(values, masks, base_mask, n, dev)
    want = _wants(aggs)
    outs = [
        torch.empty((C, G), dtype=dt, device=dev) if on else None
        for on, dt in zip(want, (torch.float64, torch.int32, torch.float64, torch.float64))
    ]
    a = _ScatterArgs(
        n, skeys.data_ptr(), perm.data_ptr(), vt.data_ptr(), mt.data_ptr(),
        *(_ptr(o) for o in outs), G, C,
    )
    segment_reduce_scatter.launches += 1
    launch("segment_reduce_scatter", "gt_scatter_reduce", a,
           torch.cuda.current_stream(dev).cuda_stream)
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
        ("n", ctypes.c_int64), ("nb", ctypes.c_int64),
        ("gids", ctypes.c_void_p), ("mask", ctypes.c_void_p),
        ("ts", ctypes.c_void_p), ("base", ctypes.c_void_p),
        ("pts", ctypes.c_void_p), ("prow", ctypes.c_void_p),
    ]


class _LastFoldArgs(ctypes.Structure):
    _fields_ = [
        ("sbase", ctypes.c_void_p), ("order", ctypes.c_void_p),
        ("pts", ctypes.c_void_p), ("prow", ctypes.c_void_p),
        ("values", ctypes.c_void_p), ("last_ts", ctypes.c_void_p),
        ("last_val", ctypes.c_void_p),
        ("nb", ctypes.c_int64), ("n", ctypes.c_int64),
        ("num_groups", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


class _LastSortedArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("skeys", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("ts", ctypes.c_void_p), ("values", ctypes.c_void_p),
        ("last_ts", ctypes.c_void_p), ("last_val", ctypes.c_void_p),
        ("num_groups", ctypes.c_int32), ("reserved", ctypes.c_int32),
    ]


def segment_last(values, ts, gids, mask, num_groups: int, base=None, order=None):
    """K4: last_value(values ORDER BY ts) per group; a ts tie goes to the
    later row.  With `base` (int32 [nb] from a passing K2 guard over this
    `mask`) the blocked form; otherwise the sorted-run form over `order`
    (`sort_segments(gids, mask, G)`, computed when not given).  Returns
    (last_ts int64 [G], last_val float64 [G]); an empty group has ts
    INT64_MIN and the value of row 0.  A CUDA tile launches
    csrc/segment_last.cu; a CPU tile runs `segment_last_plain`."""
    if gids.device.type == "cpu":
        return segment_last_plain(values, ts, gids, mask, num_groups, base)
    from ..kernels._build import launch

    dev = gids.device
    n = int(gids.shape[0])
    G = int(num_groups)
    if n >= 2**31:
        raise ValueError("segment_last indexes rows in int32: at most 2^31 - 1 rows")
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
        pts = torch.empty((nb, BLOCK_SPAN), dtype=torch.int64, device=dev)
        prow = torch.empty((nb, BLOCK_SPAN), dtype=torch.int32, device=dev)
        a = _LastBlockedArgs(n, nb, gids.data_ptr(), mask.data_ptr(), ts.data_ptr(),
                             base.data_ptr(), pts.data_ptr(), prow.data_ptr())
        launch("segment_last", "gt_last_partials", a, stream)
        sbase, order_b = torch.sort(base, stable=True)
        f = _LastFoldArgs(sbase.data_ptr(), order_b.data_ptr(), pts.data_ptr(),
                          prow.data_ptr(), x.data_ptr(), last_ts.data_ptr(),
                          last_val.data_ptr(), nb, n, G, 0)
        launch("segment_last", "gt_last_fold", f, stream)
        return last_ts, last_val
    if order is None:
        order = sort_segments(gids, mask, G)
    skeys, perm = order
    a = _LastSortedArgs(n, skeys.data_ptr(), perm.data_ptr(), ts.data_ptr(), x.data_ptr(),
                        last_ts.data_ptr(), last_val.data_ptr(), G, 0)
    launch("segment_last", "gt_last_sorted", a, stream)
    return last_ts, last_val


segment_last.launches = 0

KERNELS = (segment_reduce_blocked, segment_reduce_scatter, segment_last)


# ---- kernel plumbing ----------------------------------------------------------


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_rows(t: torch.Tensor, dtype, n: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} [{n}] on {dev}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _column_tables(values, masks, base_mask, n: int, dev):
    """Device tables of column pointers for the C-column kernels.  A
    column mask that IS the base mask is passed as a null pointer (no
    second read).  Returns (kept tensors, values table, masks table)."""
    if len(values) != len(masks) or not values:
        raise ValueError("one mask per value column, at least one column")
    vals = [_f64(v).contiguous() for v in values]
    for v in vals:
        _check_rows(v, torch.float64, n, dev)
    mptrs = []
    for m in masks:
        if m is base_mask or m.data_ptr() == base_mask.data_ptr():
            mptrs.append(0)
        else:
            _check_rows(m, torch.bool, n, dev)
            mptrs.append(m.data_ptr())
    # one host-to-device copy for both tables
    ptrs = torch.tensor([v.data_ptr() for v in vals] + mptrs, dtype=torch.int64).to(dev)
    vt, mt = ptrs[: len(vals)], ptrs[len(vals):]
    return (vals, ptrs), vt, mt


# ---- the reference's entry points ----------------------------------------------


def segment_aggregate(
    values: torch.Tensor,
    gids: torch.Tensor,
    num_groups: int,
    aggs: tuple[str, ...],
    mask: torch.Tensor | None = None,
    ts: torch.Tensor | None = None,
) -> AggState:
    """Per-shard partial aggregation of one column (the lower/state
    stage), float64 accumulation.  Under 2^16 rows the scatter kernels; otherwise K2, whose guard picks the blocked result or
    a K3 rerun.  LAST takes K4 in the matching form."""
    if mask is None:
        mask = gids < num_groups
    n = values.shape[0]
    other = tuple(a for a in aggs if a != LAST)
    if LAST in aggs and ts is None:
        raise ValueError("LAST aggregation requires ts")
    base = None
    state = None
    if n >= _FAST_MIN_ROWS:
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


def segment_aggregate_multi(
    values: list,
    gids: torch.Tensor,
    num_groups: int,
    aggs: tuple[str, ...],
    masks: list,
    base_mask: torch.Tensor,
) -> AggState:
    """C value columns sharing ONE layout guard and one kernel launch:
    arrays in the result are [C, G].  `masks[c]` must be a subset of
    `base_mask` (the guard runs on the base mask).  LAST is not supported
    here (callers route last_value per column)."""
    if LAST in aggs:
        raise ValueError("segment_aggregate_multi does not support LAST")
    n = values[0].shape[0]
    if n >= _FAST_MIN_ROWS:
        ok, st, _base = segment_reduce_blocked(
            values, gids, masks, base_mask, num_groups, aggs
        )
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
