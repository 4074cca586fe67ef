"""Predicate mask + group ids: kernel K1 `mask_gids` and its plain version.

Counterpart of `greptimedb_tpu/ops/filter.py` (`compile_predicate`, whose
literal encoding the executor does) and of the mask / group-id part of
`greptimedb_tpu/parallel/executor.py`
(`_apply_filters`, `raw_group_ids`, `time_bucket`, the padding rule).  In
the reference those were separate jnp expressions that XLA fused; here
they are one hand-written CUDA pass (csrc/mask_gids.cu) on a CUDA tensor,
and `mask_gids_plain` — the same arithmetic in torch ops — on a CPU
tensor.  The plain version is also what the kernel is checked against.

Ids come in two widths, as the reference's `raw_group_ids(dtype=...)`:
int32 for the dense strategy (padding rows get the pad id), and int64
for the hash strategy, whose sparse group space may pass 2^31 (no pad
rule there: the mask keeps padding rows out of the slot table).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.errors import PlanError

_OP_CODE = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5, "in": 6, "not in": 7}

MAX_FILTERS = 16
MAX_GATES = 16
MAX_TAGS = 8


class _MaskGidsArgs(ctypes.Structure):
    """Field for field the `MaskGidsArgs` struct of csrc/mask_gids.cu."""

    _fields_ = [
        ("n", ctypes.c_int64),
        ("origin", ctypes.c_int64),
        ("interval", ctypes.c_int64),
        ("valid", ctypes.c_void_p),
        ("ts", ctypes.c_void_p),
        ("lits", ctypes.c_void_p),
        ("gids_out", ctypes.c_void_p),
        ("mask_out", ctypes.c_void_p),
        ("fplane", ctypes.c_void_p * MAX_FILTERS),
        ("gate", ctypes.c_void_p * MAX_GATES),
        ("tag", ctypes.c_void_p * MAX_TAGS),
        ("fkind", ctypes.c_int32 * MAX_FILTERS),
        ("fop", ctypes.c_int32 * MAX_FILTERS),
        ("flit_off", ctypes.c_int32 * MAX_FILTERS),
        ("flit_cnt", ctypes.c_int32 * MAX_FILTERS),
        ("card", ctypes.c_int32 * MAX_TAGS),
        ("n_filters", ctypes.c_int32),
        ("n_gates", ctypes.c_int32),
        ("n_tags", ctypes.c_int32),
        ("n_buckets", ctypes.c_int32),
        ("pad_gid", ctypes.c_int32),
        ("id64", ctypes.c_int32),
    ]


# ---- plain version ----------------------------------------------------------


def _compare(col: torch.Tensor, op: str, value) -> torch.Tensor:
    if op == "=":
        return col == value
    if op == "!=":
        return col != value
    if op == "<":
        return col < value
    if op == "<=":
        return col <= value
    if op == ">":
        return col > value
    if op == ">=":
        return col >= value
    if op == "in":
        m = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
        for v in value:
            m = m | (col == v)
        return m
    m = torch.ones(col.shape, dtype=torch.bool, device=col.device)  # not in
    for v in value:
        m = m & (col != v)
    return m


def time_bucket(ts: torch.Tensor, origin: int, interval: int) -> torch.Tensor:
    """Floor timestamps into interval buckets, then a wrapping int32 cast
    (the reference's `((ts - origin) // interval).astype(int32)`)."""
    return torch.div(ts - origin, interval, rounding_mode="floor").to(torch.int32)


def mask_gids_plain(valid, filters, gates, tags, bucket, pad_gid, dtype=torch.int32):
    """Torch-op version of K1 (see `mask_gids` for the arguments)."""
    mask = valid.clone()
    for plane, op, value in filters:
        plane, value = _normalize_filter(plane, op, value)
        if plane.dtype == torch.uint8:
            plane = plane.to(torch.int64)
        mask = mask & _compare(plane, op, value)
    for g in gates:
        mask = mask & g
    components = [(codes, card) for codes, card in tags]
    if bucket is not None:
        ts, origin, interval, n_buckets = bucket
        components.append((time_bucket(ts, origin, interval), n_buckets))
    gid = torch.zeros(valid.shape, dtype=dtype, device=valid.device)
    in_range = torch.ones(valid.shape, dtype=torch.bool, device=valid.device)
    for comp, card in components:
        c = comp.to(dtype)
        in_range = in_range & (c >= 0) & (c < card)
        gid = gid * card + torch.clamp(c, 0, card - 1)
    mask = mask & in_range
    if dtype == torch.int32:
        gid = torch.where(valid, gid, torch.full_like(gid, pad_gid))
    return gid, mask


def _normalize_filter(plane: torch.Tensor, op: str, value):
    """Bring a filter plane to one of the kernel's plane types (int32,
    int64, float64, uint8) with its literal(s) in the comparison's type:
    float32 planes compare in float32 (as the reference's weakly typed
    literals do), integer planes against a non-integral literal compare in
    float64, and booleans compare as 0/1."""
    values = tuple(value) if op in ("in", "not in") else (value,)
    if plane.dtype == torch.bool:
        plane = plane.view(torch.uint8)
    if plane.dtype == torch.float32:
        plane = plane.to(torch.float64)
        values = tuple(float(torch.tensor(float(v), dtype=torch.float32)) for v in values)
    elif plane.dtype == torch.float64:
        values = tuple(float(v) for v in values)
    else:
        if plane.dtype in (torch.int8, torch.int16):
            plane = plane.to(torch.int32)
        if any(isinstance(v, float) and not (math.isfinite(v) and v == int(v)) for v in values):
            plane = plane.to(torch.float64)
            values = tuple(float(v) for v in values)
        else:
            values = tuple(int(v) for v in values)
    return plane, (values if op in ("in", "not in") else values[0])


# ---- the kernel --------------------------------------------------------------


def mask_gids(valid, filters, gates, tags, bucket, pad_gid, dtype=torch.int32):
    """Predicate mask and mixed-radix group ids over one tile.

    valid:   bool [n], False for padding rows
    filters: [(plane [n], op, literal or tuple of literals)], a conjunction
    gates:   [bool [n]] null gates (NULL never satisfies a predicate)
    tags:    [(int32 codes [n], card)] group components, major first
    bucket:  None or (int64 ts [n], origin, interval, n_buckets), the last
             (minor) component
    pad_gid: the id padding rows get (internal group count - 1); unused
             with int64 ids (pass None)
    dtype:   torch.int32 (dense ids, wrapping like XLA's int32) or
             torch.int64 (hash ids: composed in int64, no pad rule)

    Returns (gids [n] of `dtype`, mask bool [n]).  A CUDA tile runs kernel
    K1 (csrc/mask_gids.cu); a CPU tile runs `mask_gids_plain`."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"mask_gids ids are int32 or int64, not {dtype}")
    if valid.device.type == "cpu":
        return mask_gids_plain(valid, filters, gates, tags, bucket, pad_gid, dtype)
    return _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype)


def _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype):
    from ..kernels._build import launch, upload_table

    dev = valid.device
    n = int(valid.shape[0])
    if len(filters) > MAX_FILTERS or len(gates) > MAX_GATES or len(tags) > MAX_TAGS:
        raise ValueError(
            f"mask_gids takes at most {MAX_FILTERS} filters, {MAX_GATES} gates, "
            f"{MAX_TAGS} tags"
        )
    keep = []  # tensors the launch reads: alive until it is enqueued
    args = _MaskGidsArgs()
    args.n = n
    _check(valid, torch.bool, n, dev)
    args.valid = valid.data_ptr()
    lits: list[int] = []
    kinds = {torch.int32: 0, torch.int64: 1, torch.float64: 2, torch.uint8: 3}
    for i, (plane, op, value) in enumerate(filters):
        if op not in _OP_CODE:
            raise PlanError(f"unsupported filter op: {op}")
        plane, value = _normalize_filter(plane, op, value)
        plane = plane.contiguous()
        _check(plane, plane.dtype, n, dev)
        keep.append(plane)
        vals = value if op in ("in", "not in") else (value,)
        args.fplane[i] = plane.data_ptr()
        args.fkind[i] = kinds[plane.dtype]
        args.fop[i] = _OP_CODE[op]
        args.flit_off[i] = len(lits)
        args.flit_cnt[i] = len(vals)
        for v in vals:
            if plane.dtype == torch.float64:
                lits.append(torch.tensor(v, dtype=torch.float64).view(torch.int64).item())
            else:
                lits.append(int(v))
    args.n_filters = len(filters)
    for i, g in enumerate(gates):
        _check(g, torch.bool, n, dev)
        args.gate[i] = g.data_ptr()
    args.n_gates = len(gates)
    for i, (codes, card) in enumerate(tags):
        _check(codes, torch.int32, n, dev)
        args.tag[i] = codes.data_ptr()
        args.card[i] = int(card)
    args.n_tags = len(tags)
    if bucket is not None:
        ts, origin, interval, n_buckets = bucket
        _check(ts, torch.int64, n, dev)
        if int(interval) == 0:
            raise ValueError("time bucket interval must be non-zero")
        args.ts = ts.data_ptr()
        args.origin = int(origin)
        args.interval = int(interval)
        args.n_buckets = int(n_buckets)
    else:
        args.ts = None
    lit_t = upload_table(lits or [0], dev)
    keep.append(lit_t)
    args.lits = lit_t.data_ptr()
    gids = torch.empty(n, dtype=dtype, device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    args.gids_out = gids.data_ptr()
    args.mask_out = mask.data_ptr()
    args.id64 = int(dtype == torch.int64)
    args.pad_gid = 0 if args.id64 else int(pad_gid)
    mask_gids.launches += 1
    launch("mask_gids", "gt_mask_gids", args, torch.cuda.current_stream(dev).cuda_stream)
    return gids, mask


mask_gids.launches = 0


def _check(t: torch.Tensor, dtype, n: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} [{n}] on {dev}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
