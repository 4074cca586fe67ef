"""Predicate mask + group ids: kernel K1 `mask_gids` and its plain version.

Counterpart of `greptimedb_tpu/ops/filter.py` (`compile_predicate`, whose
literal encoding the executor does) and of the mask / group-id part of
`greptimedb_tpu/parallel/executor.py`
(`_apply_filters`, `raw_group_ids`, `time_bucket`, the padding rule).  In
the reference those were separate jnp expressions that XLA fused; here
they are one hand-written CUDA pass (csrc/mask_gids.cu) on a CUDA tensor,
and `mask_gids_plain` — the same arithmetic in torch ops — on a CPU
tensor.  The plain version is also what the kernel is checked against.

The literals live in one int64 table on the tensors' device, led by the
bucket origin and interval: [origin, interval, literal bits...]
(`literal_table`).  K1 reads all of them from there, so a captured launch
(parallel/tile_program.py `TickProgram`) takes new literals and a slid
window from a rewrite of the table, with no recapture.

Ids come in two widths, as the reference's `raw_group_ids(dtype=...)`:
int32 for the dense strategy (padding rows get the pad id), and int64
for the hash strategy, whose sparse group space may pass 2^31 (no pad
rule there: the mask keeps padding rows out of the slot table).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
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


def mask_gids_plain(valid, filters, gates, tags, bucket, pad_gid, dtype=torch.int32,
                    lits=None):
    """Torch-op version of K1 (see `mask_gids` for the arguments).  With
    `lits` the literal values, origin and interval are read from that
    table (`literal_table`'s layout), as the kernel reads them."""
    mask = valid.clone()
    specs = literal_specs([(p.dtype, op, v) for p, op, v in filters]) if lits is not None else None
    for i, (plane, op, value) in enumerate(filters):
        plane, value = _normalize_filter(plane, op, value)
        if specs is not None:
            _kind, _op, off, cnt = specs[i]
            raw = lits[2 + off: 2 + off + cnt]
            if plane.dtype == torch.float64:
                raw = raw.view(torch.float64)
            else:
                plane = plane.to(torch.int64)  # the kernel compares integers in int64
            value = tuple(raw) if op in ("in", "not in") else raw[0]
        if plane.dtype == torch.uint8:
            plane = plane.to(torch.int64)
        mask = mask & _compare(plane, op, value)
    for g in gates:
        mask = mask & g
    components = [(codes, card) for codes, card in tags]
    if bucket is not None:
        ts, origin, interval, n_buckets = bucket
        if lits is not None:
            origin, interval = lits[0], lits[1]
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


def _normalize_literals(dtype: torch.dtype, op: str, value):
    """(the kernel's plane type, the literal(s) in the comparison's type)
    of a filter over a plane of `dtype`: float32 planes compare in float32
    (as the reference's weakly typed literals do), integer planes against
    a non-integral literal compare in float64, and booleans compare as
    0/1."""
    values = tuple(value) if op in ("in", "not in") else (value,)
    if dtype == torch.bool:
        dtype = torch.uint8
    if dtype == torch.float32:
        dtype = torch.float64
        values = tuple(float(torch.tensor(float(v), dtype=torch.float32)) for v in values)
    elif dtype == torch.float64:
        values = tuple(float(v) for v in values)
    else:
        if dtype in (torch.int8, torch.int16):
            dtype = torch.int32
        if any(isinstance(v, float) and not (math.isfinite(v) and v == int(v)) for v in values):
            dtype = torch.float64
            values = tuple(float(v) for v in values)
        else:
            values = tuple(int(v) for v in values)
    return dtype, (values if op in ("in", "not in") else values[0])


def _normalize_filter(plane: torch.Tensor, op: str, value):
    """The filter plane in the kernel's plane type (int32, int64, float64,
    uint8) and its literal(s) in the comparison's type
    (`_normalize_literals`)."""
    dtype, value = _normalize_literals(plane.dtype, op, value)
    if plane.dtype == torch.bool:
        plane = plane.view(torch.uint8)
    if plane.dtype != dtype:
        plane = plane.to(dtype)
    return plane, value


_KINDS = {torch.int32: 0, torch.int64: 1, torch.float64: 2, torch.uint8: 3}


def literal_specs(filters) -> tuple:
    """Per filter (plane kind, op code, offset, count) of the literal table
    for filters given as (plane dtype, op, value): the structure a
    captured K1 launch bakes in (a literal that changes its kind changes
    it)."""
    specs, off = [], 0
    for dtype, op, value in filters:
        if op not in _OP_CODE:
            raise PlanError(f"unsupported filter op: {op}")
        kind, value = _normalize_literals(dtype, op, value)
        cnt = len(value) if op in ("in", "not in") else 1
        specs.append((_KINDS[kind], _OP_CODE[op], off, cnt))
        off += cnt
    return tuple(specs)


def literal_table(filters, origin: int = 0, interval: int = 1) -> list[int]:
    """K1's int64 literal table for filters given as (plane dtype, op,
    value): [origin, interval, literal bits...], an f64 literal as its
    bit pattern, in the order of `literal_specs`."""
    lits = [int(origin), int(interval)]
    for dtype, op, value in filters:
        kind, value = _normalize_literals(dtype, op, value)
        for v in (value if op in ("in", "not in") else (value,)):
            if kind == torch.float64:
                lits.append(int(np.float64(v).view(np.int64)))
            else:
                lits.append(int(v))
    return lits


# ---- the kernel --------------------------------------------------------------


def mask_gids(valid, filters, gates, tags, bucket, pad_gid, dtype=torch.int32, lits=None):
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
    lits:    None, or int64 [>= 2] on `valid`'s device: the literal table
             (`literal_table` of these filters and bucket) to read the
             literals, origin and interval from; the values in `filters`
             and `bucket` then give only their structure.  Without it the
             table is built from them and uploaded.

    Returns (gids [n] of `dtype`, mask bool [n]).  A CUDA tile runs kernel
    K1 (csrc/mask_gids.cu); a CPU tile runs `mask_gids_plain`."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"mask_gids ids are int32 or int64, not {dtype}")
    if valid.device.type == "cpu":
        return mask_gids_plain(valid, filters, gates, tags, bucket, pad_gid, dtype, lits)
    return _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype, lits)


def _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype, lits):
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
    specs = literal_specs([(p.dtype, op, v) for p, op, v in filters])
    for i, (plane, op, value) in enumerate(filters):
        plane, _value = _normalize_filter(plane, op, value)
        plane = plane.contiguous()
        _check(plane, plane.dtype, n, dev)
        keep.append(plane)
        args.fplane[i] = plane.data_ptr()
        args.fkind[i], args.fop[i], off, cnt = specs[i]
        args.flit_off[i] = off + 2
        args.flit_cnt[i] = cnt
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
    origin, interval = 0, 1
    if bucket is not None:
        ts, origin, interval, n_buckets = bucket
        _check(ts, torch.int64, n, dev)
        args.ts = ts.data_ptr()
        args.n_buckets = int(n_buckets)
    else:
        args.ts = None
    if lits is None:
        if bucket is not None and int(interval) == 0:
            raise ValueError("time bucket interval must be non-zero")
        table = literal_table([(p.dtype, op, v) for p, op, v in filters], origin, interval)
        lits = upload_table(table, dev)
    elif lits.device != dev or lits.dtype != torch.int64 or lits.dim() != 1 \
            or not lits.is_contiguous() or lits.shape[0] < 2 + sum(c for *_x, c in specs):
        raise ValueError("mask_gids lits must be a contiguous int64 literal table on "
                         f"{dev} of at least {2 + sum(c for *_x, c in specs)} entries")
    keep.append(lits)
    args.lits = lits.data_ptr()
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
