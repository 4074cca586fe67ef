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
import struct

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
        ("head", ctypes.c_int32),
        ("vec", ctypes.c_int32),
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
    specs = None
    if lits is not None:
        specs = k1_layout(filters, gates, tags, bucket, pad_gid, dtype).specs
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


def _nonintegral(v) -> bool:
    return isinstance(v, float) and not (math.isfinite(v) and v == int(v))


def _filter_key(dtype: torch.dtype, op: str, value) -> tuple:
    """What of one filter a K1 call's structure holds: the plane's dtype,
    the op, the literal count and whether an integer plane compares in
    float64 (a non-integral literal, `_normalize_literals`' rule)."""
    if op in ("in", "not in"):
        return dtype, op, len(value), any(_nonintegral(v) for v in value)
    return dtype, op, 1, _nonintegral(value)


# K1Layout packs the struct's per-call fields in one call: n and six
# pointers, then the pointer arrays back to back
_F = _MaskGidsArgs
if (_F.fplane.offset, _F.gate.offset, _F.tag.offset) != (48, 176, 304):
    raise ImportError("_MaskGidsArgs' pointer arrays moved; K1Layout.pack packs them at 48")


class K1Layout:
    """The structure of a K1 call, built once and reused: the argument
    struct with every field but the row count and the pointers filled
    (kinds, ops, literal offsets and counts, cards, bucket count, pad id,
    id width), the literal specs, the dtype each filter plane is converted
    to (None: taken as it is), the packer of the per-call fields (`pack`:
    n, the six pointers, then those of the filters, gates and tags; `tail`:
    head and vec) and the launch function."""

    __slots__ = ("template", "specs", "convert", "n_lits", "dtype", "pack", "tail", "fn")

    def __init__(self, filters, n_gates: int, cards: tuple, n_buckets, pad_gid, dtype):
        if len(filters) > MAX_FILTERS or n_gates > MAX_GATES or len(cards) > MAX_TAGS:
            raise ValueError(
                f"mask_gids takes at most {MAX_FILTERS} filters, {MAX_GATES} gates, "
                f"{MAX_TAGS} tags"
            )
        self.specs = literal_specs(filters)
        self.n_lits = 2 + sum(c for *_x, c in self.specs)
        self.convert = tuple(
            None if _normalize_literals(dt, op, v)[0] == dt
            else _normalize_literals(dt, op, v)[0]
            for dt, op, v in filters)
        a = _MaskGidsArgs()
        for i, (kind, op, off, cnt) in enumerate(self.specs):
            a.fkind[i], a.fop[i], a.flit_off[i], a.flit_cnt[i] = kind, op, off + 2, cnt
        a.n_filters, a.n_gates, a.n_tags = len(filters), n_gates, len(cards)
        for i, card in enumerate(cards):
            a.card[i] = card
        a.n_buckets = 0 if n_buckets is None else n_buckets
        a.id64 = int(dtype == torch.int64)
        a.pad_gid = 0 if a.id64 else int(pad_gid)
        self.template, self.dtype, self.fn = bytes(a), dtype, None
        nf, nt = len(filters), len(cards)
        self.pack = struct.Struct(
            f"<q5Q{nf}Q{(MAX_FILTERS - nf) * 8}x{n_gates}Q{(MAX_GATES - n_gates) * 8}x{nt}Q")
        self.tail = struct.Struct("<ii")


_LAYOUTS: dict[tuple, K1Layout] = {}
_MAX_LAYOUTS = 256


def k1_layout(filters, gates, tags, bucket, pad_gid, dtype=torch.int32) -> K1Layout:
    """The cached `K1Layout` of a call's structure (`mask_gids`'
    arguments): the literal values, the bucket's origin and interval and
    the operands themselves are not part of it."""
    key = (tuple(_filter_key(p.dtype, op, v) for p, op, v in filters), len(gates),
           tuple(int(card) for _codes, card in tags),
           None if bucket is None else int(bucket[3]),
           None if dtype == torch.int64 else int(pad_gid), dtype)
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = K1Layout([(p.dtype, op, v) for p, op, v in filters], len(gates), key[2], key[3],
                       pad_gid, dtype)
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            _LAYOUTS.clear()
        _LAYOUTS[key] = lay
    return lay


# Rows to skip so that a plane at address p % 16 lies on its vector width
# (16 B; 4 B for byte planes) at row `head`: bit h set where head = h works
def _head_bits(size: int, p16: int) -> int:
    align = 4 if size == 1 else 16
    return sum(1 << h for h in range(4) if (p16 + h * size) % align == 0)


_HEAD_BITS = {size: tuple(_head_bits(size, r) for r in range(16)) for size in (1, 4, 8)}


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
    K1 (csrc/mask_gids.cu); a CPU tile runs `mask_gids_plain`.  The call's
    structure (`k1_layout`) is built once and reused."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"mask_gids ids are int32 or int64, not {dtype}")
    if valid.device.type == "cpu":
        return mask_gids_plain(valid, filters, gates, tags, bucket, pad_gid, dtype, lits)
    return _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype, lits)


def _mask_gids_cuda(valid, filters, gates, tags, bucket, pad_gid, dtype, lits):
    lay = k1_layout(filters, gates, tags, bucket, pad_gid, dtype)
    if lay.fn is None:
        from ..kernels._build import load

        lay.fn = load("mask_gids").gt_mask_gids
    dev = valid.device
    n = int(valid.shape[0])
    keep = []  # tensors the launch reads: alive until it is enqueued
    vptr = _operand(valid, torch.bool, n, dev)
    heads = _HEAD_BITS[1][vptr & 15]
    ts, ts_ptr = None, 0
    if bucket is not None:
        ts = bucket[0]
        ts_ptr = _operand(ts, torch.int64, n, dev)
        heads &= _HEAD_BITS[8][ts_ptr & 15]
    ptrs = []
    for (plane, _op, _value), conv in zip(filters, lay.convert):
        if plane is ts:  # a time-range filter: checked above
            ptrs.append(ts_ptr)
            continue
        src = plane
        if conv is not None:
            if plane.dtype == torch.bool:
                plane = plane.view(torch.uint8)
            if plane.dtype != conv:
                plane = plane.to(conv)
        if not plane.is_contiguous():
            plane = plane.contiguous()
        if plane is not src:
            keep.append(plane)
        ptr = _operand(plane, plane.dtype, n, dev)
        ptrs.append(ptr)
        heads &= _HEAD_BITS[plane.element_size()][ptr & 15]
    for g in gates:
        ptr = _operand(g, torch.bool, n, dev)
        ptrs.append(ptr)
        heads &= _HEAD_BITS[1][ptr & 15]
    for codes, _card in tags:
        ptr = _operand(codes, torch.int32, n, dev)
        ptrs.append(ptr)
        heads &= _HEAD_BITS[4][ptr & 15]
    if lits is None:
        from ..kernels._build import upload_table

        origin, interval = (0, 1) if bucket is None else (bucket[1], bucket[2])
        if bucket is not None and int(interval) == 0:
            raise ValueError("time bucket interval must be non-zero")
        table = literal_table([(p.dtype, op, v) for p, op, v in filters], origin, interval)
        lits = upload_table(table, dev)
    elif lits.device != dev or lits.dtype != torch.int64 or lits.dim() != 1 \
            or not lits.is_contiguous() or lits.shape[0] < lay.n_lits:
        raise ValueError("mask_gids lits must be a contiguous int64 literal table on "
                         f"{dev} of at least {lay.n_lits} entries")
    keep.append(lits)
    # the first row at which every operand lies on its vector width
    head = max((heads & -heads).bit_length() - 1, 0)
    if head == 0:
        gids = torch.empty(n, dtype=dtype, device=dev)
        mask = torch.empty(n, dtype=torch.bool, device=dev)
        gptr, mptr = gids.data_ptr(), mask.data_ptr()
    else:
        # views at an odd row: the ids and the mask of one allocation,
        # placed so that row `head` lies on its vector width too
        size = 8 if dtype == torch.int64 else 4
        goff = -head * size & 15
        moff = ((goff + n * size + 15) & ~15) + (-head & 3)
        out = torch.empty(moff + n, dtype=torch.uint8, device=dev)
        gids, mask = out[goff:goff + n * size].view(dtype), out[moff:].view(torch.bool)
        gptr, mptr = out.data_ptr() + goff, out.data_ptr() + moff
    args = _MaskGidsArgs.from_buffer_copy(lay.template)
    lay.pack.pack_into(args, 0, n, vptr, ts_ptr, lits.data_ptr(), gptr, mptr, *ptrs)
    lay.tail.pack_into(args, _F.head.offset, head, int(heads != 0 and n >= head + 4))
    mask_gids.launches += 1
    _launch(lay.fn, args, torch.cuda.current_stream(dev).cuda_stream)
    return gids, mask


mask_gids.launches = 0


def _launch(fn, args: _MaskGidsArgs, stream: int) -> None:
    """K1's one launch (`gt_mask_gids` with its argument struct and the
    stream); raises on a launch error."""
    err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mask_gids.gt_mask_gids: CUDA launch failed with error {err}")


def _operand(t: torch.Tensor, dtype, n: int, dev) -> int:
    """The pointer of a checked kernel operand."""
    _check(t, dtype, n, dev)
    return t.data_ptr()


def _check(t: torch.Tensor, dtype, n: int, dev) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous {dtype} [{n}] on {dev}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
