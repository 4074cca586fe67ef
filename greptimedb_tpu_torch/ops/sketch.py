"""Approximate aggregate sketches: HyperLogLog and UDDSketch, and B21 as
kernels K20 and K21.

Counterpart of `greptimedb_tpu/ops/sketch.py`.  The host half is the
reference's numpy code as it is (the SQL surface `hll`, `hll_merge`,
`hll_count`, `uddsketch_state`, `uddsketch_merge`, `uddsketch_calc` builds
its states with it, and its serialized states are the reference's bytes).

Both sketches are mergeable states: HLL registers merge by elementwise
MAX, UDDSketch bucket counts by ADD, so per-shard partial sketches fold
into the single-pass sketch.

The device half builds the same states as dense int32 tensors:
  * `segment_hll` -> [G, m] registers, the max of rho over flattened
    (gid, register) ids, clamped at 0 (K20, csrc/segment_hll.cu);
  * `segment_udd` -> [G, B] fixed-range bucket counts of the unmasked rows
    (K21, csrc/segment_udd.cu).  Device histograms clip at the range's
    edges; the host UDDSketch collapses instead.
A CUDA tensor launches the kernel; a CPU tensor runs `segment_hll_plain`
/ `segment_udd_plain`.  There is no fallback from one to the other.
`segment_hll.launches` / `segment_udd.launches` count the launches.

Flat ids follow the reference's int32 arithmetic: `gid * width + col`
wraps in 32-bit two's complement (int64 gids are truncated to int32
first), and ids below 0 or at/after `G * width` are dropped, as JAX's
segment ops drop them.  So an out-of-range gid can alias into a valid
slot, and with G * width >= 2^31 the rows of the last groups wrap
negative and are dropped.

Hashing happens on the host in vectorized numpy (strings via md5 of the
distinct values, deterministic across processes, which merging states
built on different nodes needs).
"""

from __future__ import annotations

import ctypes
import hashlib
import struct

import numpy as np
import pyarrow as pa
import torch

# ---------------------------------------------------------------------------
# 64-bit hashing (host, vectorized)
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (public splitmix64 finalizer)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _SPLITMIX_C1
        z = (z ^ (z >> np.uint64(27))) * _SPLITMIX_C2
        return z ^ (z >> np.uint64(31))


def hash64(values: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Deterministic uint64 hashes of an Arrow column (any type).

    Numerics hash their 64-bit bit pattern; strings/binary hash md5 of the
    dictionary-encoded uniques (cheap: one digest per distinct value).
    Nulls hash to 0 — callers must mask them out.
    """
    if isinstance(values, pa.ChunkedArray):
        values = values.combine_chunks()
    t = values.type
    if pa.types.is_dictionary(t):
        codes = np.asarray(values.indices.fill_null(-1), dtype=np.int64)
        uniq_hashes = hash64(values.dictionary)
        out = np.zeros(len(values), dtype=np.uint64)
        valid = codes >= 0
        out[valid] = uniq_hashes[codes[valid]]
        return out
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
        out = np.zeros(len(values), dtype=np.uint64)
        memo: dict = {}
        pylist = values.to_pylist()
        for i, v in enumerate(pylist):
            if v is None:
                continue
            h = memo.get(v)
            if h is None:
                data = v.encode() if isinstance(v, str) else v
                h = struct.unpack("<Q", hashlib.md5(data).digest()[:8])[0]
                memo[v] = h
            out[i] = h
        return out
    if pa.types.is_floating(t):
        f = np.asarray(values.cast(pa.float64()).fill_null(np.nan))
        bits = f.view(np.uint64).copy()
        bits[f == 0.0] = 0  # -0.0 == 0.0 must hash identically
        return splitmix64(bits)
    if pa.types.is_timestamp(t) or pa.types.is_integer(t) or pa.types.is_boolean(t):
        i64 = np.asarray(values.cast(pa.int64()).fill_null(0), dtype=np.int64)
        return splitmix64(i64.view(np.uint64))
    raise TypeError(f"hll: unhashable column type {t}")


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

HLL_P_DEFAULT = 12  # 4096 registers, ~1.6% standard error (reference uses 14)
_HLL_MAGIC = b"HLL1"


def hll_inputs(hashes: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Split 64-bit hashes into (register index, rho).

    index = top p bits; rho = position of the first 1-bit in the remaining
    64-p bits (1-based), the quantity HLL registers take the max of.
    """
    idx = (hashes >> np.uint64(64 - p)).astype(np.int32)
    w = (hashes << np.uint64(p)).astype(np.uint64)  # remaining bits, left-aligned
    # clz via 6-step binary search (vectorized; exact for all 64-bit values;
    # w == 0 saturates at 63 and is clamped by the rho cap below)
    clz = np.zeros(hashes.shape, dtype=np.int32)
    cur = w.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        high_zero = cur < (np.uint64(1) << np.uint64(64 - shift))
        clz = np.where(high_zero, clz + shift, clz)
        cur = np.where(high_zero, cur << np.uint64(shift), cur)
    rho = np.minimum(clz + 1, 64 - p + 1).astype(np.int32)
    return idx, rho


def hll_build(hashes: np.ndarray, p: int = HLL_P_DEFAULT) -> np.ndarray:
    """Dense HLL registers [2^p] uint8 from a hash array (host path)."""
    m = 1 << p
    idx, rho = hll_inputs(hashes, p)
    regs = np.zeros(m, dtype=np.uint8)
    np.maximum.at(regs, idx, rho.astype(np.uint8))
    return regs


def hll_build_grouped(hashes: np.ndarray, gids: np.ndarray, num_groups: int, p: int = HLL_P_DEFAULT) -> np.ndarray:
    """[num_groups, 2^p] registers (host path, np.maximum.at scatter)."""
    m = 1 << p
    idx, rho = hll_inputs(hashes, p)
    regs = np.zeros(num_groups * m, dtype=np.uint8)
    flat = gids.astype(np.int64) * m + idx
    np.maximum.at(regs, flat, rho.astype(np.uint8))
    return regs.reshape(num_groups, m)


def hll_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def hll_estimate(regs: np.ndarray) -> float | np.ndarray:
    """Bias-corrected HLL cardinality estimate; accepts [m] or [..., m]."""
    regs = np.asarray(regs)
    m = regs.shape[-1]
    if m >= 128:
        alpha = 0.7213 / (1 + 1.079 / m)
    elif m == 64:
        alpha = 0.709
    elif m == 32:
        alpha = 0.697
    else:
        alpha = 0.673
    inv = np.power(2.0, -regs.astype(np.float64)).sum(axis=-1)
    e = alpha * m * m / inv
    zeros = (regs == 0).sum(axis=-1)
    # linear counting for the small range
    small = (e <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lc = m * np.log(m / np.maximum(zeros, 1).astype(np.float64))
    out = np.where(small, lc, e)
    return float(out) if out.ndim == 0 else out


def hll_serialize(regs: np.ndarray) -> bytes:
    m = regs.shape[-1]
    p = int(m).bit_length() - 1
    return _HLL_MAGIC + struct.pack("<B", p) + regs.astype(np.uint8).tobytes()


def hll_deserialize(data: bytes) -> np.ndarray:
    if data[:4] != _HLL_MAGIC:
        raise ValueError("not an HLL state")
    p = struct.unpack("<B", data[4:5])[0]
    m = 1 << p
    return np.frombuffer(data[5 : 5 + m], dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# UDDSketch (approx percentiles over log-spaced buckets)
# ---------------------------------------------------------------------------

_UDD_MAGIC = b"UDD1"
UDD_DEFAULT_BUCKETS = 128
UDD_DEFAULT_ERROR = 0.01


class UddSketch:
    """Collapsing UDDSketch (host, authoritative).

    Buckets: key k covers (γ^(k-1), γ^k] for positives, mirrored negative
    keys for negatives, plus an exact zero count.  When the number of
    distinct buckets exceeds `max_buckets`, γ is squared and keys halve
    (k → ceil(k/2)), doubling the relative error — the standard UDDSketch
    collapse, which keeps states mergeable.
    """

    def __init__(self, max_buckets: int = UDD_DEFAULT_BUCKETS, error: float = UDD_DEFAULT_ERROR):
        if not 0 < error < 1:
            raise ValueError("uddsketch error must be in (0, 1)")
        self.max_buckets = max(8, int(max_buckets))
        self.error = float(error)
        self.gamma = (1 + error) / (1 - error)
        self.pos: dict[int, int] = {}
        self.neg: dict[int, int] = {}
        self.zero = 0

    # -- build --------------------------------------------------------------
    def add_array(self, values: np.ndarray):
        v = np.asarray(values, dtype=np.float64)
        v = v[~np.isnan(v)]
        if v.size == 0:
            return
        self.zero += int((v == 0).sum())
        lg = np.log(self.gamma)
        for sign, side in ((1, self.pos), (-1, self.neg)):
            part = v[v * sign > 0] * sign
            if part.size == 0:
                continue
            ks = np.ceil(np.log(part) / lg).astype(np.int64)
            uniq, counts = np.unique(ks, return_counts=True)
            for k, c in zip(uniq.tolist(), counts.tolist()):
                side[k] = side.get(k, 0) + int(c)
        self._maybe_collapse()

    def _maybe_collapse(self):
        while len(self.pos) + len(self.neg) > self.max_buckets:
            self.gamma = self.gamma * self.gamma
            for name in ("pos", "neg"):
                side = getattr(self, name)
                merged: dict[int, int] = {}
                for k, c in side.items():
                    nk = (k + 1) // 2  # ceil(k/2): (γ²)^nk covers γ^k
                    merged[nk] = merged.get(nk, 0) + c
                setattr(self, name, merged)

    # -- merge --------------------------------------------------------------
    def merge(self, other: "UddSketch"):
        # Align γ: collapse the finer sketch until γ matches (γ collapses by
        # squaring, so two sketches are mergeable iff their γs derive from
        # the same seed by repeated squaring — i.e. the same error param).
        a, b = self, other
        # ln(γ_coarse)/ln(γ_fine) must be an exact power of two, else the
        # sketches came from different error params and can never align.
        import math

        lo, hi = sorted((math.log(a.gamma), math.log(b.gamma)))
        ratio = hi / lo
        j = round(math.log2(ratio)) if ratio > 0 else 0
        if abs(ratio - 2.0**j) > 1e-6 * ratio:
            raise ValueError(
                "cannot merge UDDSketches built with different error "
                f"parameters (gamma {a.gamma} vs {b.gamma})"
            )
        while abs(a.gamma - b.gamma) > 1e-12 * max(a.gamma, b.gamma):
            finer = a if a.gamma < b.gamma else b
            finer.gamma = finer.gamma**2
            for name in ("pos", "neg"):
                side = getattr(finer, name)
                merged: dict[int, int] = {}
                for k, c in side.items():
                    nk = (k + 1) // 2
                    merged[nk] = merged.get(nk, 0) + c
                setattr(finer, name, merged)
        for k, c in other.pos.items():
            self.pos[k] = self.pos.get(k, 0) + c
        for k, c in other.neg.items():
            self.neg[k] = self.neg.get(k, 0) + c
        self.zero += other.zero
        self._maybe_collapse()

    # -- query --------------------------------------------------------------
    def count(self) -> int:
        return self.zero + sum(self.pos.values()) + sum(self.neg.values())

    def _bucket_value(self, k: int, sign: int) -> float:
        # midpoint of (γ^(k-1), γ^k] in log space
        return sign * 2.0 * self.gamma**k / (self.gamma + 1)

    def quantile(self, q: float) -> float:
        if not 0 <= q <= 1:
            raise ValueError("quantile must be in [0, 1]")
        total = self.count()
        if total == 0:
            return float("nan")
        rank = q * (total - 1)
        # ascending value order: negatives (k desc), zero, positives (k asc)
        cum = 0.0
        for k in sorted(self.neg, reverse=True):
            cum += self.neg[k]
            if cum > rank:
                return self._bucket_value(k, -1)
        if self.zero:
            cum += self.zero
            if cum > rank:
                return 0.0
        for k in sorted(self.pos):
            cum += self.pos[k]
            if cum > rank:
                return self._bucket_value(k, +1)
        # numerical edge: return the max bucket
        if self.pos:
            return self._bucket_value(max(self.pos), +1)
        if self.zero:
            return 0.0
        return self._bucket_value(min(self.neg), -1) if self.neg else float("nan")

    # -- serialization ------------------------------------------------------
    def serialize(self) -> bytes:
        items = [(k, c, 1) for k, c in self.pos.items()] + [
            (k, c, -1) for k, c in self.neg.items()
        ]
        out = [
            _UDD_MAGIC,
            struct.pack("<dIqI", self.gamma, self.max_buckets, self.zero, len(items)),
        ]
        for k, c, s in items:
            out.append(struct.pack("<qqb", k, c, s))
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "UddSketch":
        if data[:4] != _UDD_MAGIC:
            raise ValueError("not a UDDSketch state")
        gamma, max_buckets, zero, n = struct.unpack("<dIqI", data[4:28])
        sk = cls.__new__(cls)
        sk.max_buckets = max_buckets
        sk.gamma = gamma
        sk.error = (gamma - 1) / (gamma + 1)
        sk.zero = zero
        sk.pos, sk.neg = {}, {}
        off = 28
        for _ in range(n):
            k, c, s = struct.unpack("<qqb", data[off : off + 17])
            off += 17
            (sk.pos if s > 0 else sk.neg)[k] = c
        return sk


def udd_bucket_ids(values: np.ndarray, gamma: float, n_buckets: int) -> np.ndarray:
    """Fixed-range bucket ids for the DEVICE kernel.

    Layout over [0, n_buckets): negatives in [0, half) (k descending),
    zero at `half`, positives in (half, n_buckets).  Out-of-range keys
    clip to the edges (documented device-path approximation; the host
    UDDSketch collapses instead).
    """
    half = n_buckets // 2
    v = np.asarray(values, dtype=np.float64)
    lg = np.log(gamma)
    out = np.full(v.shape, half, dtype=np.int32)  # zeros (and NaN: masked upstream)
    pos = v > 0
    neg = v < 0
    with np.errstate(divide="ignore", invalid="ignore"):
        kpos = np.ceil(np.log(np.where(pos, v, 1.0)) / lg).astype(np.int64)
        kneg = np.ceil(np.log(np.where(neg, -v, 1.0)) / lg).astype(np.int64)
    span = half - 1
    # positives: k shifted into [0, span) then mapped above `half`
    out_pos = np.clip(kpos + span // 2, 0, span - 1) + half + 1
    out_neg = half - 1 - np.clip(kneg + span // 2, 0, span - 1)
    out = np.where(pos, out_pos, out)
    out = np.where(neg, out_neg, out)
    return np.clip(out, 0, n_buckets - 1).astype(np.int32)


def udd_value_of_bucket(b: np.ndarray | int, gamma: float, n_buckets: int):
    """Inverse of `udd_bucket_ids` (bucket midpoint values)."""
    half = n_buckets // 2
    span = half - 1
    b = np.asarray(b)
    k_pos = b - half - 1 - span // 2
    k_neg = (half - 1 - b) - span // 2
    mid_pos = 2.0 * np.power(gamma, k_pos.astype(np.float64)) / (gamma + 1)
    mid_neg = -2.0 * np.power(gamma, k_neg.astype(np.float64)) / (gamma + 1)
    out = np.where(b > half, mid_pos, np.where(b < half, mid_neg, 0.0))
    return out


def udd_quantile_dense(counts: np.ndarray, q: float, gamma: float) -> np.ndarray:
    """Percentile from dense [..., B] device histograms (host finalize)."""
    counts = np.asarray(counts, dtype=np.int64)
    n_buckets = counts.shape[-1]
    total = counts.sum(axis=-1)
    rank = q * np.maximum(total - 1, 0)
    cum = np.cumsum(counts, axis=-1)
    # first bucket whose cumulative count exceeds rank
    idx = (cum <= rank[..., None]).sum(axis=-1)
    idx = np.minimum(idx, n_buckets - 1)
    vals = udd_value_of_bucket(idx, gamma, n_buckets)
    return np.where(total > 0, vals, np.nan)


# ---------------------------------------------------------------------------
# Device half: K20 segment_hll, K21 segment_udd
# ---------------------------------------------------------------------------

_INT_TYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _flat_ids(gids, cols, width: int, total: int):
    """(flat int64 ids, in-range mask): `gid * width + col` in wrapping
    int32 arithmetic, kept where 0 <= id < total (JAX's segment ops drop
    the rest)."""
    flat = gids.to(torch.int32).to(torch.int64) * int(width) + cols.to(torch.int32).to(torch.int64)
    flat = ((flat + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return flat, (flat >= 0) & (flat < total)


def segment_hll_plain(reg_idx, rho, gids, num_groups: int, m: int):
    """Torch-op version of K20: [num_groups, m] int32 registers, the max of
    `rho` per flattened (gid, register) id, 0 where no row lands or every
    rho is below 0."""
    total = int(num_groups) * int(m)
    flat, keep = _flat_ids(gids, reg_idx, m, total)
    regs = torch.zeros(total, dtype=torch.int32, device=rho.device)
    regs.scatter_reduce_(0, flat[keep], rho.to(torch.int32)[keep], "amax")
    return regs.reshape(int(num_groups), int(m))


# K20's and K21's two device paths (csrc/segment_hll.cu, segment_udd.cu).
# The ordered path (csrc/group_runs.cuh) keeps a window of RUN_WINDOW_INTS
# ints (one group's row from a width of RUN_WINDOW_INTS up to
# RUN_MAX_WIDTH) in one block's shared memory; an owner block takes a
# window's first `tile_rows` rows and helper blocks the rest.
RUN_WINDOW_INTS = 4096
RUN_MAX_WIDTH = 1 << 15
RUN_MIN_TILE_ROWS = 1 << 16
RUN_TILES = 264  # two blocks a streaming multiprocessor of the H100


def run_layout(n: int, num_groups: int, width: int) -> tuple[bool, int, int]:
    """(whether the ordered path may run, groups per window, rows an owner
    or helper block takes) for n rows of `width` ints a group: the ordered
    path needs G * width below 2^31 (no int32 wrap) and a group's row in
    shared memory."""
    ordered = int(num_groups) * int(width) < (1 << 31) and int(width) <= RUN_MAX_WIDTH
    cap = max(1, RUN_WINDOW_INTS // int(width))
    tile = max(RUN_MIN_TILE_ROWS, 1 << max(int(n) // RUN_TILES - 1, 0).bit_length())
    return ordered, cap, tile


def hll_layout(n: int, num_groups: int, m: int) -> tuple[bool, int, int]:
    """K20's `run_layout`, m registers a group."""
    return run_layout(n, num_groups, m)


RUN_GROUP_ROWS = 256  # rows a group from which K21's windows are one group each
UDD_MIN_TILE_ROWS = 1 << 13
UDD_TILES = 528  # four blocks a streaming multiprocessor of the H100


def udd_layout(n: int, num_groups: int, n_buckets: int) -> tuple[bool, int, int]:
    """K21's `run_layout`, n_buckets counts a group; a window is one group
    where the groups average RUN_GROUP_ROWS rows or more (its owner then
    reads no gids: phase 9's hosts hold 2160 rows each), and a long run is
    cut into tiles of n / UDD_TILES rows (a power of two, at least
    UDD_MIN_TILE_ROWS), so its helper blocks fill the card."""
    ordered, cap, _tile = run_layout(n, num_groups, n_buckets)
    if int(n) >= int(num_groups) * RUN_GROUP_ROWS:
        cap = 1
    tile = max(UDD_MIN_TILE_ROWS, 1 << max(int(n) // UDD_TILES - 1, 0).bit_length())
    return ordered, cap, tile


def segment_udd_plain(bucket_ids, gids, mask, num_groups: int, n_buckets: int):
    """Torch-op version of K21: [num_groups, n_buckets] int32 counts of the
    rows where `mask` holds, per flattened (gid, bucket) id."""
    total = int(num_groups) * int(n_buckets)
    flat, keep = _flat_ids(gids, bucket_ids, n_buckets, total)
    keep &= mask.to(torch.bool)
    counts = torch.zeros(total, dtype=torch.int32, device=bucket_ids.device)
    sel = flat[keep]
    counts.index_add_(0, sel, torch.ones(sel.shape, dtype=torch.int32, device=sel.device))
    return counts.reshape(int(num_groups), int(n_buckets))


class _HllArgs(ctypes.Structure):
    # mirrored field for field by HllArgs in csrc/segment_hll.cu
    _fields_ = [("n", ctypes.c_int64), ("total", ctypes.c_int64), ("reg", ctypes.c_void_p),
                ("rho", ctypes.c_void_p), ("gids", ctypes.c_void_p), ("regs", ctypes.c_void_p),
                ("verdict", ctypes.c_void_p), ("windows", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("groups", ctypes.c_int64),
                ("n_windows", ctypes.c_int64), ("tile_rows", ctypes.c_int64),
                ("n_tiles", ctypes.c_int64), ("stride", ctypes.c_int64), ("m", ctypes.c_int32),
                ("cap", ctypes.c_int32), ("ordered", ctypes.c_int32), ("reserved", ctypes.c_int32)]


class _UddArgs(ctypes.Structure):
    # mirrored field for field by UddArgs in csrc/segment_udd.cu
    _fields_ = [("n", ctypes.c_int64), ("total", ctypes.c_int64), ("bucket", ctypes.c_void_p),
                ("gids", ctypes.c_void_p), ("mask", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("verdict", ctypes.c_void_p), ("windows", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("groups", ctypes.c_int64),
                ("n_windows", ctypes.c_int64), ("tile_rows", ctypes.c_int64),
                ("n_tiles", ctypes.c_int64), ("stride", ctypes.c_int64),
                ("n_buckets", ctypes.c_int32), ("cap", ctypes.c_int32), ("ordered", ctypes.c_int32),
                ("reserved", ctypes.c_int32)]


_VERDICT_INTS = 32  # the verdict word's own 128-byte line: the run pass polls it


def _run_buffers(layout, n: int, num_groups: int, width: int, dev):
    """The ordered path's fields of a K20 or K21 argument struct for the
    call's `layout` (n_windows, tile_rows, n_tiles, stride, cap, ordered),
    its buffers and their pointers (verdict, windows, scratch): `aux`, the
    int32 verdict word (alone on its 128-byte line, which every warp of the
    run pass polls while run ends are stored to the window table) and the
    window table (2 int64 a window, cleared by the same memset), then the
    helpers' partial rows, apart so that a kept verdict holds no more."""
    ordered, cap, tile = layout
    n_windows = -(-int(num_groups) // cap)
    n_tiles = -(-n // tile) if ordered else 0
    stride = -(-(cap * int(width)) // 4) * 4
    table = 4 * n_windows if ordered else 0
    aux = torch.empty(_VERDICT_INTS + table, dtype=torch.int32, device=dev)
    scratch = torch.empty(n_tiles * stride, dtype=torch.int32, device=dev)
    base = aux.data_ptr()
    ptrs = (base, base + 4 * _VERDICT_INTS, scratch.data_ptr())
    return (n_windows, tile, n_tiles, stride, cap, int(ordered)), (aux, scratch), ptrs


def _int32_rows(name: str, t, n: int, dev):
    """`t` as a contiguous int32 [n] tensor on `dev` (int64 truncated, as
    `astype(int32)`); raises on another device, type or shape."""
    if t.device != dev or t.dtype not in _INT_TYPES or tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be an integer [{n}] tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _check_width(num_groups: int, width: int, what: str) -> int:
    if num_groups < 0 or not 0 < width < (1 << 31):
        raise ValueError(f"{what}: bad num_groups {num_groups} or width {width}")
    return int(num_groups) * int(width)


def segment_hll(reg_idx, rho, gids, num_groups: int, m: int):
    """K20: per-group HLL registers, [num_groups, m] int32.

    reg_idx/rho come from `hll_inputs` (host), gids are group ids; all [N]
    integer tensors on one device.  Merge partials with `torch.maximum`
    (the HLL union is elementwise max).  A CUDA tensor launches
    csrc/segment_hll.cu: rows in sorted group runs take the ordered path
    (each window of registers built once in shared memory), any others the
    atomic path, decided on the card (`last_hll_path()` reads which); a
    CPU tensor runs `segment_hll_plain`."""
    if rho.device.type == "cpu":
        return segment_hll_plain(reg_idx, rho, gids, num_groups, m)
    from ..kernels._build import launch

    dev = rho.device
    n = int(rho.shape[0]) if rho.dim() == 1 else -1
    total = _check_width(num_groups, m, "segment_hll")
    reg = _int32_rows("segment_hll: reg_idx", reg_idx, n, dev)
    r = _int32_rows("segment_hll: rho", rho, n, dev)
    g = _int32_rows("segment_hll: gids", gids, n, dev)
    regs = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        segment_hll.last_verdict = torch.ones(1, dtype=torch.int32, device=dev)
        return regs.reshape(int(num_groups), int(m))
    (n_windows, tile, n_tiles, stride, cap, ordered), (aux, scratch), ptrs = _run_buffers(
        hll_layout(n, num_groups, m), n, num_groups, m, dev)
    segment_hll.last_verdict = aux  # its first word
    a = _HllArgs(n, total, reg.data_ptr(), r.data_ptr(), g.data_ptr(), regs.data_ptr(), *ptrs,
                 int(num_groups), n_windows, tile, n_tiles, stride, int(m), cap, ordered, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    segment_hll.launches += 1
    launch("segment_hll", "gt_segment_hll", a, stream)
    return regs.reshape(int(num_groups), int(m))


segment_hll.launches = 0
segment_hll.last_verdict = None


def path_of(verdict) -> str | None:
    """The path a K20 or K21 call took, from the verdict it kept
    (`segment_hll.last_verdict`, `segment_udd.last_verdict`): a host read."""
    return None if verdict is None else ("ordered" if int(verdict.reshape(-1)[0]) == 0
                                         else "atomic")


def last_hll_path() -> str | None:
    """The path the last `segment_hll` call on the card took, "ordered" or
    "atomic" (a host read of its verdict word: call it after a sync)."""
    return path_of(segment_hll.last_verdict)


def segment_udd(bucket_ids, gids, mask, num_groups: int, n_buckets: int):
    """K21: [num_groups, n_buckets] int32 histogram of the rows where
    `mask` holds (bucket ids from `udd_bucket_ids`).  Merge partials with
    `+` (bucket counts add).  A CUDA tensor launches csrc/segment_udd.cu:
    rows in sorted group runs take the ordered path (each window of
    histograms built once in shared memory), any others the atomic path,
    decided on the card (`last_udd_path()` reads which); a CPU tensor runs
    `segment_udd_plain`."""
    if bucket_ids.device.type == "cpu":
        return segment_udd_plain(bucket_ids, gids, mask, num_groups, n_buckets)
    from ..kernels._build import launch

    dev = bucket_ids.device
    n = int(bucket_ids.shape[0]) if bucket_ids.dim() == 1 else -1
    total = _check_width(num_groups, n_buckets, "segment_udd")
    b = _int32_rows("segment_udd: bucket_ids", bucket_ids, n, dev)
    g = _int32_rows("segment_udd: gids", gids, n, dev)
    if mask.device != dev or mask.dtype != torch.bool or tuple(mask.shape) != (n,):
        raise ValueError(f"segment_udd: mask must be a bool [{n}] tensor on {dev}, "
                         f"got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    mk = mask.contiguous()
    counts = torch.empty(total, dtype=torch.int32, device=dev)
    if total == 0:
        segment_udd.last_verdict = torch.ones(1, dtype=torch.int32, device=dev)
        return counts.reshape(int(num_groups), int(n_buckets))
    (n_windows, tile, n_tiles, stride, cap, ordered), (aux, scratch), ptrs = _run_buffers(
        udd_layout(n, num_groups, n_buckets), n, num_groups, n_buckets, dev)
    segment_udd.last_verdict = aux  # its first word
    a = _UddArgs(n, total, b.data_ptr(), g.data_ptr(), mk.data_ptr(), counts.data_ptr(), *ptrs,
                 int(num_groups), n_windows, tile, n_tiles, stride, int(n_buckets), cap, ordered,
                 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    segment_udd.launches += 1
    launch("segment_udd", "gt_segment_udd", a, stream)
    return counts.reshape(int(num_groups), int(n_buckets))


segment_udd.launches = 0
segment_udd.last_verdict = None


def last_udd_path() -> str | None:
    """The path the last `segment_udd` call on the card took, "ordered" or
    "atomic" (a host read of its verdict word: call it after a sync).  Rows
    in order with an unmasked bucket outside [0, n_buckets) read "atomic":
    the owners store their windows and those rows go by global atomics."""
    return path_of(segment_udd.last_verdict)
