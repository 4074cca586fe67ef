"""Vector distance + top-k: kernel K19.

Counterpart of `greptimedb_tpu/ops/vector.py`.  `topk_distances` is the
device half of an `ORDER BY vec_*_distance(col, literal) LIMIT k` scan: an
[N, d] x [d] matvec, the distance, invalid rows pushed to the losing end,
and the k best rows in `lax.top_k`'s order.  A CUDA tensor launches the
hand-written kernel (csrc/topk_distances.cu); a CPU tensor runs
`topk_distances_plain`.  There is no fallback from one to the other.
`topk_distances.launches` counts the kernel's launches.

`topk_host` is the route's host entry, as the reference's: numpy below
`_DIST_THRESHOLD_ROWS` rows, `topk_distances` on the caller's device at
or above it.

Order.  `lax.top_k` orders scores totally (+NaN > +inf > ... > +0 > -0 >
... > -inf > -NaN) and breaks ties toward the lower index.  Both forms
rank 64-bit keys: the score's bits under the usual total-order flip in
the high half, the bit-inverted row in the low half, so every key
differs.

NaN.  The reference ranks on x86, where an operation that makes a NaN
from non-NaN operands gives the sign-set default NaN (0xFFC00000) and an
operation on a NaN passes that NaN on.  The card's arithmetic NaN is
positive.  So both forms replace a NaN distance by the bits of the row's
first NaN component (quieted), else of the query's first NaN component,
else by the default NaN: what the reference computes wherever a single
NaN reaches the distance.  Rows with several NaN components of different
signs, or with a NaN and an infinity the sum meets first, depend on the
reference's summation order (ROADMAP, divergences).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .radix import _RadixPlan, _RadixScratch, plan_struct, radix_plan, radix_scratch, sort_record

_DIST_THRESHOLD_ROWS = 100_000  # below this, numpy wins (no H2D copy)

METRICS = {"dot": 0, "l2sq": 1, "cos": 2}
# the kernel sorts up to this many survivors in one block's shared memory;
# more take the one-sweep radix sort of csrc/radix.cuh
SMALL_K = 2048

_SIGN = -(1 << 31)  # int32 sign bit
_QUIET = 0x00400000
_DEFAULT_NAN = np.int32(np.uint32(0xFFC00000).view(np.int32))
_POS_INF = 0x7F800000
_NEG_INF = int(np.uint32(0xFF800000).view(np.int32))


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown vector metric {metric!r}: use one of {sorted(METRICS)}")


def _first_nan_bits(x: torch.Tensor, dim: int):
    """(has a NaN, quieted int32 bits of the first NaN) along `dim`."""
    isn = torch.isnan(x)
    has = isn.any(dim)
    first = isn.to(torch.uint8).argmax(dim, keepdim=True)
    bits = x.contiguous().view(torch.int32).gather(dim, first).squeeze(dim)
    return has, bits | _QUIET


def _sqrt_rn(x):
    """The correctly rounded f32 square root (XLA's and the kernel's):
    torch's vectorized CPU sqrt is not always, the f64 root rounded once
    to f32 is."""
    return torch.sqrt(x.double()).to(torch.float32)


def topk_distances_plain(mat, valid, q, metric: str = "cos", k: int = 10,
                         ascending: bool = True):
    """Torch-op version of K19: -> (dist f32 [k], idx int64 [k])."""
    bits, hi = score_bits(mat, valid, q, metric, ascending)
    row = torch.arange(mat.shape[0], dtype=torch.int64, device=mat.device)
    keys = hi * (1 << 32) + ((1 << 32) - 1 - row)
    _top, idx = torch.topk(keys, int(k))
    return bits[idx].view(torch.float32), idx


def score_bits(mat, valid, q, metric: str = "cos", ascending: bool = True):
    """(bits int32 [N], hi int64 [N]): each row's distance as K19 ranks
    it (invalid rows at the losing end, a NaN's bits by the rule above)
    and its score's bits under the total-order flip, the high half of
    the row's key (larger ranks first)."""
    _check_metric(metric)
    n, d = mat.shape
    # XLA's dot of one component is the product itself (a -0 stays -0)
    dots = mat[:, 0] * q[0] if d == 1 else mat @ q
    if metric == "dot":
        dist = dots
    elif metric == "l2sq":
        dist = torch.sum(mat * mat, dim=1) - 2.0 * dots + torch.dot(q, q)
    else:
        denom = _sqrt_rn(torch.sum(mat * mat, dim=1)) * _sqrt_rn(torch.dot(q, q))
        sim = torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30), 0.0)
        dist = 1.0 - sim
    bits = dist.contiguous().view(torch.int32)
    if d:
        row_has, row_bits = _first_nan_bits(mat, 1)
        q_has, q_bits = _first_nan_bits(q[None, :], 1)
        fill = torch.where(row_has, row_bits,
                           torch.where(q_has, q_bits, torch.tensor(_DEFAULT_NAN, device=mat.device)))
        bits = torch.where(torch.isnan(dist), fill, bits)
    bits = torch.where(valid, bits, _POS_INF if ascending else _NEG_INF)
    score = bits ^ _SIGN if ascending else bits
    hi = torch.where(score < 0, score ^ 0x7FFFFFFF, score).to(torch.int64)
    return bits, hi


class _TopkArgs(ctypes.Structure):
    # mirrored field for field by TopkArgs in csrc/topk_distances.cu
    _fields_ = [
        ("n", ctypes.c_int64), ("k", ctypes.c_int64), ("mat", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("q", ctypes.c_void_p), ("hi", ctypes.c_void_p),
        ("cand", ctypes.c_void_p), ("sel", ctypes.c_void_p), ("state", ctypes.c_void_p),
        ("dist", ctypes.c_void_p), ("idx", ctypes.c_void_p), ("d", ctypes.c_int32),
        ("metric", ctypes.c_int32), ("ascending", ctypes.c_int32), ("vec4", ctypes.c_int32),
        ("kernels", ctypes.c_int32), ("memsets", ctypes.c_int32),
        ("sort_plan", _RadixPlan), ("sort", _RadixScratch),
    ]


# bytes of the select's state (TopkState in csrc/topk_distances.cu: two
# 4096-bin histograms, six 32-bit words, the k-th key), zeroed by the
# kernel's memset; the candidates' keys follow it at a 256-byte offset
_STATE_BYTES = 2 * 4096 * 4 + 6 * 4 + 8
_CAND_AT = -(-_STATE_BYTES // 256) * 256


def topk_launch_plan(k: int) -> dict:
    """The kernels and memsets one K19 call launches at `k` (`n` >= `k`):
    at k <= SMALL_K the distance pass with the first digit's histogram,
    the candidates' compaction and the one-CTA final select and sort, after
    the state's memset; past it also the compaction of the k largest and
    the radix sort (its memset, histogram and one kernel a pass)."""
    if k <= SMALL_K:
        return {"kernels": 3, "memsets": 1}
    return {"kernels": 4 + 1 + radix_plan((1 << 64) - 1).n_passes, "memsets": 2}


def topk_distances(mat, valid, q, metric: str = "cos", k: int = 10, ascending: bool = True):
    """K19: -> (dist f32 [k], idx int64 [k]), the k best rows of `mat`
    [N, d] f32 (invalid rows zero-filled) by distance to `q` [d] f32, in
    `lax.top_k`'s order; `valid` [N] bool pushes the other rows to the
    losing end.  A CUDA tensor launches csrc/topk_distances.cu (the kernels
    and memsets it launched land in `topk_distances.last_launches`; past
    k = 2048 what its radix sort ran in `topk_distances.last_sort`); a CPU
    tensor runs `topk_distances_plain`."""
    if mat.device.type == "cpu":
        return topk_distances_plain(mat, valid, q, metric, k, ascending)
    from ..kernels._build import launch

    _check_metric(metric)
    dev = mat.device
    if mat.dim() != 2:
        raise ValueError(f"topk_distances takes an [N, d] matrix, got shape {tuple(mat.shape)}")
    n, d = (int(x) for x in mat.shape)
    k = int(k)
    if n >= 1 << 31:
        raise ValueError(f"topk_distances takes fewer than 2^31 rows, got {n}")
    if not 1 <= k <= n:
        raise ValueError(f"topk_distances needs 1 <= k <= N, got k={k}, N={n}")
    for name, t, dtype, shape in (("mat", mat, torch.float32, (n, d)),
                                  ("valid", valid, torch.bool, (n,)),
                                  ("q", q, torch.float32, (d,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"topk_distances: {name} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    # one scratch buffer: the state, the candidates' keys (8 B a row), each
    # row's flipped score (4 B), and past SMALL_K the k largest keys
    sel_at = -(-(_CAND_AT + 12 * n) // 256) * 256
    scratch = torch.empty(sel_at + (8 * k if k > SMALL_K else 0), dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    dist = torch.empty(k, dtype=torch.float32, device=dev)
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    # past the one-block sort, the survivors' full 64-bit keys by radix.cuh
    plan, keep, sort = None, [], _RadixScratch()
    if k > SMALL_K:
        plan = radix_plan((1 << 64) - 1)
        keep, sort = radix_scratch(k, plan, dev)
    vec4 = d % 4 == 0 and mat.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    a = _TopkArgs(n, k, mat.data_ptr(), valid.data_ptr(), q.data_ptr(), base + _CAND_AT + 8 * n,
                  base + _CAND_AT, base + sel_at if k > SMALL_K else None, base,
                  dist.data_ptr(), idx.data_ptr(), d, METRICS[metric], int(bool(ascending)),
                  int(vec4), 0, 0, _RadixPlan() if plan is None else plan_struct(plan), sort)
    topk_distances.launches += 1
    launch("topk_distances", "gt_topk_distances", a, torch.cuda.current_stream(dev).cuda_stream)
    topk_distances.last_launches = {"k": k, "kernels": a.kernels, "memsets": a.memsets}
    topk_distances.last_sort = None if plan is None else sort_record(plan, a.sort.kernels)
    # the scratch is freed into the caching allocator and reused only by
    # work queued after these launches on the same stream
    del scratch, keep
    return dist, idx


topk_distances.launches = 0
topk_distances.last_launches = None
topk_distances.last_sort = None


def topk_host(mat, valid, q, metric: str, k: int, ascending: bool = True,
              device="cpu", timings: dict | None = None):
    """Host entry: numpy for small inputs, `topk_distances` on `device`
    for large ones (the three inputs uploaded there first); returns (dist
    np[k'], idx np[k']) with invalid rows dropped.  `timings`, when given,
    accumulates the host ms of the upload ("upload", device route only)
    and of the ranking ("rank": numpy, or the kernel and its readback)."""
    n = len(mat)
    k = min(k, n)
    if k == 0:
        return np.array([]), np.array([], dtype=np.int64)
    t0 = time.perf_counter()
    if n < _DIST_THRESHOLD_ROWS:
        from ..query.vector import distances

        d = distances(np.asarray(mat), np.asarray(q), metric)
        bad = np.inf if ascending else -np.inf
        d = np.where(valid, d, bad)
        if k < n:
            sel = np.argpartition(d if ascending else -d, k - 1)[:k]
        else:
            sel = np.arange(n)
        order = np.argsort(d[sel] if ascending else -d[sel])
        sel = sel[order]
        keep = valid[sel]
        if timings is not None:
            timings["rank"] = timings.get("rank", 0.0) + (time.perf_counter() - t0) * 1e3
        return d[sel][keep], sel[keep]
    dev = torch.device(device)
    mat_t = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.float32)).to(dev)
    valid_t = torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)).to(dev)
    q_t = torch.from_numpy(np.array(q, dtype=np.float32)).to(dev)  # q may be read-only
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    dist, idx = topk_distances(mat_t, valid_t, q_t, metric=metric, k=k, ascending=ascending)
    dist, idx = dist.cpu().numpy(), idx.cpu().numpy().astype(np.int64)
    if timings is not None:
        timings["upload"] = timings.get("upload", 0.0) + (t1 - t0) * 1e3
        timings["rank"] = timings.get("rank", 0.0) + (time.perf_counter() - t1) * 1e3
    keep = np.asarray(valid)[idx]
    return dist[keep], idx[keep]
