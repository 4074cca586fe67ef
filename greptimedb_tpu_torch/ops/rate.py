"""PromQL range-vector kernels: counter-reset strip, per-window statistics,
rate / increase / delta and *_over_time, and the by-label series fold.

Counterpart of `greptimedb_tpu/ops/rate.py` (B14-B16) and of the fold in
`greptimedb_tpu/query/promql/tile_exec.py::_finalize` (B17).  Instead of a
ragged range-vector matrix, every (series, eval step) cell of a dense
[S * W] layout gets the statistics of the samples in its window
(t_w - range, t_w]; the rate family and *_over_time are elementwise on
them.

Samples arrive as a `RowSource`: rows sorted by (series, ts) in chunk
lists, either with a series-id plane (the legacy scan) or with the
super-tile planes (tag codes, ts in the column's unit, value, present
mask, valid/keep plane) plus the fetch bound and the matcher masks, the
prologue of the reference's `_region_stats`.

Four kernels, each beside its plain torch version and a launch counter.
A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version:

* K9 `strip_counter_resets` (csrc/strip_counter_resets.cu, B14);
* K10 `range_windows` (csrc/range_windows.cu, B15);
* K11 `range_finalize` (csrc/range_finalize.cu, B16: the selection merge
  of series-disjoint regions, then the function, NaN where undefined);
* K12 `series_fold` (csrc/series_fold.cu, B17's by-label fold).

Numerics against the reference: K10 adds a window's samples in the
reference's order (pass j sums the samples whose first window is w - j,
in row order from 0.0; passes are added newest first), K11 rounds every
f64 operation separately as XLA does, and K12 adds series in ascending
id order.  K9 re-accumulates resets with a per-series running sum in row
order, where the reference subtracts a per-series baseline from a global
cumulative sum: the two agree exactly on series without a reset and to
the last ulp on series with one.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .aggregate import _check_rows

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
F64_MAX = torch.finfo(torch.float64).max
F64_MIN = torch.finfo(torch.float64).min
SLICE_BYTES = 68  # a slice of K10's table: 7 x 8 B of statistics, count, row range

RATE_FUNCS = ("rate", "increase", "delta")
OVER_TIME_FUNCS = (
    "avg_over_time", "sum_over_time", "min_over_time", "max_over_time",
    "count_over_time", "last_over_time",
)
# K11's function codes; "__last_ts" is timestamp()'s last sample time (s)
FUNC_CODES = {f: i for i, f in enumerate(RATE_FUNCS + OVER_TIME_FUNCS + ("__last_ts",))}
FOLD_OPS = {"sum": 0, "avg": 1, "mean": 1, "count": 2, "min": 3, "max": 4}


@dataclass(frozen=True)
class RangeSpec:
    """Static description of a PromQL range query evaluation grid."""

    start: int  # first eval timestamp (ms)
    end: int  # last eval timestamp (ms, inclusive)
    step: int  # eval step (ms)
    range_: int  # range-vector selector length (ms)

    @property
    def num_steps(self) -> int:
        return (self.end - self.start) // self.step + 1

    @property
    def windows_per_sample(self) -> int:
        return -(-self.range_ // self.step)  # ceil


@dataclass(frozen=True)
class RangeGrid:
    """The [num_series * n_steps] cell layout and the evaluation grid:
    cell (s, w) is series s at t_w = start + w * step, window
    (t_w - range_, t_w].  Steps at or past `n_steps_actual` are padding
    and stay empty; a sample falls into at most `k` windows."""

    start: int
    step: int
    range_: int
    n_steps: int
    k: int
    num_series: int
    n_steps_actual: int


@dataclass
class WindowStats:
    """Per-(series, window) statistics; each tensor is [num_series * n_steps].
    Empty cells hold count 0, first_ts INT64_MAX, last_ts INT64_MIN,
    first/last_val and max the f64 minimum, sum 0.0, min the f64 maximum
    (the reference's initial values)."""

    count: torch.Tensor
    first_ts: torch.Tensor
    last_ts: torch.Tensor
    first_val: torch.Tensor
    last_val: torch.Tensor
    sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor

    FIELDS = ("count", "first_ts", "last_ts", "first_val", "last_val", "sum", "min", "max")

    def tensors(self) -> tuple:
        return tuple(getattr(self, f) for f in self.FIELDS)


@dataclass
class RowSource:
    """Sample rows sorted by (series, ts), as lists of chunk tensors of one
    length (the last may be shorter).

    The legacy scan gives `sid` (int32 series ids) with ts already in ms.
    The tile path gives one int32 code plane per tag (`codes`, the pk tag
    order), `radices` (the padded cardinality of each tag: series id =
    mixed radix of the codes) and `masks` ((tag index, bool [card_pad])
    per tag with a matcher); a row is fetched when it is valid, its ts
    (native unit) lies in [lo, hi), its codes are >= 0 and its masks
    hold.  `nulls` marks present values (absent ones read as NaN)."""

    ts: list
    values: list
    num_series: int
    sid: list | None = None
    codes: tuple = ()
    radices: tuple = ()
    masks: tuple = ()
    nulls: list | None = None
    valid: list | None = None
    lo: int | None = None
    hi: int | None = None
    unit_ns: int = 1_000_000
    offset: int = 0

    @property
    def device(self) -> torch.device:
        return self.ts[0].device


# ---- plain versions ------------------------------------------------------------


def _cat(chunks):
    return chunks[0] if len(chunks) == 1 else torch.cat(list(chunks))


def ts_to_ms(ts_nat: torch.Tensor, unit_ns: int, offset: int) -> torch.Tensor:
    """Native unit -> ms by truncating (floor) division, then the offset
    modifier: the legacy fetch's conversion.  Millisecond columns skip
    the multiply, which could overflow at ns-scale values."""
    if unit_ns == 1_000_000:
        return ts_nat + offset
    return torch.div(ts_nat * unit_ns, 1_000_000, rounding_mode="floor") + offset


def source_rows(src: RowSource):
    """The plain prologue: flat (sid int32, ts_ms int64, values f64,
    in_fetch bool) of a source (reference `_region_stats`, :122-158)."""
    ts_nat = _cat(src.ts)
    vf = _cat(src.values).to(torch.float64)
    if src.nulls is not None:
        vf = torch.where(_cat(src.nulls), vf, torch.full_like(vf, float("nan")))
    in_fetch = (_cat(src.valid).clone() if src.valid is not None
                else torch.ones(ts_nat.shape[0], dtype=torch.bool, device=ts_nat.device))
    if src.lo is not None:
        in_fetch &= (ts_nat >= src.lo) & (ts_nat < src.hi)
    if src.sid is not None:
        sid = _cat(src.sid).to(torch.int32)
    else:
        codes = [_cat(c) for c in src.codes]
        for c in codes:
            in_fetch &= c >= 0
        for ti, mask in src.masks:
            c = codes[ti]
            card_pad = int(mask.shape[0])
            in_fetch &= (c < card_pad) & mask[c.clamp(0, card_pad - 1).long()]
        sid = torch.zeros(ts_nat.shape[0], dtype=torch.int64, device=ts_nat.device)
        stride = 1
        for c, r in zip(reversed(codes), reversed(src.radices)):
            sid += c.to(torch.int64) * stride
            stride *= int(r)
        sid = sid.to(torch.int32)
    return sid, ts_to_ms(ts_nat, src.unit_ns, src.offset), vf, in_fetch


def _scalar(like: torch.Tensor, x: float) -> torch.Tensor:
    """`x` as a tensor divisor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can round differently from the
    true division XLA and the kernels do."""
    return torch.full_like(like, float(x), dtype=torch.float64)


def _runs(key: torch.Tensor):
    """(starts, lengths) of the runs of equal values in a sorted 1-D key."""
    m = int(key.shape[0])
    if m == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=key.device)
        return empty, empty
    head = torch.ones(m, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:], torch.tensor([m], device=key.device)])
    return starts, ends - starts


def _run_stats(v, t, starts, lengths):
    """Per run of rows (in row order): count, first and last ts, the sum
    from 0.0 in row order (the order of XLA's sequential segment scatter),
    min and max (NaN propagates), and the largest value at the first and at
    the last ts."""
    R = int(starts.shape[0])
    dev, dt = v.device, v.dtype
    count = torch.zeros(R, dtype=torch.int32, device=dev)
    first = torch.full((R,), INT64_MAX, dtype=torch.int64, device=dev)
    last = torch.full((R,), INT64_MIN, dtype=torch.int64, device=dev)
    total = torch.zeros(R, dtype=dt, device=dev)
    mn = torch.full((R,), float("inf"), dtype=dt, device=dev)
    mx = torch.full((R,), float("-inf"), dtype=dt, device=dev)
    at_first = mx.clone()
    at_last = mx.clone()
    longest = int(lengths.max()) if R else 0

    def rows(r):
        live = torch.nonzero(lengths > r).flatten()
        i = starts[live] + r
        return live, v[i], t[i]

    for r in range(longest):
        live, x, tx = rows(r)
        count[live] += 1
        first[live] = torch.minimum(first[live], tx)
        last[live] = torch.maximum(last[live], tx)
        total[live] = total[live] + x
        mn[live] = torch.minimum(mn[live], x)
        mx[live] = torch.maximum(mx[live], x)
    for r in range(longest):
        live, x, tx = rows(r)
        small = torch.full_like(x, F64_MIN)
        at_first[live] = torch.maximum(at_first[live], torch.where(tx == first[live], x, small))
        at_last[live] = torch.maximum(at_last[live], torch.where(tx == last[live], x, small))
    return count, first, last, total, mn, mx, at_first, at_last


def _bisect(t, lo, hi, key):
    """Per run [lo, hi) of ascending t: the first row with t > key (hi if
    none), by a bisection over all runs at once."""
    lo, hi = lo.clone(), hi.clone()
    last = max(int(t.shape[0]) - 1, 0)
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go = active & (t[mid.clamp(max=last)] <= key)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)


def strip_counter_resets_plain(series: torch.Tensor, values: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """B14 on valid rows: after a counter reset (a value below the previous
    valid value of the same series) add the pre-reset value to a running
    sum kept per series in row order, so adjusted values never decrease.
    Outputs of invalid rows are not meaningful."""
    n = int(series.shape[0])
    dev = series.device
    idx = torch.arange(n, device=dev)
    if n == 0:
        return values.clone()
    last_valid = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)), 0).values
    prev_idx = torch.cat([torch.full((1,), -1, device=dev, dtype=idx.dtype), last_valid[:-1]])
    safe = prev_idx.clamp(min=0)
    pv = values[safe]
    same = valid & (prev_idx >= 0) & (series[safe] == series)
    is_reset = same & (values < pv)
    # one run per series: a valid row whose previous valid row is another series
    run = torch.cumsum((valid & ~same).to(torch.int64), 0)
    resets = torch.nonzero(is_reset).flatten()
    rstarts, rlens = _runs(run[resets])
    # the running sum at each reset, in row order within its series
    acc = torch.zeros(int(resets.shape[0]), dtype=torch.float64, device=dev)
    longest = int(rlens.max()) if rlens.numel() else 0
    add = pv[resets]
    for r in range(longest):
        live = rlens > r
        pos = rstarts[live] + r
        prev = acc[pos - 1] if r else torch.zeros_like(acc[pos])
        acc[pos] = prev + add[pos]
    # each row takes the running sum of the last reset at or before it in
    # its series, 0.0 before the first
    nth = torch.cumsum(is_reset.to(torch.int64), 0) - 1
    has = nth >= 0
    safe_nth = nth.clamp(min=0)
    if resets.numel():
        mine = has & (run[resets[safe_nth]] == run)
        offset = torch.where(mine, acc[safe_nth], torch.zeros_like(values))
    else:
        offset = torch.zeros_like(values)
    return values + offset


def range_windows_plain(series, ts, values, valid, start, step, range_, n_steps: int, k: int,
                        num_series: int, n_steps_actual=None) -> WindowStats:
    """B15: per (series, window) count, first/last ts, first/last value
    (the largest value at that ts), sum, min and max of the valid samples
    in (t_w - range_, t_w], t_w = start + w * step.  A sample's first window
    is w0 = ceil(f64(ts - start) / f64(step)) clamped at 0, and it falls in
    windows w0 .. w0 + k - 1; pass j of the reference adds, in row order
    from 0.0, the samples whose first window is w - j, and the passes are
    added j = 0 first.  min/max propagate NaN."""
    dev = ts.device
    if n_steps_actual is None:
        n_steps_actual = n_steps
    G = num_series * n_steps
    count = torch.zeros(G, dtype=torch.int32, device=dev)
    first_ts = torch.full((G,), INT64_MAX, dtype=torch.int64, device=dev)
    last_ts = torch.full((G,), INT64_MIN, dtype=torch.int64, device=dev)
    sum_ = torch.zeros(G, dtype=torch.float64, device=dev)
    min_ = torch.full((G,), F64_MAX, dtype=torch.float64, device=dev)
    max_ = torch.full((G,), F64_MIN, dtype=torch.float64, device=dev)
    fv = torch.full((G,), F64_MIN, dtype=torch.float64, device=dev)
    lv = torch.full((G,), F64_MIN, dtype=torch.float64, device=dev)
    sel = torch.nonzero(valid).flatten()
    sid, t, v = series[sel].to(torch.int64), ts[sel], values[sel].to(torch.float64)
    diff = (t - start).to(torch.float64)
    w0 = torch.ceil(diff / _scalar(diff, step)).to(torch.int64).clamp(min=0)
    # slices: the runs of samples with one series and one first window
    # (rows are sorted by (series, ts) and w0 grows with ts); in pass j
    # slice (s, w0) feeds cell (s, w0 + j) with its rows in the window
    n = int(sid.shape[0])
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = (sid[1:] != sid[:-1]) | (w0[1:] != w0[:-1])
    starts = torch.nonzero(head).flatten()
    lengths = torch.diff(starts, append=torch.tensor([n], device=dev))
    whole = _run_stats(v, t, starts, lengths)
    s_first, s_last = whole[1], whole[2]
    ends = starts + lengths
    # per pass: the slices wholly inside their cell's window, and the ones
    # the window cuts (then only their rows in (t_w - range_, t_w] count:
    # one contiguous sub-run, found by bisection); the sub-runs of every
    # pass are reduced together
    passes, cut_starts, cut_lengths = [], [], []
    for j in range(k):
        w = w0[starts] + j
        t_w = start + w * step
        lo = t_w - range_
        live = (w < n_steps_actual) & (s_last > lo) & (s_first <= t_w)
        whole_in = live & (s_first > lo) & (s_last <= t_w)
        inside = torch.nonzero(whole_in).flatten()
        cut = torch.nonzero(live & ~whole_in).flatten()
        a = _bisect(t, starts[cut], ends[cut], lo[cut])
        b = _bisect(t, a, ends[cut], t_w[cut])
        passes.append((w, inside, cut))
        cut_starts.append(a)
        cut_lengths.append(b - a)
    part = _run_stats(v, t, torch.cat(cut_starts), torch.cat(cut_lengths))
    at = 0
    for w, inside, cut in passes:
        mine = [x[at:at + cut.shape[0]] for x in part]
        at += int(cut.shape[0])
        keep = torch.nonzero(mine[0] > 0).flatten()
        idx = torch.cat([inside, cut[keep]])
        cnt, first, last, total, mn, mx, at_first, at_last = (
            torch.cat([x[inside], y[keep]]) for x, y in zip(whole, mine))
        cells = sid[starts[idx]] * n_steps + w[idx]
        # a sample's first window grows with its ts, so pass j + 1 holds
        # only samples older than pass j's: the first value comes from the
        # last pass with samples, the last value from the first
        newest = count[cells] == 0
        count[cells] += cnt
        first_ts[cells] = torch.minimum(first_ts[cells], first)
        last_ts[cells] = torch.maximum(last_ts[cells], last)
        sum_[cells] = sum_[cells] + total
        min_[cells] = torch.minimum(min_[cells], mn)
        max_[cells] = torch.maximum(max_[cells], mx)
        small = torch.full_like(at_first, F64_MIN)
        fv[cells] = torch.maximum(small, at_first)
        lv[cells] = torch.where(newest, torch.maximum(small, at_last), lv[cells])
    return WindowStats(count, first_ts, last_ts, fv, lv, sum_, min_, max_)


def series_presence_plain(series, valid, num_series: int) -> torch.Tensor:
    """[S] bool: the series with at least one fetched row."""
    pres = torch.zeros(num_series, dtype=torch.bool, device=series.device)
    pres[series[valid].long()] = True
    return pres


def merge_disjoint_stats(a: WindowStats, b: WindowStats) -> WindowStats:
    """Union of stats from series-disjoint sources: a cell non-empty in `a`
    takes `a`'s values, every other cell `b`'s (pure selection)."""
    own_a = a.count > 0
    return WindowStats(*(torch.where(own_a, x, y) for x, y in zip(a.tensors(), b.tensors())))


def extrapolated_rate_plain(stats: WindowStats, start, step, range_, n_steps: int, kind: str):
    """Prometheus `extrapolatedRate` (reference `extrapolated_rate_dyn`),
    one f64 rounding per operation; returns (value, defined)."""
    n = int(stats.count.shape[0])
    dev = stats.count.device
    w = torch.arange(n, dtype=torch.int64, device=dev) % n_steps
    t_end = start + w * step
    t_start = t_end - range_
    defined = stats.count >= 2
    sampled_interval = (stats.last_ts - stats.first_ts).to(torch.float64)
    safe_count = torch.clamp(stats.count, min=2)
    avg_between = sampled_interval / (safe_count - 1).to(torch.float64)
    dur_to_start = (stats.first_ts - t_start).to(torch.float64)
    dur_to_end = (t_end - stats.last_ts).to(torch.float64)
    threshold = avg_between * 1.1
    half = avg_between / 2.0
    extend_start = torch.where(dur_to_start < threshold, dur_to_start, half)
    extend_end = torch.where(dur_to_end < threshold, dur_to_end, half)
    result = stats.last_val - stats.first_val
    if kind in ("rate", "increase"):
        ones = torch.ones_like(result)
        zero_dur = torch.where(
            result > 0,
            sampled_interval * (stats.first_val / torch.where(result == 0, ones, result)),
            torch.full_like(result, float("inf")),
        )
        extend_start = torch.minimum(
            extend_start, torch.where(zero_dur < 0, extend_start, zero_dur))
    extrapolate_to = sampled_interval + extend_start + extend_end
    safe_si = torch.where(sampled_interval == 0, torch.ones_like(sampled_interval),
                          sampled_interval)
    value = result * (extrapolate_to / safe_si)
    if kind == "rate":
        value = value / _scalar(value, range_ / 1000.0)
    return value, defined


def over_time_plain(stats: WindowStats, func: str):
    """avg/sum/min/max/count/last_over_time from window stats."""
    defined = stats.count >= 1
    if func == "avg_over_time":
        return stats.sum / torch.clamp(stats.count, min=1).to(torch.float64), defined
    if func == "sum_over_time":
        return stats.sum, defined
    if func == "min_over_time":
        return stats.min, defined
    if func == "max_over_time":
        return stats.max, defined
    if func == "count_over_time":
        return stats.count.to(torch.float64), defined
    if func == "last_over_time":
        return stats.last_val, defined
    raise ValueError(f"unknown over_time func: {func}")


def range_finalize_plain(stats_list: list, grid: RangeGrid, func: str) -> torch.Tensor:
    """B16: merge the regions' stats by selection in region order, then the
    function; [S * W] f64 with NaN where it is undefined."""
    stats = stats_list[0]
    for st in stats_list[1:]:
        stats = merge_disjoint_stats(stats, st)
    if func in RATE_FUNCS:
        vals, defined = extrapolated_rate_plain(
            stats, grid.start, grid.step, grid.range_, grid.n_steps, func)
    elif func == "__last_ts":
        last = stats.last_ts.to(torch.float64)
        vals, defined = last / _scalar(last, 1000.0), stats.count >= 1
    else:
        vals, defined = over_time_plain(stats, func)
    return torch.where(defined, vals.to(torch.float64), torch.full_like(vals, float("nan"),
                                                                         dtype=torch.float64))


def series_fold_plain(mat: torch.Tensor, offsets: torch.Tensor, members: torch.Tensor,
                      op: str) -> torch.Tensor:
    """B17's fold: [S, W] -> [G, W] for sum / avg / count / min / max over
    the present (non-NaN) cells of each group's member series, taken in
    the CSR order (ascending series id); NaN for a group with none."""
    G = int(offsets.shape[0]) - 1
    W = int(mat.shape[1])
    dev = mat.device
    sizes = offsets[1:] - offsets[:-1]
    present = ~torch.isnan(mat)
    sums = torch.zeros((G, W), dtype=torch.float64, device=dev)
    counts = torch.zeros((G, W), dtype=torch.float64, device=dev)
    fill = float("inf") if op == "min" else float("-inf")
    ext = torch.full((G, W), fill, dtype=torch.float64, device=dev)
    longest = int(sizes.max()) if G else 0
    for r in range(longest):
        live = torch.nonzero(sizes > r).flatten()
        rows = members[offsets[live] + r]
        p = present[rows]
        x = mat[rows]
        sums[live] = sums[live] + torch.where(p, x, torch.zeros_like(x))
        counts[live] = counts[live] + p.to(torch.float64)
        if op in ("min", "max"):
            filled = torch.where(p, x, torch.full_like(x, fill))
            ext[live] = (torch.minimum if op == "min" else torch.maximum)(ext[live], filled)
    nan = torch.full_like(sums, float("nan"))
    if op == "sum":
        return torch.where(counts > 0, sums, nan)
    if op in ("avg", "mean"):
        return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), nan)
    if op == "count":
        return torch.where(counts > 0, counts, nan)
    return torch.where(counts > 0, ext, nan)


def gid_map(radices, keep_idx) -> np.ndarray:
    """sid -> group id over the kept tag subset (mixed radix, keep order):
    the reference's `tile_exec._gid_map`, int64."""
    s_pad = 1
    for r in radices:
        s_pad *= r
    sids = np.arange(s_pad, dtype=np.int64)
    codes = []
    stride = 1
    for r in reversed(radices):
        codes.append((sids // stride) % r)
        stride *= r
    codes.reverse()
    gid = np.zeros(s_pad, dtype=np.int64)
    g_stride = 1
    for i in reversed(keep_idx):
        gid = gid + codes[i] * g_stride
        g_stride *= radices[i]
    return gid


def group_csr(radices, keep_idx) -> tuple[np.ndarray, np.ndarray]:
    """The fold's CSR: (offsets int64 [G + 1], members int64 [S]), each
    group's series in ascending id; G = the product of the kept radices."""
    gid = gid_map(radices, keep_idx)
    g_pad = 1
    for i in keep_idx:
        g_pad *= radices[i]
    members = np.argsort(gid, kind="stable").astype(np.int64)
    offsets = np.zeros(g_pad + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(gid, minlength=g_pad))
    return offsets, members


# ---- kernel plumbing --------------------------------------------------------------


class _RowPlanes(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64), ("chunk_rows", ctypes.c_int64), ("chunk_shift", ctypes.c_int64),
        ("ts", ctypes.c_void_p), ("vals", ctypes.c_void_p),
        ("nulls", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("sid", ctypes.c_void_p), ("codes", ctypes.c_void_p),
        ("radices", ctypes.c_void_p), ("masks", ctypes.c_void_p),
        ("mask_len", ctypes.c_void_p),
        ("lo", ctypes.c_int64), ("hi", ctypes.c_int64),
        ("unit_ns", ctypes.c_int64), ("offset", ctypes.c_int64),
        ("n_tags", ctypes.c_int32), ("has_range", ctypes.c_int32),
    ]


class _SeriesLayout(ctypes.Structure):
    _fields_ = [
        ("in_fetch", ctypes.c_void_p), ("first", ctypes.c_void_p),
        ("last", ctypes.c_void_p), ("presence", ctypes.c_void_p),
        ("num_series", ctypes.c_int64),
    ]


class _LayoutArgs(ctypes.Structure):
    _fields_ = [("rows", _RowPlanes), ("out", _SeriesLayout)]


class _StripArgs(ctypes.Structure):
    _fields_ = [("rows", _RowPlanes), ("layout", _SeriesLayout), ("out", ctypes.c_void_p),
                ("kernels", ctypes.c_int32)]  # out: the kernels the call launched


class _WindowArgs(ctypes.Structure):
    _fields_ = [
        ("rows", _RowPlanes), ("layout", _SeriesLayout), ("adj", ctypes.c_void_p),
        ("count", ctypes.c_void_p), ("first_ts", ctypes.c_void_p),
        ("last_ts", ctypes.c_void_p), ("first_val", ctypes.c_void_p),
        ("last_val", ctypes.c_void_p), ("sum", ctypes.c_void_p),
        ("min", ctypes.c_void_p), ("max", ctypes.c_void_p), ("slices", ctypes.c_void_p),
        ("n_steps", ctypes.c_int64), ("n_steps_actual", ctypes.c_int64),
        ("k", ctypes.c_int64), ("start", ctypes.c_int64),
        ("step", ctypes.c_int64), ("range", ctypes.c_int64),
    ]


class _FinalizeArgs(ctypes.Structure):
    _fields_ = [
        ("regions", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n_cells", ctypes.c_int64), ("n_steps", ctypes.c_int64),
        ("start", ctypes.c_int64), ("step", ctypes.c_int64), ("range", ctypes.c_int64),
        ("n_regions", ctypes.c_int32), ("func", ctypes.c_int32),
    ]


class _FoldArgs(ctypes.Structure):
    _fields_ = [
        ("mat", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
        ("members", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n_groups", ctypes.c_int64), ("n_steps", ctypes.c_int64),
        ("op", ctypes.c_int32), ("tw", ctypes.c_int32),
    ]


@dataclass
class SeriesLayout:
    """What the row prologue of K9/K10 leaves on the card: in_fetch [n]
    uint8, and per series the first and last fetched row (INT64_MAX / -1
    when none) and presence [S] uint8.  Rows between a series' first and
    last fetched row all belong to it, in ts order."""

    in_fetch: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    presence: torch.Tensor

    def struct(self) -> _SeriesLayout:
        return _SeriesLayout(self.in_fetch.data_ptr(), self.first.data_ptr(),
                             self.last.data_ptr(), self.presence.data_ptr(),
                             int(self.first.shape[0]))


def _check_chunks(chunks, dtype, lens, dev) -> None:
    for t, n in zip(chunks, lens):
        _check_rows(t, dtype, n, dev)


def _row_planes(src: RowSource):
    """(struct, tensors to keep alive) describing a CUDA source to the kernels:
    one device table of chunk pointers (no host sync), as K2 and K6 do."""
    from ..kernels._build import upload_table

    dev = src.device
    lens = [int(t.shape[0]) for t in src.ts]
    chunk_rows = lens[0]
    if len(src.values) != len(lens) or any(x != chunk_rows for x in lens[:-1]) \
            or lens[-1] > chunk_rows:
        raise ValueError("row chunks must share one length (the last may be shorter)")
    vals = [v if v.dtype == torch.float64 else v.to(torch.float64) for v in src.values]
    _check_chunks(src.ts, torch.int64, lens, dev)
    _check_chunks(vals, torch.float64, lens, dev)
    entries: list[int] = []
    where: dict[str, int] = {}

    def put(key, items):
        where[key] = len(entries)
        entries.extend(int(x) for x in items)

    put("ts", [t.data_ptr() for t in src.ts])
    put("vals", [v.data_ptr() for v in vals])
    if src.nulls is not None:
        _check_chunks(src.nulls, torch.bool, lens, dev)
        put("nulls", [t.data_ptr() for t in src.nulls])
    if src.valid is not None:
        _check_chunks(src.valid, torch.bool, lens, dev)
        put("valid", [t.data_ptr() for t in src.valid])
    keep = [vals]
    if src.sid is not None:
        _check_chunks(src.sid, torch.int32, lens, dev)
        put("sid", [t.data_ptr() for t in src.sid])
    elif src.codes:
        if len(src.radices) != len(src.codes):
            raise ValueError("one radix per tag code plane")
        for c in src.codes:
            _check_chunks(c, torch.int32, lens, dev)
        put("codes", [t.data_ptr() for c in src.codes for t in c])
        put("radices", src.radices)
        mptrs, mlens = [0] * len(src.codes), [0] * len(src.codes)
        for ti, mask in src.masks:
            if mask.device != dev or mask.dtype != torch.bool or not mask.is_contiguous():
                raise ValueError("matcher masks must be contiguous bool tensors on the card")
            mptrs[ti], mlens[ti] = mask.data_ptr(), int(mask.shape[0])
            keep.append(mask)
        put("masks", mptrs)
        put("mask_len", mlens)
    elif src.num_series != 1:
        raise ValueError("a source without series ids or tag codes holds one series")
    table = upload_table(entries, dev)
    keep.append(table)
    base = table.data_ptr()

    def ptr(key):
        return base + 8 * where[key] if key in where else None

    # a single chunk addresses as chunk 0 of 2^62 rows
    shift = 62 if len(lens) == 1 else (
        chunk_rows.bit_length() - 1 if chunk_rows & (chunk_rows - 1) == 0 else -1)
    planes = _RowPlanes(
        sum(lens), chunk_rows, shift, ptr("ts"), ptr("vals"), ptr("nulls"), ptr("valid"),
        ptr("sid"), ptr("codes"), ptr("radices"), ptr("masks"), ptr("mask_len"),
        0 if src.lo is None else int(src.lo), 0 if src.hi is None else int(src.hi),
        int(src.unit_ns), int(src.offset), len(src.codes) if src.sid is None else 0,
        0 if src.lo is None else 1,
    )
    return planes, keep


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _empty_layout(n: int, S: int, dev) -> SeriesLayout:
    """A layout's tensors as views of one buffer (first, last, presence,
    in_fetch), unwritten: the entry point that runs the row prologue
    writes the identities first (csrc/rate_rows.cuh
    `launch_series_layout`)."""
    buf = torch.empty(17 * S + n, dtype=torch.uint8, device=dev)
    return SeriesLayout(in_fetch=buf[17 * S:], first=buf[:8 * S].view(torch.int64),
                        last=buf[8 * S:16 * S].view(torch.int64), presence=buf[16 * S:17 * S])


# ---- the wrappers (K9-K12) ---------------------------------------------------------


def strip_counter_resets(src: RowSource):
    """K9: counter resets stripped per series (B14).  Returns (adjusted
    values f64 [n], layout): rows that are not fetched carry no meaningful
    value; `layout` (None on the CPU) feeds K10 so the prologue runs once.
    A CUDA source launches csrc/strip_counter_resets.cu in one host call
    (the layout's identities, the prologue, then one warp per series
    walking its rows 32 at a time with a ballot of its resets); a CPU
    source runs `strip_counter_resets_plain`."""
    if src.device.type == "cpu":
        sid, _ts, vf, in_fetch = source_rows(src)
        return strip_counter_resets_plain(sid, vf, in_fetch), None
    from ..kernels._build import launch

    strip_counter_resets.calls += 1
    dev = src.device
    planes, keep = _row_planes(src)
    out = torch.empty(planes.n, dtype=torch.float64, device=dev)
    layout = _empty_layout(planes.n, int(src.num_series), dev)
    strip_counter_resets.launches += 1
    launch("strip_counter_resets", "gt_strip_counter_resets",
           _StripArgs(planes, layout.struct(), out.data_ptr()), _stream(dev))
    del keep
    return out, layout


strip_counter_resets.launches = 0
strip_counter_resets.calls = 0  # calls with a CUDA source


def range_windows(src: RowSource, grid: RangeGrid, values: torch.Tensor | None = None,
                  layout: SeriesLayout | None = None):
    """K10: the window statistics of every (series, step) cell (B15) and
    each series' presence.  `values` (K9's output) replaces the source's
    value planes.  Returns (WindowStats, presence bool [S]).  A CUDA source
    launches csrc/range_windows.cu: the row prologue unless K9 left its
    layout, then the slice table (one thread per (series, step) slice) and
    the cells (one block per series and 256 steps, the slices in shared
    memory); a CPU source runs the plain versions."""
    if grid.num_series != src.num_series:
        raise ValueError("the grid's series count must be the source's")
    if src.device.type == "cpu":
        sid, ts_ms, vf, in_fetch = source_rows(src)
        if values is not None:
            vf = values
        stats = range_windows_plain(
            sid, ts_ms, vf, in_fetch, grid.start, grid.step, grid.range_, grid.n_steps,
            grid.k, grid.num_series, grid.n_steps_actual)
        return stats, series_presence_plain(sid, in_fetch, grid.num_series)
    from ..kernels._build import launch

    dev = src.device
    planes, keep = _row_planes(src)
    if values is not None:
        if values.device != dev or values.dtype != torch.float64 \
                or values.shape != (planes.n,) or not values.is_contiguous():
            raise ValueError("values must be K9's contiguous f64 output for this source")
    cells = grid.num_series * grid.n_steps
    stats = WindowStats(
        torch.empty(cells, dtype=torch.int32, device=dev),
        torch.empty(cells, dtype=torch.int64, device=dev),
        torch.empty(cells, dtype=torch.int64, device=dev),
        *(torch.empty(cells, dtype=torch.float64, device=dev) for _ in range(5)),
    )
    # the slice table (csrc/range_windows.cu): 68 B a (series, real step)
    slices = torch.empty(SLICE_BYTES * grid.num_series * max(grid.n_steps_actual, 0),
                         dtype=torch.uint8, device=dev)
    range_windows.launches += 1
    if layout is None:
        # the row prologue: in_fetch, each series' first / last fetched row
        # and presence (integer atomics only)
        layout = _empty_layout(planes.n, grid.num_series, dev)
        launch("range_windows", "gt_range_layout", _LayoutArgs(planes, layout.struct()),
               _stream(dev))
    a = _WindowArgs(
        planes, layout.struct(), None if values is None else values.data_ptr(),
        *(t.data_ptr() for t in stats.tensors()), slices.data_ptr(),
        grid.n_steps, grid.n_steps_actual, grid.k, grid.start, grid.step, grid.range_,
    )
    launch("range_windows", "gt_range_windows", a, _stream(dev))
    del keep
    return stats, layout.presence.bool()


range_windows.launches = 0


def range_finalize(stats_list: list, grid: RangeGrid, func: str) -> torch.Tensor:
    """K11: merge R regions' stats by selection (the first region with a
    sample owns the cell), then rate / increase / delta, *_over_time or
    the last sample time, NaN where undefined (B16).  Returns [S * W] f64.
    A CUDA input launches csrc/range_finalize.cu (one thread per cell,
    every f64 operation rounded on its own, as XLA does); a CPU input runs
    `range_finalize_plain`."""
    if func not in FUNC_CODES:
        raise ValueError(f"unknown range function: {func}")
    if not stats_list:
        raise ValueError("range_finalize needs at least one region's stats")
    if stats_list[0].count.device.type == "cpu":
        return range_finalize_plain(stats_list, grid, func)
    from ..kernels._build import launch, upload_table

    dev = stats_list[0].count.device
    cells = int(stats_list[0].count.shape[0])
    if cells != grid.num_series * grid.n_steps:
        raise ValueError("stats must have the grid's [S * W] cells")
    dtypes = (torch.int32, torch.int64, torch.int64) + (torch.float64,) * 5
    for st in stats_list:
        for t, dt in zip(st.tensors(), dtypes):
            if t.device != dev or t.dtype != dt or t.shape != (cells,) or not t.is_contiguous():
                raise ValueError("each region's stats must be K10 outputs of one grid")
    table = upload_table([t.data_ptr() for st in stats_list for t in st.tensors()], dev)
    out = torch.empty(cells, dtype=torch.float64, device=dev)
    a = _FinalizeArgs(table.data_ptr(), out.data_ptr(), cells, grid.n_steps, grid.start,
                      grid.step, grid.range_, len(stats_list), FUNC_CODES[func])
    range_finalize.launches += 1
    launch("range_finalize", "gt_range_finalize", a, _stream(dev))
    return out


range_finalize.launches = 0


# K12's forms (csrc/series_fold.cu): the staged form's steps a CTA, widest
# first; the CTAs it wants at least (the H100 has 132 SMs); the cells from
# which the cell form keeps enough loads in flight (at 64 groups of 64
# members, 65,536 cells, it took 7.4 µs on an H100 against the staged
# form's 21.6); the members a group below which the cell form runs anyway.
SERIES_FOLD_TILES = (32, 16, 8)
_FOLD_FILL_CTAS = 128
_FOLD_CELLS_FILL = 1 << 15
_FOLD_STAGED_MIN = 8


@functools.lru_cache(maxsize=64)
def series_fold_plan(S: int, G: int, W: int) -> dict:
    """K12's launch for an [S, W] -> [G, W] fold, from the shape alone (the
    mixed-radix gid map gives every group S / G members): {"form": "cells"
    or "staged", "tw": the staged form's steps a CTA (0 for cells),
    "grid": CTAs}.  The cell form (a thread a cell) where the cells fill
    the card or the groups are a few members long; else the staged form
    with the widest tile whose G x ceil(W / tw) CTAs fill the card (8 at
    G = 1, W = 1024: 128 CTAs)."""
    if G <= 0 or W <= 0:
        return {"form": "cells", "tw": 0, "grid": 0}
    if G * W >= _FOLD_CELLS_FILL or -(-S // G) < _FOLD_STAGED_MIN:
        return {"form": "cells", "tw": 0, "grid": -(-(G * W) // 256)}
    tw = _staged_tile(G, W)
    return {"form": "staged", "tw": tw, "grid": G * -(-W // tw)}


def _staged_tile(G: int, W: int) -> int:
    """The staged form's widest tile whose CTAs fill the card."""
    return next((t for t in SERIES_FOLD_TILES if G * -(-W // t) >= _FOLD_FILL_CTAS),
                SERIES_FOLD_TILES[-1])


def series_fold(mat: torch.Tensor, offsets: torch.Tensor, members: torch.Tensor,
                op: str) -> torch.Tensor:
    """K12: the by-label fold [S, W] -> [G, W] (B17): `offsets` int64 [G + 1]
    and `members` int64 [S] are the CSR of each group's series in
    ascending id.  A CUDA matrix launches csrc/series_fold.cu in the form
    `series_fold_plan` picks; every cell adds its members in CSR order.  A
    CPU matrix runs `series_fold_plain`."""
    if op not in FOLD_OPS:
        raise ValueError(f"unknown fold: {op}")
    if mat.device.type == "cpu":
        return series_fold_plain(mat, offsets, members, op)
    S, W = mat.shape
    return _series_fold_launch(mat, offsets, members, op,
                               series_fold_plan(S, offsets.shape[0] - 1, W)["tw"])


def _series_fold_launch(mat: torch.Tensor, offsets: torch.Tensor, members: torch.Tensor,
                        op: str, tw: int) -> torch.Tensor:
    """K12's launch in the form `tw` names (0: the cell form; 8, 16 or 32:
    the staged form's steps a CTA), whatever the plan would pick: the
    bytes are the same.  `series_fold` calls it with the planned tw."""
    from ..kernels._build import launch

    if tw not in (0,) + SERIES_FOLD_TILES:
        raise ValueError(f"series_fold tile {tw}: use 0 or one of {SERIES_FOLD_TILES}")
    dev = mat.device
    if mat.dtype != torch.float64 or mat.dim() != 2 or not mat.is_contiguous():
        raise ValueError("series_fold takes a contiguous f64 [S, W] matrix")
    for t in (offsets, members):
        if t.device != dev or t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("the CSR must be contiguous int64 tensors on the card")
    G, W = offsets.shape[0] - 1, mat.shape[1]
    out = torch.empty((G, W), dtype=torch.float64, device=dev)
    a = _FoldArgs(mat.data_ptr(), offsets.data_ptr(), members.data_ptr(), out.data_ptr(),
                  G, W, FOLD_OPS[op], tw)
    series_fold.launches += 1
    launch("series_fold", "gt_series_fold", a, _stream(dev))
    return out


series_fold.launches = 0
