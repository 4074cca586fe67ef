"""The plain versions of K9-K12 (greptimedb_tpu_torch/ops/rate.py) against
the reference's JAX functions (greptimedb_tpu/ops/rate.py and
query/promql/tile_exec.py `_region_stats` / `_finalize`) on seeded inputs:
counter resets, invalid rows between samples, NaN values, equal
timestamps in a window, padded steps (`n_steps_actual < n_steps`),
padded k, ns-scale timestamps, every rate kind, the six *_over_time and
`__last_ts`; and K10's two stages (the slice table, then each cell's
slices newest first) emulated in torch ops, on those windows and on the
slices' edges.  The inputs are made with numpy and handed to both sides.

Tolerances, and why:
* K9: exact on series without a reset (both add exactly 0.0); relative
  1e-12 on series with one — the reference subtracts a per-series
  baseline from a global prefix sum, the port keeps a running sum per
  series (the bound the reference holds its own two paths to,
  tests/test_tql_tile.py:157-164);
* K10: count, timestamps, first/last value, min and max exact; sum
  exact too (the port adds a window's samples in the reference's order);
* K11, K12 and the prologue: exact (the same f64 operations in the same
  order).
On the CPU each wrapper takes its plain version: the CUDA kernels are
held against these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import rate as jrate
from greptimedb_tpu.query.promql import tile_exec as jtile
from greptimedb_tpu_torch.ops import rate as R

T0 = 1_700_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counter(seed, n_series=6, n_samples=80, scrape=15_000, resets=True, nan=False,
             invalid=False, dup_ts=False, base=T0, jitter=True, inf=False):
    """Sorted (sid, ts, values, valid) of seeded counters."""
    rng = np.random.default_rng(seed)
    sid = np.repeat(np.arange(n_series, dtype=np.int32), n_samples)
    ts = np.tile(base + np.arange(n_samples, dtype=np.int64) * scrape, n_series)
    if jitter:
        ts = ts + rng.integers(0, scrape // 3, ts.shape[0])
    if dup_ts:
        # some samples share the previous sample's timestamp
        dup = rng.random(ts.shape[0]) < 0.1
        dup[::n_samples] = False
        ts = np.where(dup, np.roll(ts, 1), ts)
    order = np.lexsort((ts, sid))
    sid, ts = sid[order], ts[order]
    vals = np.zeros(ts.shape[0])
    for s in range(n_series):
        v = np.cumsum(rng.uniform(0, 5, n_samples))
        if resets and s % 2 == 0:
            # a reset to a small value in half of the series
            at = rng.integers(5, n_samples - 5, 2)
            for a in at:
                v[a:] = v[a:] - v[a] + rng.uniform(0, 1)
        vals[s * n_samples:(s + 1) * n_samples] = v
    if nan:
        vals[rng.random(vals.shape[0]) < 0.05] = np.nan
    if inf:
        u = rng.random(vals.shape[0])
        vals[u < 0.03] = np.inf
        vals[(u >= 0.03) & (u < 0.06)] = -np.inf
    valid = rng.random(vals.shape[0]) < 0.85 if invalid else np.ones(vals.shape[0], bool)
    return sid, ts, vals, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


def _same(a, b):
    """Exact equality with NaN == NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))
    return bool(np.array_equal(a, b))


# ---- K9: strip_counter_resets ------------------------------------------------------


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_strip_counter_resets_matches_reference(seed, nan, invalid):
    sid, _ts, vals, valid = _counter(seed, nan=nan, invalid=invalid)
    got = R.strip_counter_resets_plain(_t(sid), _t(vals), _t(valid)).numpy()
    want = _np(jrate.strip_counter_resets_segmented(
        jnp.asarray(sid), jnp.asarray(vals), jnp.asarray(valid)))
    if not invalid:
        dense = _np(jrate.strip_counter_resets(
            jnp.asarray(sid), jnp.asarray(vals), jnp.asarray(valid)))
        assert _same(want, dense)
    reset_series = set()
    for s in np.unique(sid):
        rows = np.nonzero((sid == s) & valid)[0]
        v = vals[rows]
        if np.any(v[1:] < v[:-1]):
            reset_series.add(int(s))
    assert reset_series, "the inputs must hold resets"
    for s in np.unique(sid):
        m = (sid == s) & valid
        if int(s) in reset_series:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-12)
        else:
            assert _same(got[m], want[m]), f"series {s} without resets must be exact"


def test_strip_counter_resets_sequential_sum():
    """The port's running sum per series, in row order (what K9 computes)."""
    sid, _ts, vals, valid = _counter(3, invalid=True)
    got = R.strip_counter_resets_plain(_t(sid), _t(vals), _t(valid)).numpy()
    want = vals.copy()
    for s in np.unique(sid):
        acc, prev = 0.0, None
        for i in np.nonzero((sid == s) & valid)[0]:
            if prev is not None and vals[i] < prev:
                acc = acc + prev
            prev = vals[i]
            want[i] = vals[i] + acc
    assert _same(got[valid], want[valid])


def _ballot_walk(sid, vals, valid, width=32, depth=1):
    """K9's walk (csrc/strip_counter_resets.cu) in torch ops: per series,
    its rows from its first to its last fetched row in groups of `width`
    lanes, `depth` groups loaded at a time.  Per group: each fetched
    lane's previous value (the highest fetched lane below it, else the
    value carried from the groups before), the ballot of its resets, the
    resets walked in lane order (each adds its previous value to the
    running correction, and the lanes at or above it take the new one),
    then x + the lane's correction.  Rows that are not fetched keep their
    value."""
    sid, x_all, f_all = _t(sid), _t(vals), _t(valid)
    out = x_all.clone()
    for s in torch.unique(sid[f_all]).tolist():
        rows = torch.nonzero((sid == s) & f_all).flatten()
        lo, hi = int(rows[0]), int(rows[-1])
        acc = torch.zeros((), dtype=torch.float64)
        pv, have = torch.zeros((), dtype=torch.float64), False
        for base in range(lo, hi + 1, width * depth):
            window = torch.arange(base, min(base + width * depth, hi + 1))
            xs, fs = x_all[window], f_all[window]  # every load of the window first
            for g0 in range(0, window.numel(), width):
                x, f = xs[g0:g0 + width], fs[g0:g0 + width]
                if not bool(f.any()):
                    continue
                lanes = torch.arange(x.numel())
                below = torch.cummax(torch.where(f, lanes, -1), 0).values
                below = torch.cat([torch.tensor([-1]), below[:-1]])
                prev = torch.where(below >= 0, x[below.clamp(min=0)], pv)
                has = (below >= 0) | have
                mine = acc.expand(x.numel()).clone()
                for b in torch.nonzero(f & has & (x < prev)).flatten().tolist():
                    acc = acc + prev[b]
                    mine[b:] = acc
                r = window[g0:g0 + width][f]
                out[r] = (x + mine)[f]
                pv, have = x[int(torch.nonzero(f).flatten()[-1])], True
    return out.numpy()


def _strip_series(name):
    """(sid, vals, valid) of series where K9's ballot branches; rows count
    from each series' first fetched row, so a row's lane is its index % 32
    and its place in a window of loads its index % 256."""
    rng = np.random.default_rng(len(name))

    def ramp(m):
        return np.cumsum(rng.uniform(0.5, 3.0, m))

    def reset(v, at, to):
        v[at:] -= v[at] - to

    series = []
    if name == "no_reset":
        series = [(ramp(600), None), (ramp(33), None), (np.array([42.0]), None)]
    elif name == "one_reset":
        v = ramp(500)
        reset(v, 300, 0.25)
        w = ramp(40)
        reset(w, 1, 0.0)  # at lane 1, to 0.0
        series = [(v, None), (w, None)]
    elif name == "many_resets":
        v = ramp(900)
        for at in np.sort(rng.choice(np.arange(1, 900), 90, replace=False)):
            reset(v, at, rng.uniform(0, 1))
        series = [(v, rng.random(900) < 0.95), (ramp(70), None)]
    elif name == "every_row":
        series = [(1000.0 - np.arange(300.0), None), (5.0 - np.arange(40) * 0.1, None)]
    elif name == "lanes_0_31":
        v = ramp(700)
        for at in [a for g in range(1, 21) for a in (32 * g, 32 * g + 31)] + [256, 511, 512]:
            reset(v, at, 0.5 * v[at - 1])
        series = [(v, None)]
    elif name == "after_unfetched":
        v = ramp(600)
        valid = np.ones(600, bool)
        valid[20:41] = False  # across lanes 31 / 0
        reset(v, 41, 0.5)
        valid[250:263] = False  # across a window's edge
        reset(v, 263, 0.5)
        valid[500:] = False  # a long unfetched tail
        series = [(v, valid), (ramp(30), np.arange(30) % 3 == 0)]
    elif name == "nan_inf":
        v = ramp(200)
        v[50], v[51] = np.nan, 1.0  # below a NaN: no reset
        v[80], v[81], v[82] = 0.5, np.nan, 0.25  # a reset, NaN after it
        w = ramp(150)
        w[40] = w[41] = -np.inf  # a reset to -inf, -inf after -inf
        w[42] = 1.0
        z = ramp(90)
        z[60], z[61], z[62] = np.inf, 2.0, np.inf  # below +inf: adds inf
        # +inf last: the reference's global prefix sum carries it into later series
        series = [(v, None), (w, None), (z, None)]
    elif name == "signed_zero":
        v = ramp(300)
        v[::7] = 0.0
        v[::14] = -0.0
        series = [(v, None)]
    else:
        raise KeyError(name)
    sid = np.concatenate([np.full(len(v), i, np.int32) for i, (v, _) in enumerate(series)])
    vals = np.concatenate([v for v, _ in series])
    valid = np.concatenate([np.ones(len(v), bool) if m is None else m for v, m in series])
    return sid, vals, valid


STRIP_SERIES = ("no_reset", "one_reset", "many_resets", "every_row", "lanes_0_31",
                "after_unfetched", "nan_inf", "signed_zero")


@pytest.mark.parametrize("width,depth", [(32, 1), (32, 8), (256, 1)])
@pytest.mark.parametrize("name", STRIP_SERIES)
def test_strip_ballot_walk_matches_plain_and_reference(name, width, depth):
    """K9's reset ballot (groups of 32, loaded 8 at a time as the kernel
    does; and one group of 256) gives the plain version's bytes on every
    fetched row, which hold against the reference as
    test_strip_counter_resets_matches_reference holds them."""
    sid, vals, valid = _strip_series(name)
    got = _ballot_walk(sid, vals, valid, width, depth)
    plain = R.strip_counter_resets_plain(_t(sid), _t(vals), _t(valid)).numpy()
    assert got[valid].tobytes() == plain[valid].tobytes()
    want = _np(jrate.strip_counter_resets_segmented(
        jnp.asarray(sid), jnp.asarray(vals), jnp.asarray(valid)))
    n_resets = 0
    for s in np.unique(sid):
        m = (sid == s) & valid
        v = vals[m]
        resets = int(np.sum(v[1:] < v[:-1]))
        n_resets += resets
        if resets:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-12)
        else:
            assert _same(got[m], want[m]), f"series {s} without resets must be exact"
    assert (n_resets == 0) == (name == "no_reset")


# ---- K10: range_windows ---------------------------------------------------------------

WINDOW_CASES = {
    # name: (data kwargs, start offset, step, range, steps, pad steps, k pad)
    "5m_60s": (dict(), 300_000, 60_000, 300_000, 15, 16, None),
    "2m_25s_padded": (dict(nan=True, invalid=True), 60_000, 25_000, 120_000, 40, 64, 8),
    "90s_25s_dup_ts": (dict(dup_ts=True), 60_000, 25_000, 90_000, 40, 40, None),
    "1h_60s_k64": (dict(n_samples=400), 3_600_000, 60_000, 3_600_000, 30, 32, 64),
    "range_lt_step": (dict(nan=True), 30_000, 60_000, 20_000, 18, 32, None),
    "ns_scale": (dict(base=1_700_000_000_000_000_000 // 1_000_000, jitter=False),
                 120_000, 30_000, 120_000, 17, 17, None),
}


# the edges of K10's slices (csrc/range_windows.cu)
EDGE_WINDOW_CASES = {
    "100s_30s_cut": (dict(nan=True), 60_000, 30_000, 100_000, 30, 32, None),
    "clamp_slice": (dict(invalid=True), 600_000, 60_000, 900_000, 12, 16, None),
    "long_slices": (dict(n_samples=300, scrape=10_000), 300_000, 300_000, 900_000, 9, 16, None),
    "empty_slices": (dict(scrape=15_000), 30_000, 4_000, 20_000, 200, 256, 8),
    "k_past_range": (dict(), 120_000, 60_000, 60_000, 16, 16, 16),
    "inf_nan_dup": (dict(nan=True, inf=True, dup_ts=True), 90_000, 20_000, 70_000, 50, 64, 8),
}
ALL_WINDOW_CASES = {**WINDOW_CASES, **EDGE_WINDOW_CASES}


@pytest.mark.parametrize("case", sorted(ALL_WINDOW_CASES))
def test_range_windows_matches_reference(case):
    kw, off, step, rng_ms, steps, w_pad, k_pad = ALL_WINDOW_CASES[case]
    sid, ts, vals, valid = _counter(7, **kw)
    start = int(ts.min()) + off
    k = k_pad or -(-rng_ms // step)
    n_series = int(sid.max()) + 1
    want = jrate.range_windows_dyn(
        jnp.asarray(sid), jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        start=np.int64(start), step=np.int64(step), range_=np.int64(rng_ms),
        n_steps=w_pad, k=k, num_series=n_series, n_steps_actual=np.int64(steps))
    got = R.range_windows_plain(_t(sid), _t(ts), _t(vals), _t(valid), start, step, rng_ms,
                                w_pad, k, n_series, steps)
    assert int(got.count.sum()) > 0
    for f in R.WindowStats.FIELDS:
        assert _same(getattr(got, f).numpy(), getattr(want, f)), f"{case}: {f} differs"


def _bits_equal(a, b):
    """Byte for byte, NaN equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        return bool(np.array_equal(nan, np.isnan(b))
                    and np.array_equal(a[~nan].view(np.int64), b[~nan].view(np.int64)))
    return bool(np.array_equal(a, b))


def _k10_slices(sid, ts, vals, fetched, start, step):
    """K10's first stage in torch ops: a slice is a run of one series' rows
    (fetched or not) that share one first window w0 = ceil(f64(ts - start)
    / f64(step)) clamped at 0; its statistics are those of its fetched rows,
    walked in row order (the kernel's per-row updates)."""
    diff = (ts - start).to(torch.float64)
    w0 = torch.ceil(diff / torch.full_like(diff, float(step))).to(torch.int64).clamp(min=0)
    n = int(ts.shape[0])
    head = torch.ones(n, dtype=torch.bool)
    head[1:] = (sid[1:] != sid[:-1]) | (w0[1:] != w0[:-1])
    beg = torch.nonzero(head).flatten()
    end = torch.cat([beg[1:], torch.tensor([n])])
    return sid[beg].to(torch.int64), w0[beg], beg, end, _k10_walk(ts, vals, fetched, beg, end)


def _k10_walk(ts, vals, fetched, beg, end):
    """Per run [beg, end): count, first/last ts, the value at each (the
    largest of equal ts, NaN propagating), the sum from 0.0 in row order,
    min and max, over the fetched rows, as the kernel's walk_rows."""
    R_ = int(beg.shape[0])
    cnt = torch.zeros(R_, dtype=torch.int32)
    fts = torch.full((R_,), R.INT64_MAX, dtype=torch.int64)
    lts = torch.full((R_,), R.INT64_MIN, dtype=torch.int64)
    fv = torch.full((R_,), R.F64_MIN, dtype=torch.float64)
    lv = fv.clone()
    total = torch.zeros(R_, dtype=torch.float64)
    mn = torch.full((R_,), R.F64_MAX, dtype=torch.float64)
    mx = torch.full((R_,), R.F64_MIN, dtype=torch.float64)
    small = torch.full((R_,), R.F64_MIN, dtype=torch.float64)
    longest = int((end - beg).max()) if R_ else 0
    for off in range(longest):
        r = beg + off
        live = (r < end) & fetched[r.clamp(max=max(int(ts.shape[0]) - 1, 0))]
        i = torch.nonzero(live).flatten()
        v, t = vals[r[i]], ts[r[i]]
        cnt[i] += 1
        total[i] = total[i] + v
        mn[i] = torch.minimum(mn[i], v)
        mx[i] = torch.maximum(mx[i], v)
        new_f, new_l = t < fts[i], t > lts[i]
        fv[i] = torch.where(new_f, torch.maximum(small[i], v),
                            torch.where(t == fts[i], torch.maximum(fv[i], v), fv[i]))
        lv[i] = torch.where(new_l, torch.maximum(small[i], v),
                            torch.where(t == lts[i], torch.maximum(lv[i], v), lv[i]))
        fts[i] = torch.minimum(fts[i], t)
        lts[i] = torch.maximum(lts[i], t)
    return cnt, fts, lts, fv, lv, total, mn, mx


def _k10_emulation(sid, ts, vals, fetched, start, step, range_, n_steps, k, num_series,
                   n_steps_actual):
    """K10's two stages in torch ops: the slice table, then each cell
    (s, w) combining slices w, w - 1, ... newest first, the slice holding
    t_w - range cut to its rows in the window (found by bisection, summed
    from the rows), older slices skipped."""
    s_sid, s_w0, s_beg, s_end, st = _k10_slices(sid, ts, vals, fetched, start, step)
    table = torch.full((num_series, n_steps), -1, dtype=torch.int64)
    inside = s_w0 < n_steps
    table[s_sid[inside], s_w0[inside]] = torch.nonzero(inside).flatten()
    cells = num_series * n_steps
    s = torch.arange(cells) // n_steps
    w = torch.arange(cells) % n_steps
    t_w = start + w * step
    lo = t_w - range_
    ldiff = (lo - start).to(torch.float64)
    lo_w0 = torch.ceil(ldiff / torch.full_like(ldiff, float(step))).to(torch.int64).clamp(min=0)
    oldest = torch.maximum(w - k + 1, lo_w0)
    out = R.WindowStats(*(x[:1].expand(cells).clone() for x in (
        torch.zeros(1, dtype=torch.int32), torch.full((1,), R.INT64_MAX),
        torch.full((1,), R.INT64_MIN), torch.full((1,), R.F64_MIN, dtype=torch.float64),
        torch.full((1,), R.F64_MIN, dtype=torch.float64), torch.zeros(1, dtype=torch.float64),
        torch.full((1,), R.F64_MAX, dtype=torch.float64),
        torch.full((1,), R.F64_MIN, dtype=torch.float64))))
    have = torch.zeros(cells, dtype=torch.bool)
    done = w >= n_steps_actual
    for j in range(k):
        m = w - j
        sl = table[s, m.clamp(min=0)]
        act = ~done & (m >= oldest) & (m >= 0) & (sl >= 0)
        act &= st[0][sl.clamp(min=0)] > 0
        i = torch.nonzero(act).flatten()
        x = sl[i]
        ft, lt = st[1][x], st[2][x]
        past = lt <= lo[i]
        done[i[past]] = True
        i, x, ft, lt = i[~past], x[~past], ft[~past], lt[~past]
        whole = (ft > lo[i]) & (lt <= t_w[i])
        part = [y[x].clone() for y in st]
        cut = torch.nonzero(~whole).flatten()
        if cut.numel():
            a = R._bisect(ts, s_beg[x[cut]], s_end[x[cut]], lo[i[cut]])
            b = R._bisect(ts, a, s_end[x[cut]], t_w[i[cut]])
            for y, z in zip(part, _k10_walk(ts, vals, fetched, a, b)):
                y[cut] = z
        use = torch.nonzero(part[0] > 0).flatten()
        c, p = i[use], [y[use] for y in part]
        newest = ~have[c]
        out.count[c] += p[0]
        out.sum[c] = out.sum[c] + p[5]
        out.min[c] = torch.minimum(out.min[c], p[6])
        out.max[c] = torch.maximum(out.max[c], p[7])
        out.last_ts[c] = torch.where(newest, p[2], out.last_ts[c])
        out.last_val[c] = torch.where(newest, p[4], out.last_val[c])
        have[c] = True
        out.first_ts[c] = p[1]
        out.first_val[c] = p[3]
        done[i[ft <= lo[i]]] = True
    return out


@pytest.mark.parametrize("case", sorted(ALL_WINDOW_CASES))
def test_k10_two_stage_emulation_matches_reference(case):
    """K10's slice table and newest-first combine (csrc/range_windows.cu),
    emulated in torch ops, give the reference's bytes in all eight
    statistics: slices cut by the window's left edge, the clamp slice,
    slices of many rows and empty ones, padded steps, k past the range,
    NaN, +-inf and equal timestamps."""
    kw, off, step, rng_ms, steps, w_pad, k_pad = ALL_WINDOW_CASES[case]
    sid, ts, vals, valid = _counter(7, **kw)
    start = int(ts.min()) + off
    k = k_pad or -(-rng_ms // step)
    n_series = int(sid.max()) + 1
    want = jrate.range_windows_dyn(
        jnp.asarray(sid), jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        start=np.int64(start), step=np.int64(step), range_=np.int64(rng_ms),
        n_steps=w_pad, k=k, num_series=n_series, n_steps_actual=np.int64(steps))
    got = _k10_emulation(_t(sid), _t(ts), _t(vals), _t(valid), start, step, rng_ms, w_pad, k,
                         n_series, steps)
    assert int(got.count.sum()) > 0
    for f in R.WindowStats.FIELDS:
        assert _bits_equal(getattr(got, f).numpy(), getattr(want, f)), f"{case}: {f} differs"


# ---- K11: range_finalize ---------------------------------------------------------------


def _stats_pair(seed, case="2m_25s_padded", counter=False):
    kw, off, step, rng_ms, steps, w_pad, k_pad = WINDOW_CASES[case]
    sid, ts, vals, valid = _counter(seed, **kw)
    if counter:
        vals = _np(jrate.strip_counter_resets_segmented(
            jnp.asarray(sid), jnp.asarray(vals), jnp.asarray(valid)))
    start = int(ts.min()) + off
    k = k_pad or -(-rng_ms // step)
    n_series = int(sid.max()) + 1
    js = jrate.range_windows_dyn(
        jnp.asarray(sid), jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid),
        start=np.int64(start), step=np.int64(step), range_=np.int64(rng_ms),
        n_steps=w_pad, k=k, num_series=n_series, n_steps_actual=np.int64(steps))
    ts_ = R.WindowStats(*(torch.from_numpy(np.array(getattr(js, f)))
                          for f in R.WindowStats.FIELDS))
    grid = R.RangeGrid(start, step, rng_ms, w_pad, k, n_series, steps)
    return js, ts_, grid


@pytest.mark.parametrize("func", sorted(R.FUNC_CODES))
def test_range_finalize_matches_reference(func):
    js, ts_, grid = _stats_pair(11, counter=func in ("rate", "increase"))
    got = R.range_finalize_plain([ts_], grid, func).numpy()
    if func in R.RATE_FUNCS:
        vals, defined = jrate.extrapolated_rate_dyn(
            js, np.int64(grid.start), np.int64(grid.step), np.int64(grid.range_),
            grid.n_steps, func)
    elif func == "__last_ts":
        vals, defined = js.last_ts / 1000.0, js.count >= 1
    else:
        vals, defined = jrate.over_time(js, func)
    want = np.where(np.asarray(defined), np.asarray(vals, np.float64), np.nan)
    assert np.isfinite(got).sum() > 0
    assert _same(got, want), func


@pytest.mark.parametrize("func", ["rate", "avg_over_time", "last_over_time"])
def test_range_finalize_static_spec(func):
    """The legacy path's static-spec form of the reference gives the same
    answer on the real steps."""
    js, ts_, grid = _stats_pair(12, case="5m_60s", counter=func == "rate")
    spec = jrate.RangeSpec(grid.start, grid.start + (grid.n_steps - 1) * grid.step, grid.step,
                           grid.range_)
    if func == "rate":
        vals, defined = jrate.extrapolated_rate(js, spec, func)
    else:
        vals, defined = jrate.over_time(js, func)
    want = np.where(np.asarray(defined), np.asarray(vals, np.float64), np.nan)
    assert _same(R.range_finalize_plain([ts_], grid, func).numpy(), want)


def test_merge_disjoint_stats_matches_reference():
    """Three series-disjoint regions (each series kept in one of them)
    merged by selection in region order."""
    kw, off, step, rng_ms, steps, w_pad, k_pad = WINDOW_CASES["5m_60s"]
    sid, ts, vals, valid = _counter(13, **kw)
    start = int(ts.min()) + off
    k = -(-rng_ms // step)
    n_series = int(sid.max()) + 1
    jparts, tparts = [], []
    for r in range(3):
        v = valid & (sid % 3 == r)
        js = jrate.range_windows_dyn(
            jnp.asarray(sid), jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(v),
            start=np.int64(start), step=np.int64(step), range_=np.int64(rng_ms),
            n_steps=w_pad, k=k, num_series=n_series, n_steps_actual=np.int64(steps))
        jparts.append(js)
        tparts.append(R.WindowStats(*(torch.from_numpy(np.array(getattr(js, f)))
                                      for f in R.WindowStats.FIELDS)))
    jm = jparts[0]
    for js in jparts[1:]:
        jm = jrate.merge_disjoint_stats(jm, js)
    tm = tparts[0]
    for t in tparts[1:]:
        tm = R.merge_disjoint_stats(tm, t)
    for f in R.WindowStats.FIELDS:
        assert _same(getattr(tm, f).numpy(), getattr(jm, f)), f
    grid = R.RangeGrid(start, step, rng_ms, w_pad, k, n_series, steps)
    vals_j, defined = jrate.over_time(jm, "sum_over_time")
    want = np.where(np.asarray(defined), np.asarray(vals_j), np.nan)
    assert _same(R.range_finalize_plain(tparts, grid, "sum_over_time").numpy(), want)


# ---- B17: the prologue and K12 against _region_stats / _finalize ------------------------

_RADICES = (4, 8)
_CARDS = (3, 6)


def _planes(seed, unit_ns, chunk, nulls=True):
    """Super-tile-like planes of 2 tags (codes sorted with ts), the native
    unit `unit_ns`, chunked, with pad rows, invalid rows and NULL values."""
    rng = np.random.default_rng(seed)
    rows = []
    for a in range(_CARDS[0]):
        for b in range(_CARDS[1]):
            if rng.random() < 0.2:
                continue  # an absent series
            n = int(rng.integers(20, 60))
            t = np.sort(rng.integers(0, 900, n)) * 1000 + 1_000_000
            v = np.cumsum(rng.uniform(0, 3, n))
            if rng.random() < 0.5:
                v[n // 2:] -= v[n // 2] - 0.5
            rows.append((np.full(n, a), np.full(n, b), t, v))
    ca = np.concatenate([r[0] for r in rows]).astype(np.int32)
    cb = np.concatenate([r[1] for r in rows]).astype(np.int32)
    ts_ms = np.concatenate([r[2] for r in rows]).astype(np.int64)
    v = np.concatenate([r[3] for r in rows])
    n = ts_ms.shape[0]
    pad = -(-n // chunk) * chunk
    def padded(x, fill):
        out = np.full(pad, fill, x.dtype)
        out[:n] = x
        return out
    ts_nat = ts_ms * 1_000_000 // unit_ns
    valid = padded(rng.random(n) < 0.9, False)
    present = padded(rng.random(n) < 0.92 if nulls else np.ones(n, bool), False)
    planes = dict(a=padded(ca, 0), b=padded(cb, 0), ts=padded(ts_nat, 0), v=padded(v, 0.0),
                  present=present, valid=valid)
    return planes, pad


def _chunks(x, chunk):
    return [torch.from_numpy(x[o:o + chunk].copy()) for o in range(0, x.shape[0], chunk)]


@pytest.mark.parametrize("func", ["rate", "increase", "delta", "avg_over_time",
                                  "last_over_time", "__last_ts"])
@pytest.mark.parametrize("unit_ns", [1_000_000, 1_000, 1])
def test_region_stats_prologue_matches_reference(func, unit_ns):
    """The prologue (fetch bound in the native unit, code masks, mixed-radix
    sid, offset) + K9/K10/K11 over two chunks, against the reference's
    `_region_stats` and `_finalize`."""
    chunk = 256
    planes, pad = _planes(21, unit_ns, chunk)
    start, step, rng_ms, offset = 1_200_000, 25_000, 120_000, 60_000
    steps = (1_800_000 - start) // step + 1
    w_pad = 1 << (steps - 1).bit_length()
    k = 8
    lo = (start - rng_ms - offset) * 1_000_000 // unit_ns
    hi = (1_800_000 - offset) * 1_000_000 // unit_ns + 1
    mask_a = np.array([True, False, True, False])  # a matcher on tag a
    s_pad = _RADICES[0] * _RADICES[1]
    csig = (func, None, s_pad, w_pad, k, _RADICES, unit_ns, ((0, _RADICES[0]),), ())
    dyn = {"lo": np.int64(lo), "hi": np.int64(hi), "offset": np.int64(offset),
           "start": np.int64(start), "step": np.int64(step), "range": np.int64(rng_ms),
           "nsteps": np.int64(steps), "masks": (jnp.asarray(mask_a),)}
    jsrc = (
        ((jnp.asarray(planes["a"]),), (jnp.asarray(planes["b"]),)),
        (jnp.asarray(planes["ts"]),), (jnp.asarray(planes["v"]),),
        (jnp.asarray(planes["present"]),), (jnp.asarray(planes["valid"]),),
    )
    jstats, jpres = jtile._region_stats(jsrc, dyn, None, csig)
    want = np.asarray(jtile._finalize(jstats, dyn, csig))

    src = R.RowSource(
        ts=_chunks(planes["ts"], chunk), values=_chunks(planes["v"], chunk), num_series=s_pad,
        codes=(_chunks(planes["a"], chunk), _chunks(planes["b"], chunk)), radices=_RADICES,
        masks=((0, torch.from_numpy(mask_a)),), nulls=_chunks(planes["present"], chunk),
        valid=_chunks(planes["valid"], chunk), lo=lo, hi=hi, unit_ns=unit_ns, offset=offset)
    grid = R.RangeGrid(start, step, rng_ms, w_pad, k, s_pad, steps)
    adjusted = None
    if func in ("rate", "increase"):
        adjusted, _layout = R.strip_counter_resets(src)
    stats, pres = R.range_windows(src, grid, values=adjusted)
    got = R.range_finalize([stats], grid, func).view(s_pad, w_pad).numpy()
    assert np.array_equal(pres.numpy(), np.asarray(jpres))
    for f in ("count", "first_ts", "last_ts"):
        assert _same(getattr(stats, f).numpy(), getattr(jstats, f)), f
    for f in ("min", "max"):
        if func in ("rate", "increase"):  # values re-accumulated across resets
            np.testing.assert_allclose(getattr(stats, f).numpy(), getattr(jstats, f), rtol=1e-12)
        else:
            assert _same(getattr(stats, f).numpy(), getattr(jstats, f)), f
    assert np.isfinite(got).sum() > 0
    if func in ("rate", "increase"):
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert np.array_equal(np.isnan(got), np.isnan(want))
    else:
        assert _same(got, want)


@pytest.mark.parametrize("op", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("keep_idx", [(), (0,), (1,), (1, 0)])
def test_series_fold_matches_reference_finalize(op, keep_idx):
    """K12's plain version against the fold of the reference's `_finalize`
    (segment sums over the sid -> gid map) on a [S_pad, W_pad] matrix with
    NaN holes."""
    js, ts_, _grid = _stats_pair(17, case="2m_25s_padded")
    s_pad = _RADICES[0] * _RADICES[1]
    # regroup the 6 real series into the [4 x 8] code space, rest empty
    n_series = int(np.asarray(js.count).shape[0]) // 64
    w_pad = 64
    def spread(x, fill):
        x = np.asarray(x).reshape(n_series, w_pad)
        out = np.full((s_pad, w_pad), fill, x.dtype)
        out[[0, 3, 9, 10, 17, 30][:n_series]] = x
        return out.reshape(-1)
    fills = {"count": 0, "first_ts": R.INT64_MAX, "last_ts": R.INT64_MIN, "first_val": R.F64_MIN,
             "last_val": R.F64_MIN, "sum": 0.0, "min": R.F64_MAX, "max": R.F64_MIN}
    jstats = jrate.WindowStats(**{f: jnp.asarray(spread(getattr(js, f), fills[f]))
                                  for f in R.WindowStats.FIELDS})
    func = "avg_over_time"
    csig = (func, op, s_pad, w_pad, 8, _RADICES, 1_000_000, (), keep_idx)
    dyn = {"start": np.int64(0), "step": np.int64(1), "range": np.int64(1)}
    want = np.asarray(jtile._finalize(jstats, dyn, csig))
    tstats = R.WindowStats(*(torch.from_numpy(np.array(getattr(jstats, f)))
                             for f in R.WindowStats.FIELDS))
    grid = R.RangeGrid(0, 1, 1, w_pad, 8, s_pad, 40)
    mat = R.range_finalize([tstats], grid, func).view(s_pad, w_pad)
    offsets, members = (torch.from_numpy(x) for x in R.group_csr(_RADICES, keep_idx))
    got = R.series_fold(mat, offsets, members, op).numpy()
    assert np.isfinite(got).sum() > 0
    assert _same(got, want)


@pytest.mark.parametrize("keep_idx", [(), (0,), (1,), (0, 1), (1, 0)])
def test_gid_map_matches_reference(keep_idx):
    want = jtile._gid_map(_RADICES, list(keep_idx))
    assert np.array_equal(R.gid_map(_RADICES, keep_idx), want)
    offsets, members = R.group_csr(_RADICES, keep_idx)
    for g in range(offsets.shape[0] - 1):
        mem = members[offsets[g]:offsets[g + 1]]
        assert np.array_equal(mem, np.nonzero(want == g)[0])


# ---- wrappers on the CPU ----------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU source runs the plain versions and launches nothing."""
    sid, ts, vals, valid = _counter(31, invalid=True)
    src = R.RowSource(ts=[_t(ts)], values=[_t(vals)], num_series=int(sid.max()) + 1,
                      sid=[_t(sid)], valid=[_t(valid)])
    grid = R.RangeGrid(int(ts.min()) + 60_000, 30_000, 120_000, 64, 4, src.num_series, 50)
    counts = [f.launches for f in (R.strip_counter_resets, R.range_windows,
                                   R.range_finalize, R.series_fold)]
    adj, layout = R.strip_counter_resets(src)
    assert layout is None
    assert _same(adj.numpy()[valid], R.strip_counter_resets_plain(
        _t(sid), _t(vals), _t(valid)).numpy()[valid])
    stats, pres = R.range_windows(src, grid, values=adj)
    want = R.range_windows_plain(_t(sid), _t(ts), adj, _t(valid), grid.start, grid.step,
                                 grid.range_, grid.n_steps, grid.k, grid.num_series, 50)
    for f in R.WindowStats.FIELDS:
        assert _same(getattr(stats, f).numpy(), getattr(want, f).numpy())
    assert bool(pres.all())
    mat = R.range_finalize([stats], grid, "rate").view(grid.num_series, grid.n_steps)
    offsets, members = (torch.from_numpy(x) for x in R.group_csr((src.num_series,), ()))
    R.series_fold(mat, offsets, members, "sum")
    assert counts == [f.launches for f in (R.strip_counter_resets, R.range_windows,
                                           R.range_finalize, R.series_fold)]


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError):
        R.range_finalize([], R.RangeGrid(0, 1, 1, 1, 1, 1, 1), "rate")
    with pytest.raises(ValueError):
        R.series_fold(torch.zeros((2, 2), dtype=torch.float64), torch.zeros(2, dtype=torch.int64),
                      torch.zeros(2, dtype=torch.int64), "median")
    with pytest.raises(ValueError):
        R.range_finalize([R.WindowStats(*[torch.zeros(1)] * 8)],
                         R.RangeGrid(0, 1, 1, 1, 1, 1, 1), "irate")


# ---- K12's plan and its order contract -----------------------------------------------


@pytest.mark.parametrize("S,G,W,form,tw,grid", [
    (4096, 1, 1024, "staged", 8, 128),      # T2 / T5: one group, 128 CTAs of 8 steps
    (4096, 64, 1024, "cells", 0, 256),     # 65,536 cells: enough in flight
    (4096, 16, 1024, "staged", 32, 512),
    (4096, 4096, 1024, "cells", 0, 16384),  # G = S: a member a group
    (4096, 1024, 1024, "cells", 0, 4096),   # the cells fill the card
    (4096, 1, 16, "staged", 8, 2),
    (4096, 4096, 16, "cells", 0, 256),      # a member a group
    (64, 16, 64, "cells", 0, 4),            # 4 members a group
    (40, 0, 64, "cells", 0, 0),
])
def test_series_fold_plan(S, G, W, form, tw, grid):
    """K12's form, tile and grid from (S, G, W) alone."""
    assert R.series_fold_plan(S, G, W) == {"form": form, "tw": tw, "grid": grid}


def _order_sensitive_stats(seed: int, s_pad: int, w_pad: int):
    """Window stats whose sum_over_time is a matrix of mixed magnitudes
    (1e-8 to 1e8, both signs) with NaN holes: its sums depend on the
    order of the adds."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.integers(-8, 9, (s_pad, w_pad))
    vals = rng.standard_normal((s_pad, w_pad)) * mag
    present = rng.random((s_pad, w_pad)) >= 0.2
    present[:, 0] = False  # a step with no member
    n = s_pad * w_pad
    cnt = present.astype(np.int32).reshape(-1)
    fields = dict(count=cnt, first_ts=np.zeros(n, np.int64), last_ts=np.zeros(n, np.int64),
                  first_val=np.zeros(n), last_val=np.zeros(n), sum=vals.reshape(-1),
                  min=np.zeros(n), max=np.zeros(n))
    return vals, present, fields


@pytest.mark.parametrize("op", ["sum", "avg", "count", "max"])
@pytest.mark.parametrize("keep_idx", [(), (0,), (1, 0)])
def test_series_fold_order_sensitive_matches_reference_finalize(op, keep_idx):
    """K12's left fold in ascending series id on a matrix where a pairwise
    sum gives other bytes: byte for byte the reference's `_finalize` at
    G = 1, a middle G (16 groups of 16) and G = S."""
    radices = (16, 16)
    s_pad, w_pad = 256, 24
    vals, present, fields = _order_sensitive_stats(7, s_pad, w_pad)
    zeroed = np.where(present, vals, 0.0)
    left = np.zeros(w_pad)
    for r in range(s_pad):
        left = left + zeroed[r]

    def pairwise(rows):
        if rows.shape[0] == 1:
            return rows[0]
        half = rows.shape[0] // 2
        return pairwise(rows[:half]) + pairwise(rows[half:])

    assert not np.array_equal(left.view(np.uint64), pairwise(zeroed).view(np.uint64))
    jstats = jrate.WindowStats(**{f: jnp.asarray(v) for f, v in fields.items()})
    func = "sum_over_time"
    csig = (func, op, s_pad, w_pad, 8, radices, 1_000_000, (), keep_idx)
    dyn = {"start": np.int64(0), "step": np.int64(1), "range": np.int64(1)}
    want = np.asarray(jtile._finalize(jstats, dyn, csig))
    tstats = R.WindowStats(*(torch.from_numpy(np.array(fields[f])) for f in R.WindowStats.FIELDS))
    grid = R.RangeGrid(0, 1, 1, w_pad, 8, s_pad, w_pad)
    mat = R.range_finalize([tstats], grid, func).view(s_pad, w_pad)
    offsets, members = (torch.from_numpy(x) for x in R.group_csr(radices, keep_idx))
    got = R.series_fold(mat, offsets, members, op).numpy()
    if keep_idx == () and op == "sum":
        assert np.array_equal(got[0, 1:].view(np.uint64), left[1:].view(np.uint64))
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got)) and nan[:, 0].all()
    assert np.array_equal(got[~nan].view(np.uint64), want[~nan].view(np.uint64))


def test_series_fold_rejects_an_unknown_tile():
    """K12's launch takes the cell form (0) or one of the staged tiles."""
    mat = torch.zeros((4, 3), dtype=torch.float64)
    off, mem = (torch.from_numpy(x) for x in R.group_csr((4,), ()))
    with pytest.raises(ValueError):
        R._series_fold_launch(mat, off, mem, "sum", 12)
    with pytest.raises(ValueError):
        R.series_fold(mat, off, mem, "tree")
