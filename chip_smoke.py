#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (greptimedb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--hours 12] [--hosts 4000] [--reps 5]

Phases, each printing one JSON line:

1. device  — requires a CUDA device; prints the card's name and power
             limit as `nvidia-smi --query-gpu=name,power.limit` gives them.
2. build   — builds the four kernels of csrc/ for sm_90a (one nvcc each,
             all started together).
3. kernels — runs K1-K4 against their plain torch versions on the card, at
             the main path's shapes (TSBS cpu-only, 4000 hosts x 12 h =
             17.28 M rows, C = 1 and C = 10, span 16) and on edge cases
             (shuffled ids, NULLs, +-inf/NaN, all-masked blocks, ts ties,
             a ragged tail); every kernel runs twice and must give
             byte-identical results; times kernel, plain version and the
             nearest single PyTorch call with CUDA events.
4. slice   — TSBS cpu-only at --hosts x --hours (10 s scrape, 10 metrics),
             written through the port's Database at its storage defaults
             with the WAL on, flushed to Parquet, then the 15 TSBS
             queries through Database.sql: once cold and --reps times
             warm on the device path.  Each result is held against the
             port's CPU (Arrow) backend — keys, counts, min, max, last
             exactly; sum/avg within rel 1e-12 — and double-groupby-1
             also against a numpy ground truth built during ingest.  Per query it asserts that the
             lowered-query counter advanced and that every kernel of the
             query's path launched.
5. kernels line, then the last line {"ok": true, "device": {...}}.

It imports neither jax nor the reference package (greptimedb_tpu).  It
exits non-zero, printing no result, when no CUDA device is present or when
it runs outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# ---- the TSBS cpu-only workload (the repository's bench.py query builder) ----

SCRAPE_S = 10
T0 = 1_767_225_600_000  # 2026-01-01 UTC, epoch ms
METRICS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice",
]
SEED = 7
H3600 = 3600_000


class Tsbs:
    """Windows, hosts and the 15 queries of the TSBS cpu-only family."""

    def __init__(self, n_hosts: int, hours: int):
        self.n_hosts, self.hours = n_hosts, hours
        self.end = T0 + hours * H3600
        self.w12 = (self.end - 12 * H3600, self.end)
        self.w8 = (self.end - 8 * H3600, self.end)
        self.w1 = (self.end - H3600, self.end)
        self.host1 = f"host_{703 % n_hosts}"
        self.hosts8 = [f"host_{i % n_hosts}" for i in (703, 1217, 2048, 99, 3777, 1500, 2901, 42)]

    def _q(self, window, metrics_n, hosts=None, bucket="1h", funcs="max"):
        lo, hi = window
        cols = ", ".join(f"{funcs}({m}) AS {funcs}_{m}" for m in METRICS[:metrics_n])
        where = f"ts >= {lo} AND ts < {hi}"
        if hosts is not None:
            where += (
                f" AND hostname = '{hosts}'"
                if isinstance(hosts, str)
                else f" AND hostname IN ({', '.join(repr(h) for h in hosts)})"
            )
        group = "tb" if hosts is not None else "hostname, tb"
        sel_host = "" if hosts is not None else "hostname, "
        return (
            f"SELECT {sel_host}time_bucket('{bucket}', ts) AS tb, {cols} "
            f"FROM cpu WHERE {where} GROUP BY {group}"
        )

    def queries(self) -> list[tuple[str, str]]:
        q, w12, w8, w1 = self._q, self.w12, self.w8, self.w1
        h1, h8 = self.host1, self.hosts8
        return [
            ("double-groupby-1", q(w12, 1, funcs="avg")),
            ("double-groupby-5", q(w12, 5, funcs="avg")),
            ("double-groupby-all", q(w12, 10, funcs="avg")),
            ("cpu-max-all-1", q(w8, 10, hosts=h1)),
            ("cpu-max-all-8", q(w8, 10, hosts=h8)),
            ("single-groupby-1-1-1", q(w1, 1, hosts=h1, bucket="1m")),
            ("single-groupby-1-1-12", q(w12, 1, hosts=h1, bucket="1m")),
            ("single-groupby-1-8-1", q(w1, 1, hosts=h8, bucket="1m")),
            ("single-groupby-5-1-1", q(w1, 5, hosts=h1, bucket="1m")),
            ("single-groupby-5-1-12", q(w12, 5, hosts=h1, bucket="1m")),
            ("single-groupby-5-8-1", q(w1, 5, hosts=h8, bucket="1m")),
            (
                "groupby-orderby-limit",
                f"SELECT time_bucket('1m', ts) AS minute, max(usage_user) AS mu FROM cpu "
                f"WHERE ts < {self.end - 1800_000} GROUP BY minute ORDER BY minute DESC LIMIT 5",
            ),
            (
                "lastpoint",
                "SELECT hostname, last_value(usage_user) AS last_user FROM cpu GROUP BY hostname",
            ),
            (
                "high-cpu-all",
                f"SELECT count(*) AS n, max(usage_user) AS m FROM cpu "
                f"WHERE usage_user > 90.0 AND ts >= {w12[0]} AND ts < {w12[1]}",
            ),
            (
                "high-cpu-1",
                f"SELECT count(*) AS n, max(usage_user) AS m FROM cpu "
                f"WHERE usage_user > 90.0 AND hostname = '{h1}' "
                f"AND ts >= {w12[0]} AND ts < {w12[1]}",
            ),
        ]


# The kernels each query's path launches at the default size (4000 hosts x
# 12 h) and the storage defaults: the region scan merges its SSTs into
# (hostname, ts) order, so K2's guard passes for host-major groups; minute
# buckets over whole hosts fail it (K3 reruns); scans under 2^16 rows go
# straight to K3.
_BLOCKED, _SCATTER, _LAST = "segment_reduce_blocked", "segment_reduce_scatter", "segment_last"
EXPECTED_PATH = {
    "double-groupby-1": {_BLOCKED},
    "double-groupby-5": {_BLOCKED},
    "double-groupby-all": {_BLOCKED},
    "cpu-max-all-1": {_SCATTER},
    "cpu-max-all-8": {_SCATTER},
    "single-groupby-1-1-1": {_SCATTER},
    "single-groupby-1-1-12": {_SCATTER},
    "single-groupby-1-8-1": {_SCATTER},
    "single-groupby-5-1-1": {_SCATTER},
    "single-groupby-5-1-12": {_SCATTER},
    "single-groupby-5-8-1": {_SCATTER},
    "groupby-orderby-limit": {_BLOCKED, _SCATTER},
    "lastpoint": {_BLOCKED, _LAST},
    "high-cpu-all": {_BLOCKED},
    "high-cpu-1": {_SCATTER},
}


def emit(obj: dict) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


# ---- kernel registry ----------------------------------------------------------

def kernel_table():
    """name -> (wrapper with .launches, source, reference kernel it replaces)."""
    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    src = "greptimedb_tpu_torch/csrc/"
    return {
        "mask_gids": (flt.mask_gids, src + "mask_gids.cu",
                      "greptimedb_tpu/parallel/executor.py:207"),
        "segment_reduce_blocked": (agg.segment_reduce_blocked, src + "segment_reduce_blocked.cu",
                                   "greptimedb_tpu/ops/aggregate.py:642"),
        "segment_reduce_scatter": (agg.segment_reduce_scatter, src + "segment_reduce_scatter.cu",
                                   "greptimedb_tpu/ops/aggregate.py:598"),
        "segment_last": (agg.segment_last, src + "segment_last.cu",
                         "greptimedb_tpu/ops/aggregate.py:792"),
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _s, _r) in kernel_table().items()}


def reset_counts() -> None:
    for fn, _s, _r in kernel_table().values():
        fn.launches = 0


# ---- phase 3: kernels against their plain versions ------------------------------

# H100 SXM data sheet: the HBM rate, and the peak of float32 arithmetic
# outside the tensor cores, where the kernels' compares, selects and adds
# run
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PLAIN_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _same_bytes(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is b
    return bool(torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                            b.view(torch.uint8) if b.dtype != torch.bool else b))


def _state_tensors(st) -> list:
    return [getattr(st, k) for k in ("sums", "counts", "mins", "maxs", "last_ts", "last_val")]


def _compare(kernel_out, plain_out, exact: bool, what: str) -> float:
    """Max abs difference of finite entries; NaN/inf positions must agree;
    exact outputs must be equal, sums within rel 1e-12."""
    import torch

    k, p = kernel_out, plain_out
    if k.shape != p.shape:
        raise AssertionError(f"{what}: shape {tuple(k.shape)} != {tuple(p.shape)}")
    if not k.is_floating_point():
        if not torch.equal(k, p):
            bad = int((k != p).sum())
            raise AssertionError(f"{what}: {bad} entries differ")
        return 0.0
    if not torch.equal(torch.isnan(k), torch.isnan(p)):
        raise AssertionError(f"{what}: NaN positions differ")
    inf = torch.isinf(p)
    if not torch.equal(torch.isinf(k), inf) or not torch.equal(k[inf], p[inf]):
        raise AssertionError(f"{what}: infinite entries differ")
    fin = torch.isfinite(p)
    diff = (k[fin] - p[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        if err != 0.0:
            raise AssertionError(f"{what}: max abs err {err}, expected exact")
    else:
        tol = 1e-12 * p[fin].abs().clamp(min=1.0)
        if diff.numel() and bool((diff > tol).any()):
            raise AssertionError(f"{what}: max abs err {err} beyond rel 1e-12")
    return err


def _check_state(k_st, p_st, what: str) -> float:
    err = 0.0
    for name, a, b in zip(("sums", "counts", "mins", "maxs", "last_ts", "last_val"),
                          _state_tensors(k_st), _state_tensors(p_st)):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}.{name}: present in one result only")
        if a is not None:
            err = max(err, _compare(a, b, exact=(name != "sums"), what=f"{what}.{name}"))
    return err


def _twice_identical(fn, what: str):
    import torch

    a = fn()
    b = fn()
    torch.cuda.synchronize()
    flat_a = a if isinstance(a, (tuple, list)) else (a,)
    flat_b = b if isinstance(b, (tuple, list)) else (b,)
    for x, y in zip(flat_a, flat_b):
        xs = _state_tensors(x) if hasattr(x, "sums") else [x]
        ys = _state_tensors(y) if hasattr(y, "sums") else [y]
        for u, v in zip(xs, ys):
            if torch.is_tensor(u) and not _same_bytes(u, v):
                raise AssertionError(f"{what}: two runs differ in their bytes")
    return a


def tsbs_planes(n_hosts: int, hours: int, n_cols: int, dev, seed: int = SEED):
    """Device planes laid out as the (hostname, ts) sorted region scan of
    TSBS cpu-only: host codes, ts, valid, n_cols uniform [0, 100) columns."""
    import torch

    ticks = hours * 3600 // SCRAPE_S
    n = n_hosts * ticks
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.arange(n_hosts, dtype=torch.int32, device=dev).repeat_interleave(ticks)
    ts = T0 + torch.arange(ticks, dtype=torch.int64, device=dev).repeat(n_hosts) * (SCRAPE_S * 1000)
    vals = [torch.rand(n, generator=g, dtype=torch.float64, device=dev) * 100.0 for _ in range(n_cols)]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    return n, codes, ts, valid, vals


def run_kernel_phase(n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 3: every kernel against its plain version, timed.  Returns
    name -> metrics for the kernels line (launches filled in later)."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    dev = torch.device("cuda", 0)
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, hours, 10, dev)
    card = 1 << (max(n_hosts, 1) - 1).bit_length()
    n_buckets = hours
    G = card * n_buckets
    lo, hi = T0, T0 + hours * H3600
    out: dict[str, dict] = {}

    # K1 at the double-groupby shape: ts range filter, hostname x 1h bucket
    k1_args = (valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
               (ts, T0, H3600, n_buckets), G - 1)
    gids, mask = _twice_identical(lambda: flt.mask_gids(*k1_args), "mask_gids")
    pg, pm = flt.mask_gids_plain(*k1_args)
    err = max(_compare(gids, pg, True, "mask_gids.gids"), _compare(mask, pm, True, "mask_gids.mask"))
    # reads valid, ts, codes once; writes gids and mask; per row 2
    # compares, a floor division and 2 mixed-radix steps (~8 operations)
    k1_bound, k1_by = bound(n * (1 + 8 + 4) + n * (4 + 1), n * 8)
    out["mask_gids"] = dict(
        max_abs_err=err,
        ms=_timed(lambda: flt.mask_gids(*k1_args), reps),
        plain_ms=_timed(lambda: flt.mask_gids_plain(*k1_args), max(reps // 2, 1)),
        bound_ms=k1_bound, bound_by=k1_by, library_ms=None,
    )

    # K2 at C = 1 and C = 10 over the K1 output; K3 on the same inputs
    # (the scatter path of a failing guard); one index_add_ as the library
    # yardstick of the sums.
    stats = {}
    for C in (1, 10):
        cols, masks = vals[:C], [mask] * C
        aggs = ("count", "max", "min", "sum")
        ok, k_st, _b = _twice_identical(
            lambda: agg.segment_reduce_blocked(cols, gids, masks, mask, G, aggs), f"blocked C={C}")
        assert ok, "the TSBS layout must pass the blocked guard"
        _okp, p_st, _bp = agg.segment_reduce_blocked_plain(cols, gids, masks, mask, G, aggs)
        e2 = _check_state(k_st, p_st, f"segment_reduce_blocked C={C}")
        order = agg.sort_segments(gids, mask, G)
        s_st = _twice_identical(
            lambda: agg.segment_reduce_scatter(cols, gids, masks, mask, G, aggs, order), f"scatter C={C}")
        e3 = _check_state(s_st, agg.segment_reduce_scatter_plain(cols, gids, masks, mask, G, aggs),
                          f"segment_reduce_scatter C={C}")
        stacked = torch.stack(cols, dim=1)
        safe = torch.where(mask, gids, G).to(torch.int64)
        lib = _timed(lambda: torch.zeros((G + 1, C), dtype=torch.float64, device=dev)
                     .index_add_(0, safe, stacked), reps)
        del stacked
        # ids, mask, C value columns read once; [C, G] states written once;
        # one operation per row, column and aggregate
        kb, kby = bound(n * (4 + 1 + 8 * C) + C * G * (8 + 4 + 8 + 8), n * C * len(aggs))
        stats[C] = dict(
            blocked=dict(
                max_abs_err=e2,
                ms=_timed(lambda: agg.segment_reduce_blocked(cols, gids, masks, mask, G, aggs), reps),
                plain_ms=_timed(lambda: agg.segment_reduce_blocked_plain(cols, gids, masks, mask, G, aggs), 1),
                bound_ms=kb, bound_by=kby, library_ms=lib,
            ),
            scatter=dict(
                max_abs_err=e3,
                ms=_timed(lambda: agg.segment_reduce_scatter(cols, gids, masks, mask, G, aggs), reps),
                plain_ms=_timed(lambda: agg.segment_reduce_scatter_plain(cols, gids, masks, mask, G, aggs), 1),
                bound_ms=kb, bound_by=kby, library_ms=lib,
            ),
        )
    out["segment_reduce_blocked"] = dict(stats[10]["blocked"], c1=stats[1]["blocked"])
    out["segment_reduce_scatter"] = dict(stats[10]["scatter"], c1=stats[1]["scatter"])

    # groupby-orderby-limit's shape: 1-minute buckets over the host-major
    # layout fail K2's guard, and K3 reruns; what the failed K2 call
    # (guard pass + verdict sync) adds to that query's device time
    n_min = hours * 60
    gm, mm = flt.mask_gids(valid, [(ts, "<", hi - 1800_000)], [], [], (ts, T0, 60_000, n_min), n_min - 1)
    ok, _st, _b = agg.segment_reduce_blocked(vals[:1], gm, [mm], mm, n_min, ("max",))
    assert not ok, "minute buckets over the host-major layout must fail the blocked guard"
    out["segment_reduce_blocked"]["guard_fail"] = dict(
        ms=_timed(lambda: agg.segment_reduce_blocked(vals[:1], gm, [mm], mm, n_min, ("max",)), reps),
        scatter_ms=_timed(lambda: agg.segment_reduce_scatter(vals[:1], gm, [mm], mm, n_min, ("max",)), reps),
    )
    del gm, mm

    # K4 at the lastpoint shape: group by hostname only
    gl, ml = flt.mask_gids(valid, [], [], [(codes, card)], None, card - 1)
    okl, _st, base = agg.segment_reduce_blocked([vals[0]], gl, [ml], ml, card, ("count",))
    assert okl, "lastpoint must pass the blocked guard"
    kl = _twice_identical(lambda: agg.segment_last(vals[0], ts, gl, ml, card, base=base), "segment_last")
    pl = agg.segment_last_plain(vals[0], ts, gl, ml, card, base=base)
    e4 = max(_compare(kl[0], pl[0], True, "segment_last.ts"), _compare(kl[1], pl[1], True, "segment_last.val"))
    ks = agg.segment_last(vals[0], ts, gl, ml, card)  # sorted-run form
    e4 = max(e4, _compare(ks[0], pl[0], True, "segment_last sorted.ts"),
             _compare(ks[1], pl[1], True, "segment_last sorted.val"))
    # ids, mask, ts read once, the winners' values gathered; [G] ts and
    # values written; a compare per row for ts and one for the row
    k4_bound, k4_by = bound(n * (4 + 1 + 8) + card * 8 + card * (8 + 8), n * 2)
    out["segment_last"] = dict(
        max_abs_err=e4,
        ms=_timed(lambda: agg.segment_last(vals[0], ts, gl, ml, card, base=base), reps),
        plain_ms=_timed(lambda: agg.segment_last_plain(vals[0], ts, gl, ml, card, base=base), 1),
        bound_ms=k4_bound, bound_by=k4_by, library_ms=None,
    )
    del vals, codes, ts, valid, gids, mask, gl, ml
    torch.cuda.empty_cache()
    run_edge_cases(dev)
    return out


def run_edge_cases(dev) -> None:
    """Shuffled ids, NULLs, +-inf/NaN, all-masked blocks, ts ties and a
    ragged tail: every kernel against its plain version, twice each."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    rng = np.random.default_rng(11)
    n = 300_000 + 1234  # not a multiple of 4096
    G = 512
    gid_np = np.sort(rng.integers(0, G, n)).astype(np.int32)
    v_np = rng.uniform(-50, 50, n)
    v_np[rng.choice(n, 40, replace=False)] = np.nan
    v_np[rng.choice(n, 40, replace=False)] = np.inf
    v_np[rng.choice(n, 40, replace=False)] = -np.inf
    ts_np = (T0 + rng.integers(0, 50, n) * 1000).astype(np.int64)  # many ties
    mask_np = rng.random(n) < 0.9
    mask_np[4096 * 3: 4096 * 6] = False  # all-masked blocks
    null_np = rng.random(n) < 0.85
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    gid, v, ts, mask = t(gid_np), t(v_np), t(ts_np), t(mask_np)
    v2 = t(rng.uniform(0, 1, n))
    colmask = mask & t(null_np)
    aggs = ("count", "max", "min", "sum")
    cases = {"clustered": gid, "shuffled": t(rng.permutation(gid_np))}
    for name, g in cases.items():
        ok, k_st, base = _twice_identical(
            lambda: agg.segment_reduce_blocked([v, v2], g, [colmask, mask], mask, G, aggs),
            f"edge {name} blocked")
        okp, p_st, _ = agg.segment_reduce_blocked_plain([v, v2], g, [colmask, mask], mask, G, aggs)
        if ok != okp:
            raise AssertionError(f"edge {name}: guard verdicts differ ({ok} vs {okp})")
        if name == "shuffled" and ok:
            raise AssertionError("shuffled ids must fail the blocked guard")
        if ok:
            _check_state(k_st, p_st, f"edge {name} blocked")
            kl = _twice_identical(lambda: agg.segment_last(v, ts, g, colmask, G, base=None), "edge last")
            okc, _s, cbase = agg.segment_reduce_blocked([v], g, [colmask], colmask, G, ("count",))
            kb = agg.segment_last(v, ts, g, colmask, G, base=cbase)
            pb = agg.segment_last_plain(v, ts, g, colmask, G, base=cbase)
            for a, b, w in ((kb[0], pb[0], "ts"), (kb[1], pb[1], "val"), (kl[0], pb[0], "sorted ts"),
                            (kl[1], pb[1], "sorted val")):
                _compare(a, b, True, f"edge {name} last {w}")
        s_st = _twice_identical(
            lambda: agg.segment_reduce_scatter([v, v2], g, [colmask, mask], mask, G, aggs),
            f"edge {name} scatter")
        _check_state(s_st, agg.segment_reduce_scatter_plain([v, v2], g, [colmask, mask], mask, G, aggs),
                     f"edge {name} scatter")
        kl = _twice_identical(lambda: agg.segment_last(v, ts, g, colmask, G), f"edge {name} last sorted")
        pl = agg.segment_last_plain(v, ts, g, colmask, G)
        _compare(kl[0], pl[0], True, f"edge {name} last ts")
        _compare(kl[1], pl[1], True, f"edge {name} last val")
    # K1: codes with unseen (-1) literals, NaN/inf comparisons, IN-lists,
    # negative ts offsets (floor division), null gates
    codes = t(rng.integers(-1, 40, n).astype(np.int32))
    f_np = rng.uniform(0, 100, n)
    f_np[rng.choice(n, 100, replace=False)] = np.nan
    f_np[rng.choice(n, 100, replace=False)] = np.inf
    f = t(f_np)
    tsn = t((T0 - 7 * H3600 + rng.integers(-10**9, 10**9, n)).astype(np.int64))
    valid = t(np.arange(n) < n - 777)
    gate = t(null_np)
    args = (valid,
            [(f, ">", 90.0), (codes, "in", (3, 5, -1, 39)), (f, "!=", 95.5), (tsn, ">=", T0 - 10**10)],
            [gate], [(codes, 64)], (tsn, T0, 3_600_000, 64), 64 * 64 - 1)
    kg, km = _twice_identical(lambda: flt.mask_gids(*args), "edge mask_gids")
    pg, pm = flt.mask_gids_plain(*args)
    _compare(kg, pg, True, "edge mask_gids gids")
    _compare(km, pm, True, "edge mask_gids mask")
    args_not_in = (valid, [(codes, "not in", (1, 2)), (f, "<=", float("inf"))], [], [], None, 0)
    kg, km = flt.mask_gids(*args_not_in)
    pg, pm = flt.mask_gids_plain(*args_not_in)
    _compare(km, pm, True, "edge mask_gids not in")


# ---- phase 4: the slice ------------------------------------------------------------

def _sorted_rows(table, keys):
    import pyarrow.compute as pc

    if keys:
        idx = pc.sort_indices(table, sort_keys=[(k, "ascending") for k in keys])
        table = table.take(idx)
    return table


def compare_tables(dev_t, cpu_t, query: str) -> float:
    """Device result vs CPU-backend result: same columns and rows; exact
    except sum/avg columns (rel 1e-12: only the f64 addition order
    differs).  Returns the max relative error of the inexact columns."""
    if dev_t.column_names != cpu_t.column_names:
        raise AssertionError(f"{query}: columns {dev_t.column_names} != {cpu_t.column_names}")
    if dev_t.num_rows != cpu_t.num_rows:
        raise AssertionError(f"{query}: {dev_t.num_rows} rows != {cpu_t.num_rows}")
    inexact = [c for c in dev_t.column_names if c.startswith(("avg", "sum"))]
    keys = [c for c in dev_t.column_names if c in ("hostname", "tb", "minute")]
    if "ORDER BY" not in query:
        dev_t, cpu_t = _sorted_rows(dev_t, keys), _sorted_rows(cpu_t, keys)
    worst = 0.0
    for c in dev_t.column_names:
        a = dev_t[c].to_pylist()
        b = cpu_t[c].to_pylist()
        if c not in inexact:
            if a != b:
                bad = sum(1 for x, y in zip(a, b) if x != y)
                raise AssertionError(f"{query}: column {c}: {bad} values differ")
            continue
        x = np.array([np.nan if v is None else v for v in a], dtype=np.float64)
        y = np.array([np.nan if v is None else v for v in b], dtype=np.float64)
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            raise AssertionError(f"{query}: column {c}: NULL positions differ")
        ok = ~np.isnan(y)
        rel = np.abs(x[ok] - y[ok]) / np.maximum(np.abs(y[ok]), 1e-300)
        if rel.size:
            worst = max(worst, float(rel.max()))
            if float(rel.max()) > 1e-12:
                raise AssertionError(f"{query}: column {c}: rel err {rel.max()} > 1e-12")
    return worst


def ingest(db, tsbs: Tsbs) -> tuple[int, dict]:
    """TSBS cpu-only rows through Database.write (WAL on), then flush.
    Returns (rows, double-groupby-1 ground truth {(host, hour): [sum, n]})."""
    import pyarrow as pa

    cols_sql = ", ".join(f"{m} DOUBLE" for m in METRICS)
    db.sql(
        f"CREATE TABLE cpu (hostname STRING, {cols_sql}, ts TIMESTAMP(3) TIME INDEX, "
        f"PRIMARY KEY (hostname)) WITH (append_mode = 'true')"
    )
    n_hosts = tsbs.n_hosts
    rng = np.random.default_rng(SEED)
    ticks_total = tsbs.hours * 3600 // SCRAPE_S
    chunk_ticks = max(1, 2_000_000 // n_hosts)
    hosts_arr = np.array([f"host_{i}" for i in range(n_hosts)])
    gt: dict[int, list] = {}
    n_rows = 0
    for start in range(0, ticks_total, chunk_ticks):
        ticks = min(chunk_ticks, ticks_total - start)
        ts = T0 + (start + np.arange(ticks, dtype=np.int64))[:, None] * (SCRAPE_S * 1000)
        ts = np.broadcast_to(ts, (ticks, n_hosts)).reshape(-1)
        hs = np.broadcast_to(hosts_arr[None, :], (ticks, n_hosts)).reshape(-1)
        vals = {m: rng.uniform(0.0, 100.0, ticks * n_hosts) for m in METRICS}
        batch = pa.table({
            "hostname": pa.array(hs),
            "ts": pa.array(ts, pa.timestamp("ms")),
            **{m: pa.array(vals[m], pa.float64()) for m in METRICS},
        })
        db.write("cpu", batch)
        n_rows += ticks * n_hosts
        w12 = tsbs.w12
        in_w = (ts >= w12[0]) & (ts < w12[1])
        if in_w.any():
            hour = ((ts[in_w] - w12[0]) // H3600).astype(np.int64)
            hidx = np.broadcast_to(np.arange(n_hosts)[None, :], (ticks, n_hosts)).reshape(-1)[in_w]
            key = hidx * 100 + hour
            sums = np.bincount(key, weights=vals["usage_user"][in_w])
            cnts = np.bincount(key)
            for k in np.nonzero(cnts)[0]:
                acc = gt.setdefault(int(k), [0.0, 0])
                acc[0] += sums[k]
                acc[1] += int(cnts[k])
    db.flush()
    return n_rows, gt


def check_ground_truth(table, gt: dict, tsbs: Tsbs) -> None:
    hosts = table["hostname"].to_pylist()
    tbs = table["tb"].cast("int64").to_pylist()
    avgs = table["avg_usage_user"].to_pylist()
    if len(hosts) != len(gt):
        raise AssertionError(f"double-groupby-1: {len(hosts)} groups, ground truth has {len(gt)}")
    for h, tb, a in zip(hosts, tbs, avgs):
        key = int(h[5:]) * 100 + (tb - tsbs.w12[0]) // H3600
        s, c = gt[key]
        if abs(a - s / c) > 1e-12 * abs(s / c):
            raise AssertionError(f"double-groupby-1 {h} {tb}: {a} vs ground truth {s / c}")


def run_slice(device: str, n_hosts: int, hours: int, reps: int, data_home: str) -> dict:
    """Phase 4 on `device` ("cuda" on the card; "cpu" to rehearse the
    control flow with the plain versions).  Returns the slice record."""
    from greptimedb_tpu_torch import Database

    tsbs = Tsbs(n_hosts, hours)
    # the storage defaults (64 MiB region / 512 MiB global write buffer,
    # two flush-encode threads): the load flushes as it goes, into many SSTs
    db = Database(data_home, device=device)
    is_cuda = device.startswith("cuda")
    if is_cuda:
        import torch
    t0 = time.perf_counter()
    n_rows, gt = ingest(db, tsbs)
    ingest_s = time.perf_counter() - t0
    ssts = sum(len(db.storage.region(rid).files()) for rid in db.storage.region_ids())
    emit({"phase": "ingest", "rows": n_rows, "hosts": n_hosts, "hours": hours,
          "seconds": ingest_s, "rows_per_s": n_rows / ingest_s, "ssts": ssts})

    per_query = {}
    full_size = n_hosts == 4000 and hours == 12
    reset_counts()  # the main path's run starts here
    for name, sql in tsbs.queries():
        before = launch_counts()
        lowered0 = db.query_engine.stats["lowered"]
        times = []
        stages: dict[str, list] = {}
        result = None
        for _ in range(1 + reps):
            t1 = time.perf_counter()
            result = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            for k, v in db.query_engine.last_timings.items():
                stages.setdefault(k, []).append(v)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        lowered = db.query_engine.stats["lowered"] - lowered0
        if lowered != 1 + reps:
            raise AssertionError(f"{name}: lowered counter advanced {lowered}, expected {1 + reps}")
        if is_cuda:
            ran = {k for k, d in delta.items() if d > 0}
            need = {"mask_gids"} | (EXPECTED_PATH[name] if full_size else set())
            if not need <= ran or not ({_BLOCKED, _SCATTER} & ran):
                raise AssertionError(f"{name}: kernels launched {sorted(ran)}, path needs {sorted(need)}")
        # the authoritative CPU backend on the same data
        db.config.query.backend = "cpu"
        t1 = time.perf_counter()
        cpu_t = db.sql_one(sql)
        cpu_ms = (time.perf_counter() - t1) * 1e3
        db.config.query.backend = "torch"
        rel = compare_tables(result, cpu_t, name + " " + sql)
        if name == "double-groupby-1":
            check_ground_truth(result, gt, tsbs)
        if result.num_rows == 0:
            raise AssertionError(f"{name}: empty result")
        warm = sorted(times[1:]) if reps else times
        per_query[name] = {
            "rows_out": result.num_rows,
            "cold_ms": times[0],
            "warm_p50_ms": float(np.median(warm)),
            "cpu_backend_ms": cpu_ms,
            "max_rel_err": rel,
            # warm p50 of each host-timed stage (scan / tile / device /
            # readback / post)
            "stage_p50_ms": {k: float(np.median(v[1:] if reps else v)) for k, v in stages.items()},
            "launches": {k: v for k, v in delta.items() if v},
        }
        emit({"phase": "query", "name": name, **per_query[name]})
    totals = launch_counts()
    if db.query_engine.stats["declined"]:
        raise AssertionError(f"{db.query_engine.stats['declined']} queries declined by try_lower")
    db.close()
    return {"rows": n_rows, "ingest_s": ingest_s, "ssts": ssts, "queries": per_query,
            "launches": totals}


# ---- main ------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=5, help="warm runs per query")
    ap.add_argument("--kernel-reps", type=int, default=10, help="timed launches per kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "greptimedb_tpu_torch", "csrc")):
        print("chip_smoke: greptimedb_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.modules.setdefault("jax", None)  # the port must not need it

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    from greptimedb_tpu_torch.kernels import build_all

    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": built})

    t0 = time.perf_counter()
    kstats = run_kernel_phase(args.hosts, args.hours, args.kernel_reps)
    emit({"phase": "kernels_checked", "seconds": time.perf_counter() - t0})

    work = os.path.join(HERE, "build", "chip_smoke")  # listed in .gitignore
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sl = run_slice("cuda", args.hosts, args.hours, args.reps, os.path.join(work, "db"))
        emit({"phase": "slice", "seconds": time.perf_counter() - t0, "rows": sl["rows"],
              "card": smi, "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in sl["queries"].items()}})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name, (_fn, source, replaces) in kernel_table().items():
        s = kstats[name]
        launches = sl["launches"][name]
        if launches == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
            **{k: s[k] for k in ("c1", "guard_fail") if k in s},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
