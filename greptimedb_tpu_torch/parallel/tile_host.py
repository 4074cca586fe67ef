"""The tile path's host routes: answers taken from the host consolidation,
before the card is chosen.

Counterpart of the host section of `greptimedb_tpu/parallel/tile_cache.py`
(`TileExecutor._host_execute`, `_host_cold_grouped` with both its
ladders, the `_HOST_PATH_*` / `_COLD_*` bounds, `_np_filter`).
`TileExecutor` (parallel/tile_executor.py) mixes `HostRoutes` in and
calls its two routes after the plan is built and before any plane is
uploaded:

* `host_execute` (the `host_fast_path` pass): a pk-equality aggregate
  with no group tags (scalar or time-bucketed) binary-searches each pk
  code's run in the (pk, ts)-sorted host copies, narrows a single-pk
  run by the ts window, and folds the slice with numpy (bincount,
  minimum.at, maximum.at), memtable tails included.  It declines a slice
  over `_HOST_PATH_MAX_ROWS` rows, and a multi-key slice over
  `_HOST_PATH_MAX_CELLS` rows x value columns once every value column is
  resident on the card (the warm tile dispatch takes it); served while
  the planes are cold, such a slice carries the `wide_cold` hint (the
  executor then schedules the family's fused build);
* `host_cold_grouped` (the `cold_host_serve` pass), two ladders.  The
  legacy one (`tile.fused_build` off): a grouped aggregate whose planes
  are not resident answers once per entry (`_SuperTiles.cold_served`)
  with dense bincount folds over the whole consolidation, and the next
  query builds the planes; it declines `last_value`, group spaces past
  `_COLD_COMPACT_GROUPS` and warm planes or a warm window tile.  The fused
  one (a family's first touch, its build then warming the planes in the
  background): every family — `last_value` from run boundaries
  (`host_last_winners`), a hash-scale group space folded
  unique-compacted, and a large source folded in ranges on a pool of up
  to 4 threads, merged in range order.  Both decline memtable-only
  sources.

Both build the [G] finals the device decode builds and assemble them with
the executor's `_assemble_result` (a compacted fold with
`_append_agg_columns`), so a host answer and a card answer of the same
query are the same bytes up to the accumulation order.  They never catch
an error: a route either declines (returns None) before the device path
is chosen, or answers.  The bounds are class attributes, so a test may
lower them on an executor instance.

Not carried over: persisted consolidations (the mmap'd columns the
reference's cold serve pages from).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa

from ..query import passes
from .executor import COUNT_STAR, _FUNC_TO_KERNEL, host_last_winners
from .tile_planes import _encode_host_tiles
from .tile_planner import plan_cols


def np_filter(mask: np.ndarray, col: np.ndarray, op: str, val) -> np.ndarray:
    """`mask` AND one pushed-down predicate over a host column."""
    if op == "=":
        return mask & (col == val)
    if op == "!=":
        return mask & (col != val)
    if op == "<":
        return mask & (col < val)
    if op == "<=":
        return mask & (col <= val)
    if op == ">":
        return mask & (col > val)
    if op == ">=":
        return mask & (col >= val)
    if op == "in":
        return mask & np.isin(col, list(val))
    if op == "not in":
        return mask & ~np.isin(col, list(val))
    return np.zeros_like(mask)


def _new_finals(per_col_aggs: dict, size: int) -> dict:
    """Zeroed [size] states: presence, and per column its count and the
    sum / min / max its aggregates read."""
    finals = {"__presence": {"count": np.zeros(size, np.int64)}}
    for col, aggs in per_col_aggs.items():
        d = finals.setdefault(col, {})
        for agg in sorted(aggs | {"count"}):
            if agg == "count":
                d["count"] = np.zeros(size, np.int64)
            elif agg in ("sum", "avg"):
                d.setdefault("sum", np.zeros(size, np.float64))
            elif agg == "min":
                d["min"] = np.full(size, np.inf)
            elif agg == "max":
                d["max"] = np.full(size, -np.inf)
    return finals


def _finish_avg(finals: dict, per_col_aggs: dict) -> None:
    """avg = sum / max(count, 1), as the device finalize divides."""
    for col, aggs in per_col_aggs.items():
        d = finals[col]
        if "avg" in aggs:
            cnt = d.get("count", finals["__presence"]["count"])
            d["avg"] = d["sum"] / np.maximum(cnt, 1)


def _per_col_aggs(plan) -> dict:
    out: dict[str, set] = {}
    for func, col in plan.agg_specs:
        out.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
    return out


def _mem_getter(mcols: dict, mnulls: dict):
    def get(name):
        if name not in mcols:
            return None
        return mcols[name], mnulls.get(name)
    return get


class HostRoutes:
    """The host fast path and the cold serve (see the module docstring).
    The host needs `self.cache` (TileCacheManager), `self.config`
    (QueryConfig), `self._assemble_result`, `self._group_key_columns` and
    `self._append_agg_columns`."""

    # the host fast path's slice bound, and the rows x value columns past
    # which a multi-key slice leaves it once its planes are warm
    _HOST_PATH_MAX_ROWS = 4 << 20
    _HOST_PATH_MAX_CELLS = 1 << 17
    # the cold serve's shape bounds: past _COLD_COMPACT_GROUPS groups the
    # legacy ladder declines and the fused one folds unique-compacted (at
    # most _COLD_COMPACT_MAX_ROWS rows); the fused ladder folds a source of
    # 2 x _COLD_PAR_ROWS rows or more in ranges of _COLD_PAR_ROWS on a pool
    _COLD_COMPACT_GROUPS = 1 << 22
    _COLD_PAR_ROWS = 1 << 23
    _COLD_COMPACT_MAX_ROWS = 1 << 26

    def host_execute(self, plan, dyn_host, super_entries, mem_slots, ctx, use_ts, pk,
                     value_cols, all_tag_cols, dedup_regions=frozenset(), hints=None):
        """The selective pk-equality fast path: the result table, or None
        when the shape or size does not qualify.  `hints` (a dict) gains
        `wide_cold` when a wide multi-key slice is served only because its
        planes are not resident."""
        if plan.group_tags or not pk:
            return None  # only scalar and bucket-grouped outputs
        if any(_FUNC_TO_KERNEL[f] == "last" for f, _ in plan.agg_specs):
            return None
        pk0 = pk[0]
        # pk0 equalities select row ranges; everything else is a residual
        # mask on the slice
        eq_codes: set[int] | None = None
        residual: list[tuple[str, str, object]] = []
        for (name, op, _arity), val in zip(plan.filters, dyn_host["filter_values"]):
            if name == pk0 and op == "=":
                codes = {int(val)}
                eq_codes = codes if eq_codes is None else (eq_codes & codes)
            elif name == pk0 and op == "in":
                codes = {int(v) for v in val}
                eq_codes = codes if eq_codes is None else (eq_codes & codes)
            elif name == pk0 and op == "!=":
                if eq_codes is not None:
                    eq_codes.discard(int(val))
                else:
                    residual.append((name, op, val))
            else:
                residual.append((name, op, val))
        if not eq_codes:
            return None
        for name, _op, _v in residual:
            if name != use_ts and name not in pk and name not in value_cols:
                return None

        n_buckets = plan.n_buckets if plan.bucket_col else 1
        origin = dyn_host["bucket_origin"]
        interval = dyn_host["bucket_interval"]
        # the pushed-down ts bounds: a single-pk run is ts-sorted, so two
        # more binary searches narrow it to the window
        ts_lo = ts_hi = None
        if use_ts:
            for (name, op, _a), val in zip(plan.filters, dyn_host["filter_values"]):
                if name != use_ts:
                    continue
                if op == ">=":
                    ts_lo = val if ts_lo is None else max(ts_lo, val)
                elif op == ">":
                    ts_lo = val + 1 if ts_lo is None else max(ts_lo, val + 1)
                elif op == "<":
                    ts_hi = val if ts_hi is None else min(ts_hi, val)
                elif op == "<=":
                    ts_hi = val + 1 if ts_hi is None else min(ts_hi, val + 1)

        # row ranges per (entry, code), and the slice's size
        ranges: list[tuple[object, int, int]] = []
        total = 0
        for entry in super_entries:
            if entry.order is None or pk0 not in entry.sorted_host:
                return None
            if use_ts and use_ts not in entry.sorted_host:
                return None
            arr = entry.sorted_host[pk0]
            ts_arr = entry.sorted_host[use_ts] if use_ts else None
            # one dtype-matched search for all codes
            codes_sorted = np.asarray(sorted(eq_codes), dtype=arr.dtype)
            lefts = np.searchsorted(arr, codes_sorted, side="left")
            rights = np.searchsorted(arr, codes_sorted, side="right")
            for a, b in zip(lefts.tolist(), rights.tolist()):
                if a >= b:
                    continue
                # ts is sorted within a pk run only when the pk is one column
                if ts_arr is not None and len(pk) == 1 and (ts_lo is not None
                                                            or ts_hi is not None):
                    run = ts_arr[a:b]
                    if ts_lo is not None:
                        a += int(np.searchsorted(run, ts_lo, side="left"))
                    if ts_hi is not None:
                        b = b - len(run) + int(np.searchsorted(run, ts_hi, side="left"))
                if a < b:
                    ranges.append((entry, a, b))
                    total += b - a
        if total > self._HOST_PATH_MAX_ROWS:
            return None

        per_col_aggs = _per_col_aggs(plan)
        # a wide multi-key slice leaves the host pass once its planes are
        # warm: the numpy pass grows with keys x columns on the caller's
        # thread, the warm tile dispatch does not
        plan_value_cols = [c for c in per_col_aggs if c != COUNT_STAR]
        if (len(eq_codes) > 1
                and total * max(len(plan_value_cols), 1) > self._HOST_PATH_MAX_CELLS):
            warm = super_entries and all(
                all(
                    c in e.cols or c in e.limb_cols
                    or any(c in wt["cols"] or c in wt["limbs"] for wt in e.window_tiles.values())
                    for c in plan_value_cols
                )
                for e in super_entries
            )
            if warm:
                passes.note(
                    "host_fast_path", False,
                    f"{len(eq_codes)}-key x {len(plan_value_cols)}-column "
                    "slice with warm device planes: tile dispatch beats "
                    "the contention-sensitive host pass",
                    keys=len(eq_codes), rows=total,
                )
                return None
            if hints is not None:
                hints["wide_cold"] = True

        finals = _new_finals(per_col_aggs, n_buckets)

        def accumulate(get_col, ts_arr, base_mask, n) -> bool:
            """Fold one slice into finals; False when a column is missing."""
            mask = base_mask
            for name, op, val in residual:
                if name == use_ts:
                    col = ts_arr
                else:
                    got = get_col(name)
                    if got is None:
                        return False
                    col, pres = got
                    if pres is not None:
                        mask = mask & pres
                mask = np_filter(mask, col, op, val)
            if plan.bucket_col is not None:
                bucket = ((ts_arr - origin) // interval).astype(np.int64)
                mask = mask & (bucket >= 0) & (bucket < n_buckets)
                bucket = np.clip(bucket, 0, n_buckets - 1)
            else:
                bucket = np.zeros(n, np.int64)
            if not mask.any():
                return True
            bsel = bucket[mask]
            finals["__presence"]["count"] += np.bincount(bsel, minlength=n_buckets).astype(np.int64)
            for col_name in per_col_aggs:
                if col_name == COUNT_STAR:
                    finals[col_name]["count"] += np.bincount(
                        bsel, minlength=n_buckets).astype(np.int64)
                    continue
                got = get_col(col_name)
                if got is None:
                    return False
                vals, pres = got
                cmask = mask if pres is None else (mask & pres)
                vsel = vals[cmask].astype(np.float64)
                bs = bucket[cmask]
                d = finals[col_name]
                if "count" in d:
                    d["count"] += np.bincount(bs, minlength=n_buckets).astype(np.int64)
                if "sum" in d:
                    d["sum"] += np.bincount(bs, weights=vsel, minlength=n_buckets)
                if "min" in d:
                    np.minimum.at(d["min"], bs, vsel)
                if "max" in d:
                    np.maximum.at(d["max"], bs, vsel)
            return True

        for entry, a, b in ranges:
            positions = entry.order[a:b].astype(np.int64)
            cache: dict[str, object] = {}

            def get_col(name, _entry=entry, _pos=positions, _a=a, _b=b, _cache=cache):
                if name not in _cache:
                    if name in _entry.sorted_host:
                        _cache[name] = (_entry.sorted_host[name][_a:_b], None)
                    else:
                        _cache[name] = self.cache.gather_host_values(_entry, name, _pos)
                return _cache[name]

            ts_arr = entry.sorted_host[use_ts][a:b] if use_ts else np.zeros(b - a, np.int64)
            base = np.ones(b - a, bool)
            if entry.region_id in dedup_regions:
                # last write wins: the keep plane the device path reads
                if not self.cache.ensure_dedup_keep(entry):
                    return None
                base &= entry.keep_host[a:b]
            if not accumulate(get_col, ts_arr, base, b - a):
                return None

        for _region, mem_table in mem_slots:
            need = list(dict.fromkeys(
                [pk0] + ([use_ts] if use_ts else []) + list(value_cols)
                + [n for n, _o, _v in residual if n in pk]
            ))
            if any(name not in mem_table.column_names for name in need):
                return None
            built = _encode_host_tiles(ctx.dictionary, mem_table, need, all_tag_cols + pk, use_ts)
            if built is None:
                return None
            mcols, mnulls, _e, _b = built
            sel = np.isin(mcols[pk0], list(eq_codes))
            ts_arr = mcols[use_ts] if use_ts else np.zeros(mem_table.num_rows, np.int64)
            if not accumulate(_mem_getter(mcols, mnulls), ts_arr, sel, mem_table.num_rows):
                return None

        _finish_avg(finals, per_col_aggs)
        return self._assemble_result(finals, plan, ctx, dyn_host)

    def host_cold_grouped(self, plan, dyn_host, super_entries, mem_slots, ctx, use_ts,
                          value_cols, all_tag_cols, dedup_regions, window, fused: bool = False):
        """The cold serve: a grouped aggregate answers from the host
        consolidation with no upload; None to decline.

        The legacy ladder (`fused` False): dense bincount folds over every
        row, once per entry while its planes are not resident; declines
        `last_value` and group spaces past `_COLD_COMPACT_GROUPS`.

        The fused ladder (`fused` True, a family's first touch): every
        family — `last_value` from run boundaries (group tags, no bucket),
        a group space past `_COLD_COMPACT_GROUPS` folded unique-compacted
        (ranges of `_COLD_PAR_ROWS` rows, at most `_COLD_COMPACT_MAX_ROWS`
        rows in all, stitched in ascending gid order), and a source of at
        least 2 x `_COLD_PAR_ROWS` rows over at most 2^20 groups folded in
        ranges of `_COLD_PAR_ROWS` rows on up to 4 threads, the partials
        merged in range order (the same bytes for any thread count)."""
        if not passes.enabled("cold_host_serve", self.config):
            return None
        kernels = {_FUNC_TO_KERNEL[f] for f, _ in plan.agg_specs}
        compact = plan.num_groups > self._COLD_COMPACT_GROUPS
        if "last" in kernels and not (fused and not compact and plan.bucket_col is None
                                      and plan.group_tags):
            return None
        if compact and not fused:
            return None
        need_cols = plan_cols(plan)
        win_bounds = (int(window[0]), int(window[1])) if window is not None else None
        cold_entries = []
        for entry in super_entries:
            if not fused:
                dedup = entry.region_id in dedup_regions
                wt = entry.window_tiles.get((*win_bounds, dedup)) if win_bounds else None
                wt_warm = wt is not None and all(
                    c in wt["cols"] or c in wt["limbs"] for c in need_cols)
                planes_warm = all(c in entry.cols or c in entry.limb_cols
                                  for c in need_cols if c != COUNT_STAR)
                if wt_warm or planes_warm:
                    return None  # the device path is warm: it wins
                if entry.cold_served:
                    return None  # second touch: the device planes build
            if entry.order is None:
                return None
            cold_entries.append(entry)
        if not cold_entries:
            # memtable-only sources: with no entry to carry the flag (or a
            # family build to warm) the route would answer forever and the
            # card never engage
            return None

        n_buckets = max(plan.n_buckets, 1) if plan.bucket_col else 1
        origin = dyn_host["bucket_origin"]
        interval = dyn_host["bucket_interval"]
        num_groups = plan.num_groups
        per_col_aggs = _per_col_aggs(plan)
        # dense [G] states, never in compact mode (num_groups is then a
        # hash-scale bound the compacted fold exists to avoid allocating)
        finals = {} if compact else _new_finals(per_col_aggs, num_groups)
        filters = list(zip(plan.filters, dyn_host["filter_values"]))
        # the state keys each column's aggregates need
        want_aggs: dict[str, set] = {}
        for col, aggs in per_col_aggs.items():
            want_aggs[col] = {"count"} | {"sum" if a in ("sum", "avg") else a
                                          for a in aggs if a != "count"}
        # last_value's dense states: each group's (ts, value, has) winner,
        # merged in source and range order, a ts tie going to the later
        last_cols = [c for c, aggs in per_col_aggs.items() if "last" in aggs]
        last_state = {c: (np.full(num_groups, np.iinfo(np.int64).min, np.int64),
                          np.full(num_groups, np.nan), np.zeros(num_groups, bool))
                      for c in last_cols}
        bail = object()

        def merge_last(col_name, w) -> None:
            wg, wt, wv = w
            if not len(wg):
                return
            lt, lv, lh = last_state[col_name]
            take = (~lh[wg]) | (wt >= lt[wg])
            tg = wg[take]
            lt[tg] = wt[take]
            lv[tg] = wv[take]
            lh[tg] = True

        def fold_range(get_col, ts_arr, keep, a, b, part=None):
            """Fold rows [a, b) of one source.  With `part` None (and not
            compact) into the finals in place — the legacy fold's order of
            operations; else into a fresh partial (dense, or
            unique-compacted with its keys) that the caller merges in range
            order.  `bail` when the source cannot serve (an evicted host
            encode, a code outside its dimension, unsorted rows past the
            last_value lexsort cap)."""
            ts_r = ts_arr[a:b]
            if window is not None and use_ts:
                mask = (ts_r >= window[0]) & (ts_r < window[1])
            else:
                mask = np.ones(b - a, bool)
            if keep is not None:
                mask = mask & keep[a:b]
            for (name, op, _a), val in filters:
                if name == use_ts:
                    col = ts_r
                else:
                    got = get_col(name)
                    if got is None:
                        return bail
                    col, pres = got
                    col = col[a:b]
                    if pres is not None:
                        mask = mask & pres[a:b]
                mask = np_filter(mask, col, op, val)
            if not mask.any():
                return {}
            idx = np.flatnonzero(mask)
            if a:
                idx = idx + a
            gid = np.zeros(len(idx), np.int64)
            for tag, card in zip(plan.group_tags, plan.tag_cards):
                got = get_col(tag)
                if got is None:
                    return bail
                codes = got[0][idx]
                if (codes < 0).any() or (codes >= card).any():
                    return bail  # an out-of-range code: the device path owns it
                gid = gid * card + codes.astype(np.int64)
            if plan.bucket_col is not None:
                bucket = ((ts_arr[idx] - origin) // interval).astype(np.int64)
                if (bucket < 0).any() or (bucket >= n_buckets).any():
                    in_b = (bucket >= 0) & (bucket < n_buckets)
                    idx, gid, bucket = idx[in_b], gid[in_b], bucket[in_b]
                gid = gid * n_buckets + bucket
            inplace = part is None and not compact
            if part is None:
                part = {}
            part["rows"] = len(gid)
            if compact:
                ukeys, gid = np.unique(gid, return_inverse=True)
                part["keys"] = ukeys
                size = len(ukeys)
            else:
                size = num_groups
            pb = np.bincount(gid, minlength=size).astype(np.int64)
            if inplace:
                finals["__presence"]["count"] += pb
            else:
                part["presence"] = pb
            cols_part = part["cols"] = {}
            for col_name in per_col_aggs:
                want = want_aggs[col_name]
                if col_name == COUNT_STAR:
                    if inplace:
                        finals[col_name]["count"] += pb
                    else:
                        cols_part[col_name] = {"count": pb}
                    continue
                got = get_col(col_name)
                if got is None:
                    return bail
                vals, pres = got
                vsel = vals[idx].astype(np.float64)
                g = gid
                sel = None
                if pres is not None:
                    sel = pres[idx]
                else:
                    nan = np.isnan(vsel)
                    if nan.any():  # NULLs decoded as NaN must not fold in
                        sel = ~nan
                if sel is not None:
                    vsel, g = vsel[sel], g[sel]
                d: dict = finals[col_name] if inplace else {}
                cb = np.bincount(g, minlength=size).astype(np.int64)
                if inplace:
                    d["count"] += cb
                else:
                    d["count"] = cb
                if "sum" in want:
                    sb = np.bincount(g, weights=vsel, minlength=size)
                    if inplace:
                        d["sum"] += sb
                    else:
                        d["sum"] = sb
                for agg, fill, ufunc in (("min", np.inf, np.minimum), ("max", -np.inf, np.maximum)):
                    if agg in want:
                        if not inplace:
                            d[agg] = np.full(size, fill)
                        ufunc.at(d[agg], g, vsel)
                if "last" in want:
                    t_sel = ts_arr[idx]
                    if sel is not None:
                        t_sel = t_sel[sel]
                    w = host_last_winners(g, t_sel, vsel)
                    if w is None:
                        return bail
                    if inplace:
                        merge_last(col_name, w)
                    else:
                        d["last"] = w
                if not inplace:
                    cols_part[col_name] = d
            return part

        def merge_dense(part) -> None:
            """Fold one range's partial into the finals (called in source
            and range order)."""
            if not part:
                return
            finals["__presence"]["count"] += part["presence"]
            for col_name, d in part["cols"].items():
                tgt = finals[col_name]
                if "count" in d and "count" in tgt:
                    tgt["count"] += d["count"]
                if "sum" in d:
                    tgt["sum"] += d["sum"]
                if "min" in d:
                    np.minimum(tgt["min"], d["min"], out=tgt["min"])
                if "max" in d:
                    np.maximum(tgt["max"], d["max"], out=tgt["max"])
                if "last" in d:
                    merge_last(col_name, d["last"])

        parts_compact: list = []
        compact_rows = [0]

        def fold_source(get_col, ts_arr, keep, n, parallel_ok) -> bool:
            """Fold one whole source; False declines."""
            step = self._COLD_PAR_ROWS
            if compact:
                for a in range(0, max(n, 1), step):
                    part = fold_range(get_col, ts_arr, keep, a, min(a + step, n), part={})
                    if part is bail:
                        return False
                    if part.get("rows"):
                        compact_rows[0] += part["rows"]
                        if compact_rows[0] > self._COLD_COMPACT_MAX_ROWS:
                            return False  # too many rows to fold compacted
                        parts_compact.append(part)
                return True
            if fused and parallel_ok and n >= 2 * step and num_groups <= (1 << 20):
                # ranges on a small pool (numpy releases the GIL), the
                # shared columns fetched first on this thread so the
                # workers find them cached
                prefetch = list(dict.fromkeys(
                    [f[0][0] for f in filters if f[0][0] != use_ts] + list(plan.group_tags)
                    + [c for c in per_col_aggs if c != COUNT_STAR]))
                for name in prefetch:
                    if get_col(name) is None:
                        return False
                ranges = [(a, min(a + step, n)) for a in range(0, n, step)]
                workers = min(4, os.cpu_count() or 1, len(ranges))
                with ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="cold-serve") as pool:
                    parts = list(pool.map(
                        lambda r: fold_range(get_col, ts_arr, keep, *r, part={}), ranges))
                if any(p is bail for p in parts):
                    return False
                for p in parts:
                    merge_dense(p)
                return True
            return fold_range(get_col, ts_arr, keep, 0, n) is not bail

        for entry in cold_entries:
            if use_ts and use_ts not in entry.sorted_host:
                return None
            n = entry.num_rows
            ts_arr = np.asarray(entry.sorted_host[use_ts]) if use_ts else np.zeros(n, np.int64)
            keep = None
            if entry.region_id in dedup_regions:
                if not self.cache.ensure_dedup_keep(entry):
                    return None
                keep = entry.keep_host
            col_cache: dict[str, object] = {}

            def get_col(name, _e=entry, _cache=col_cache, _n=n):
                if name not in _cache:
                    if name in _e.sorted_host:
                        _cache[name] = (np.asarray(_e.sorted_host[name])[:_n], None)
                    else:
                        _cache[name] = self.cache.gather_host_values(
                            _e, name, np.asarray(_e.order, np.int64))
                return _cache[name]

            if not fold_source(get_col, ts_arr, keep, n, True):
                return None

        for _region, mem_table in mem_slots:
            need = list(dict.fromkeys(
                list(plan.group_tags) + ([use_ts] if use_ts else [])
                + [c for c in value_cols if c in need_cols]
            ))
            if any(name not in mem_table.column_names for name in need):
                return None
            built = _encode_host_tiles(ctx.dictionary, mem_table, need, all_tag_cols, use_ts)
            if built is None:
                return None
            mcols, mnulls, _e, _b = built
            n = mem_table.num_rows
            ts_arr = mcols[use_ts] if use_ts else np.zeros(n, np.int64)
            if not fold_source(_mem_getter(mcols, mnulls), ts_arr, None, n, False):
                return None

        for entry in cold_entries:
            entry.cold_served = True
        if compact:
            return self._stitch_compact(parts_compact, per_col_aggs, want_aggs, plan, ctx,
                                        dyn_host)
        _finish_avg(finals, per_col_aggs)
        for col in last_cols:
            finals[col]["last"] = last_state[col][1]
        return self._assemble_result(finals, plan, ctx, dyn_host)

    def _stitch_compact(self, parts, per_col_aggs, want_aggs, plan, ctx, dyn_host):
        """The unique-compacted partials of a hash-scale group space as one
        result, rows in ascending gid order (the hash assembly's order;
        empty groups never exist)."""
        allk = (np.unique(np.concatenate([p["keys"] for p in parts])) if parts
                else np.zeros(0, np.int64))
        finals = _new_finals({c: {a for a in want_aggs[c] if a != "count"}
                              for c in per_col_aggs}, len(allk))
        for p in parts:
            pos = np.searchsorted(allk, p["keys"])
            finals["__presence"]["count"][pos] += p["presence"]
            for col_name, d in p["cols"].items():
                tgt = finals[col_name]
                if "count" in d and "count" in tgt:
                    tgt["count"][pos] += d["count"]
                if "sum" in d:
                    tgt["sum"][pos] += d["sum"]
                if "min" in d:
                    tgt["min"][pos] = np.minimum(tgt["min"][pos], d["min"])
                if "max" in d:
                    tgt["max"][pos] = np.maximum(tgt["max"][pos], d["max"])
        _finish_avg(finals, per_col_aggs)
        nz = np.flatnonzero(finals["__presence"]["count"] > 0)
        cols = self._group_key_columns(plan, ctx, dyn_host, allk[nz])
        return pa.table(self._append_agg_columns(cols, finals, plan, nz))
