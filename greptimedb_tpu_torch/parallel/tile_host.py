"""The tile path's host routes: answers taken from the host consolidation,
before the card is chosen.

Counterpart of the host section of `greptimedb_tpu/parallel/tile_cache.py`
(`TileExecutor._host_execute`, the `fused=False` branch of
`_host_cold_grouped`, the `_HOST_PATH_*` / `_COLD_COMPACT_GROUPS`
bounds, `_np_filter`).  `TileExecutor` (parallel/tile_executor.py) mixes
`HostRoutes` in and calls its two routes after the plan is built and
before any plane is uploaded:

* `host_execute` (the `host_fast_path` pass): a pk-equality aggregate
  with no group tags (scalar or time-bucketed) binary-searches each pk
  code's run in the (pk, ts)-sorted host copies, narrows a single-pk
  run by the ts window, and folds the slice with numpy (bincount,
  minimum.at, maximum.at), memtable tails included.  It declines a slice
  over `_HOST_PATH_MAX_ROWS` rows, and a multi-key slice over
  `_HOST_PATH_MAX_CELLS` rows x value columns once every value column is
  resident on the card (the warm tile dispatch takes it);
* `host_cold_grouped` (the `cold_host_serve` pass, the reference's
  legacy ladder): a grouped aggregate whose planes are not resident
  answers once per entry (`_SuperTiles.cold_served`) with dense bincount
  folds over the whole consolidation; the next query builds the planes.
  It declines `last_value`, group spaces past `_COLD_COMPACT_GROUPS`,
  warm planes or a warm window tile, and memtable-only sources.

Both build the [G] finals the device decode builds and assemble them with
the executor's `_assemble_result`, so a host answer and a card answer of
the same query are the same bytes up to the accumulation order.  They
never catch an error: a route either declines (returns None) before the
device path is chosen, or answers.  The bounds are class attributes, so a
test may lower them on an executor instance.

Not carried over: the fused ladder (`last_value` from run boundaries,
unique-compacted hash-scale spaces, chunk-parallel folds, the background
family build the `wide_cold` hint schedules), persisted consolidations.
"""

from __future__ import annotations

import numpy as np

from ..query import passes
from .executor import COUNT_STAR, _FUNC_TO_KERNEL
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
    """The host fast path and the legacy cold serve (see the module
    docstring).  The host needs `self.cache` (TileCacheManager),
    `self.config` (QueryConfig) and `self._assemble_result`."""

    # the host fast path's slice bound, and the rows x value columns past
    # which a multi-key slice leaves it once its planes are warm
    _HOST_PATH_MAX_ROWS = 4 << 20
    _HOST_PATH_MAX_CELLS = 1 << 17
    # past this many groups the cold serve declines (the reference's fused
    # ladder folds such spaces unique-compacted)
    _COLD_COMPACT_GROUPS = 1 << 22

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
                          value_cols, all_tag_cols, dedup_regions, window):
        """The legacy cold serve: a grouped aggregate whose planes are not
        resident answers from the host consolidation (dense bincount folds
        over every row, no upload) once per entry; None to decline."""
        if not passes.enabled("cold_host_serve", self.config):
            return None
        if any(_FUNC_TO_KERNEL[f] == "last" for f, _ in plan.agg_specs):
            return None
        if plan.num_groups > self._COLD_COMPACT_GROUPS:
            return None
        need_cols = plan_cols(plan)
        win_bounds = (int(window[0]), int(window[1])) if window is not None else None
        cold_entries = []
        for entry in super_entries:
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
            # memtable-only sources: with no entry to carry the flag the
            # route would answer forever and the card never engage
            return None

        n_buckets = max(plan.n_buckets, 1) if plan.bucket_col else 1
        origin = dyn_host["bucket_origin"]
        interval = dyn_host["bucket_interval"]
        num_groups = plan.num_groups
        per_col_aggs = _per_col_aggs(plan)
        finals = _new_finals(per_col_aggs, num_groups)
        filters = list(zip(plan.filters, dyn_host["filter_values"]))

        def fold(get_col, ts_arr, keep, n) -> bool:
            """Fold every row of one source into finals; False when the
            source cannot serve (an evicted host encode, a code outside its
            dimension)."""
            if window is not None and use_ts:
                mask = (ts_arr >= window[0]) & (ts_arr < window[1])
            else:
                mask = np.ones(n, bool)
            if keep is not None:
                mask = mask & keep
            for (name, op, _a), val in filters:
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
            if not mask.any():
                return True
            idx = np.flatnonzero(mask)
            gid = np.zeros(len(idx), np.int64)
            for tag, card in zip(plan.group_tags, plan.tag_cards):
                got = get_col(tag)
                if got is None:
                    return False
                codes = got[0][idx]
                if (codes < 0).any() or (codes >= card).any():
                    return False  # an out-of-range code: the device path owns it
                gid = gid * card + codes.astype(np.int64)
            if plan.bucket_col is not None:
                bucket = ((ts_arr[idx] - origin) // interval).astype(np.int64)
                if (bucket < 0).any() or (bucket >= n_buckets).any():
                    in_b = (bucket >= 0) & (bucket < n_buckets)
                    idx, gid, bucket = idx[in_b], gid[in_b], bucket[in_b]
                gid = gid * n_buckets + bucket
            pb = np.bincount(gid, minlength=num_groups).astype(np.int64)
            finals["__presence"]["count"] += pb
            for col_name, aggs in per_col_aggs.items():
                if col_name == COUNT_STAR:
                    finals[col_name]["count"] += pb
                    continue
                got = get_col(col_name)
                if got is None:
                    return False
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
                d = finals[col_name]
                d["count"] += np.bincount(g, minlength=num_groups).astype(np.int64)
                if aggs & {"sum", "avg"}:
                    d["sum"] += np.bincount(g, weights=vsel, minlength=num_groups)
                if "min" in aggs:
                    np.minimum.at(d["min"], g, vsel)
                if "max" in aggs:
                    np.maximum.at(d["max"], g, vsel)
            return True

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

            if not fold(get_col, ts_arr, keep, n):
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
            if not fold(_mem_getter(mcols, mnulls), ts_arr, None, n):
                return None

        _finish_avg(finals, per_col_aggs)
        for entry in cold_entries:
            entry.cold_served = True
        return self._assemble_result(finals, plan, ctx, dyn_host)
