"""Warm TQL path: PromQL range-vector evaluation over the device-resident
super-tile planes.

Counterpart of `greptimedb_tpu/query/promql/tile_exec.py`.
The legacy `PromqlEngine._fetch` rescans the region, re-encodes and
re-uploads the samples on every query; here a query over a table whose
planes (tag codes, ts, value, present mask, valid or dedup keep plane) are
resident runs one program (`tql_program`):

  per region  K9 (rate/increase) and K10 over the planes in place — the
              row prologue (fetch bound, matcher code masks, mixed-radix
              series id, native unit -> ms + offset) fused in;
  then        K11: the selection merge of the series-disjoint regions and
              the range function, NaN where undefined;
  then        K12 when a by-label sum/avg/min/max/count is fused in;

and reads back only the [series_out, steps] or [groups, steps] result.

Routing (the `tql_tile` pass, switch `tql.tile`):

  warm     every region's needed planes are resident -> one program;
  cold     under the fused build (`tile.fused_build` and its pass) a
           family's first touch declines: the legacy path answers it and
           the family's build is queued on the SQL executor's background
           builder (one union build of the table's manifests, then a ghost
           run of the query, which builds what the union missed), counted
           in `tql_tile_cold_serves`; a query of a family whose build is
           in flight waits for it.  The statement's other evaluations
           (a by-label query's per-series one) then take the legacy path
           too.  A known family gone stale (a flush),
           or any family with the fused build off, builds its planes
           synchronously first;
  decline  a shape the tile path does not express — memtable rows in the
           fetch window, tombstones, a file that cannot tile, the
           `tql.max_cells` bound, last_non_null merge mode, an empty grid
           — goes to the legacy path (which also runs on the card) and is
           counted in `tql_tile_declined`.  Anything else raises: unlike
           the reference (`except Exception` -> legacy), a kernel, build or
           launch failure is never hidden behind the legacy answer.

Non-append tables (GreptimeDB dedups Prometheus remote-write tables on
(labels, ts)) whose SSTs overlap in time are served through the dedup
keep plane (`TileCacheManager.ensure_dedup_keep`).  A flush that appends
files extends the entry in place (K16), and a dictionary growth that
moved codes is repaired in place (`repair_super`, K15 remap), as on the
SQL tile path.

Parity with the legacy path: per-series *_over_time, delta, instant
vectors, matchers and the by-label folds equal it on one-region tables
(same kernels, same sample sequence, same f64 order: K12 and the host
`np.add.at` fold both add series in dictionary-code order); rate and
increase over series with counter resets, and float sums folded across
regions, within the last ulp.

With `tile.mesh_devices` > 0 and more than one region, each region's
K9/K10 run on its co-located mesh slot and K11/K12 on the first slot
(`tql_program` over the mesh, the reference's `_mesh_dispatch`,
`_partial_program` and `_merge_program`), counted in the engine's
`mesh_dispatches`.

Not ported: the flight recorder, tracing spans, fault points and the
degrade counters.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from ...ops.rate import (
    RangeGrid,
    RowSource,
    range_finalize,
    range_windows,
    series_fold,
    strip_counter_resets,
)
from ...parallel.mesh import region_device_index
from ...parallel.tile_executor import in_fused_build
from ...parallel.tile_planes import PlaneManifest
from ...parallel.tile_program import on_device
from .. import passes
from ..logical_plan import TableScan

_RATE_KINDS = ("rate", "increase")

def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class _Ineligible(Exception):
    """A query or table shape the tile path does not express: the legacy
    path answers it."""


class _ColdServe(Exception):
    """A family's first touch under the fused build: its build is queued,
    the legacy path answers this evaluation."""


def region_stats(src: RowSource, grid: RangeGrid, func: str):
    """One region's part of the program: K9 (rate/increase) and K10 over
    its planes, on the planes' device.  Returns (WindowStats, [S] presence)."""
    adjusted = layout = None
    if func in ("rate", "increase"):
        adjusted, layout = strip_counter_resets(src)
    return range_windows(src, grid, values=adjusted, layout=layout)


def merge_program(stats: list, grid: RangeGrid, func: str, agg_op=None, fold=None):
    """K11 over the regions' stats in region order (the selection merge of
    series-disjoint regions), then K12 when `agg_op` is fused (`fold` = the
    group CSR (offsets, members)).  Returns [S, W] or [G, W] f64."""
    mat = range_finalize(stats, grid, func).view(grid.num_series, grid.n_steps)
    if agg_op is not None:
        offsets, members = fold
        mat = series_fold(mat, offsets, members, agg_op)
    return mat


def _source_on(src: RowSource, dev) -> RowSource:
    """`src` with its planes on `dev` (itself when they already are)."""
    if src.device == dev:
        return src

    def move(chunks):
        return None if chunks is None else [c.to(dev) for c in chunks]

    return dataclasses.replace(
        src, ts=move(src.ts), values=move(src.values), nulls=move(src.nulls),
        valid=move(src.valid), codes=tuple(move(c) for c in src.codes),
        masks=tuple((ti, m.to(dev)) for ti, m in src.masks))


def _stats_on(st, dev):
    return type(st)(**{f.name: getattr(st, f.name).to(dev) for f in dataclasses.fields(st)})


def tql_program(sources: list[RowSource], region_ids, devices, grid: RangeGrid, func: str,
                agg_op=None, fold=None):
    """The warm program: per region K9 (rate/increase) and K10 on the
    region's slot of `devices` (`region_device_index`; one slot: all on
    it), then on the first slot K11 over all regions in region order, and
    K12 when `agg_op` is fused.  Returns ([S, W] or [G, W] f64, the
    per-region [S] presence bools).  Over several slots this is the
    reference's `_mesh_dispatch`: the same bytes as over one."""
    dev0 = devices[0]
    stats, presence = [], []
    for src, rid in zip(sources, region_ids):
        dev = devices[region_device_index(rid, len(devices))]
        with on_device(dev):
            st, pres = region_stats(_source_on(src, dev), grid, func)
        stats.append(_stats_on(st, dev0))
        presence.append(pres.to(dev0))
    with on_device(dev0):
        return merge_program(stats, grid, func, agg_op, fold), presence


class TqlTileExecutor:
    """Routes one range-function evaluation through the device tile cache.
    Built per PromqlEngine (cheap); the planes live in the query engine's
    tile cache, the group CSRs of the fused folds on the cache."""

    def __init__(self, db):
        self.db = db
        self.qe = db.query_engine
        self.cache = self.qe.tile_executor().cache
        # a family's first touch was cold-served in this statement: its
        # other evaluations (a by-label query's per-series one) stay on the
        # legacy path, so one statement takes one route and never races
        # the build it queued
        self.cold_statement = False

    # ---- public entry ------------------------------------------------------
    def try_range_eval(self, func, sel, range_ms, start, end, step, agg=None):
        """Evaluate `func` over sel[range_ms] on the grid start..end@step
        (ms) from the resident planes; `agg` fuses a by-label aggregation
        (op, by_labels|None, without_labels|None).  Returns an engine
        Matrix, or None when the tile path declines (the legacy path then
        answers)."""
        if not self.db.config.tql.tile:
            return None
        if not passes.enabled("tql_tile", self.db.config.query):
            return None
        ghost = in_fused_build()
        if self.cold_statement and not ghost:
            passes.note("tql_tile", False, "cold statement: legacy scan path")
            return None
        try:
            out = self._attempt(func, sel, range_ms, start, end, step, agg)
        except _ColdServe:
            self.cold_statement = True
            self.qe.stats.add(tql_tile_cold_serves=1)
            return None
        except _Ineligible:
            if not ghost:
                self.qe.stats.add(tql_tile_declined=1)
            return None
        if not ghost:
            self.qe.stats.add(tql_tile_dispatches=1)
        return out

    def _add_ms(self, stage: str, t0: float) -> None:
        timings = self.qe.last_tql_timings
        timings[stage] = timings.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3

    # ---- attempt -----------------------------------------------------------
    def _attempt(self, func, sel, range_ms, start, end, step, agg):
        t0 = time.perf_counter()
        db = self.db
        meta = db.catalog.table(sel.metric, db.current_database)
        schema = meta.schema
        if schema.time_index is None:
            raise _Ineligible("metric table has no time index")
        ts_name = schema.time_index.name
        tags = [c.name for c in schema.tag_columns()]
        fields = schema.field_columns()
        value_col = None
        for cand in ("greptime_value", "value", "val"):
            if any(f.name == cand for f in fields):
                value_col = cand
                break
        if value_col is None:
            if len(fields) != 1:
                raise _Ineligible(f"metric has {len(fields)} fields; expected one")
            value_col = fields[0].name

        steps = np.arange(start, end + 1, step, dtype=np.int64)
        if len(steps) == 0:
            raise _Ineligible("empty evaluation grid")

        # matcher split — the legacy `_fetch` semantics, on dictionary-code
        # masks
        eq_matchers, regex_matchers = [], []
        for mt in sel.matchers:
            if mt.label not in tags:
                if mt.op in ("=", "=~"):
                    # legacy: equality on a non-existent label matches no series
                    return _empty_matrix(tags, agg, steps)
                continue  # != / !~ on a missing label: matches everything
            (eq_matchers if mt.op in ("=", "!=") else regex_matchers).append(mt)

        ctx = db._tile_context(TableScan(table=sel.metric, database=db.current_database))
        if ctx is None:
            raise _Ineligible("table source cannot tile")
        if not ctx.regions:
            raise _Ineligible("no regions")
        if any(getattr(r, "merge_mode", "last_row") == "last_non_null"
               for r in ctx.regions) and not ctx.append_mode:
            raise _Ineligible("last_non_null merge mode")

        # fetch bounds: the scan's time_range semantics in the native unit
        unit_ns = schema.time_index.data_type.timestamp_unit_ns()
        offset = sel.offset_ms
        lo_nat = (start - range_ms - offset) * 1_000_000 // unit_ns
        hi_nat = (end - offset) * 1_000_000 // unit_ns + 1

        executor = self.qe.tile_executor()
        fused = executor._fused_enabled() and not in_fused_build()
        fp = self._family_fp(ctx, value_col, func, agg, eq_matchers, regex_matchers)
        if fused:
            # before the table lock, which the builder takes
            executor._fused_join(fp)
        dictionary = ctx.dictionary
        pinned = []
        with dictionary.table_lock:
            try:
                items = self._acquire_regions(ctx, lo_nat, hi_nat, ts_name, pinned)
                self._add_ms("acquire", t0)
                if not all(self._warm_entry(s, tags, ts_name, value_col) for s in items):
                    if fused and executor.fused_first_touch_fp(fp):
                        # the family's first touch: the legacy scan answers
                        # now, the planes build in the background
                        self._schedule_build(executor, fp, ctx, schema, items, value_col,
                                             ts_name, (func, sel, range_ms, start, end, step,
                                                       agg))
                        passes.note("tql_tile", False,
                                    "cold: served from the legacy scan; background family "
                                    "build scheduled", cold=True)
                        raise _ColdServe()
                    # a known family gone stale (a flush), the fused build
                    # off, or the ghost run itself: build synchronously
                    self._build_sync(ctx, schema, items, value_col, ts_name, lo_nat, hi_nat)
                    items = self._acquire_regions(ctx, lo_nat, hi_nat, ts_name, pinned)
                    if not all(self._warm_entry(s, tags, ts_name, value_col) for s in items):
                        raise _Ineligible("planes did not build")
                # the code planes a dictionary growth moved: one K15 remap each
                self.cache.repair_super([s["entry"] for s in items], dictionary, tags)
                return self._dispatch(
                    func, agg, items, dictionary, tags, ts_name, value_col, unit_ns,
                    offset, lo_nat, hi_nat, start, step, steps, range_ms,
                    eq_matchers, regex_matchers,
                )
            finally:
                for r in pinned:
                    r.unpin_scan()

    # ---- region acquisition ------------------------------------------------
    def _acquire_regions(self, ctx, lo_nat, hi_nat, ts_name, pinned):
        """Per region: snapshot, eligibility gates and the cached entry for
        the current file set.  Returns [{region, metas, entry|None,
        dedup}]; raises _Ineligible on shapes the tile path must not
        serve."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from ...storage.region import OP_COL

        out = []
        for region in ctx.regions:
            if region not in pinned:
                region.pin_scan()
                pinned.append(region)
            metas, mems, version = region.tile_snapshot()
            self.cache.invalidate_region_if_changed(
                region.region_id, {m.file_id for m in metas}, version)
            ranges = []
            for m in metas:
                flo, fhi = m.time_range
                if fhi >= lo_nat and flo < hi_nat:
                    if m.num_deletes != 0:
                        raise _Ineligible("tombstones in the fetch window")
                    ranges.append((flo, fhi))
            # memtable rows in the fetch window: the legacy scan would merge
            # them; the planes cover flushed files only
            for mem in mems:
                mem_table = mem.scan(None, dedup=not ctx.append_mode)
                if mem_table.num_rows == 0:
                    continue
                if ts_name not in mem_table.column_names:
                    raise _Ineligible("memtable rows without a time index")
                ts_i = pc.cast(mem_table[ts_name], pa.int64())
                mlo, mhi = pc.min(ts_i).as_py(), pc.max(ts_i).as_py()
                if mhi >= lo_nat and mlo < hi_nat:
                    raise _Ineligible("memtable rows in the fetch window")
                if OP_COL in mem_table.column_names:
                    raise _Ineligible("memtable delete markers")
            dedup = (not ctx.append_mode) and not _disjoint_ranges(ranges)
            entry = self.cache._super.get(region.region_id)
            if entry is not None and set(entry.file_ids) != {m.file_id for m in metas}:
                entry = None
            out.append({"region": region, "metas": metas, "entry": entry, "dedup": dedup})
        return out

    def _warm_entry(self, item, tags, ts_name, value_col) -> bool:
        """True when every plane this query needs is resident."""
        entry = item["entry"]
        if entry is None or entry.valid is None:
            return False
        if any(c not in entry.cols for c in list(tags) + [ts_name, value_col]):
            return False
        return not (item["dedup"] and entry.valid_dedup is None)

    def _family_fp(self, ctx, value_col, func, agg, eq_matchers, regex_matchers) -> tuple:
        """The family of an evaluation without its literals: the matchers'
        (label, op) structure stays, their values and the window do not,
        so a dashboard swapping a host or sliding its window stays warm."""
        structure = tuple(sorted((m.label, m.op) for m in eq_matchers + regex_matchers))
        agg_fp = None if agg is None else (
            agg[0], None if agg[1] is None else tuple(agg[1]),
            None if agg[2] is None else tuple(agg[2]))
        return (ctx.table_key, ctx.append_mode,
                ("tql", value_col, func in _RATE_KINDS, structure, agg_fp))

    @staticmethod
    def _manifest(ctx, schema, value_col, ts_name, dedup) -> PlaneManifest:
        return PlaneManifest(table_key=ctx.table_key,
                             tag_cols=tuple(c.name for c in schema.tag_columns()),
                             ts_col=ts_name, value_cols=(value_col,), dedup=dedup)

    def _schedule_build(self, executor, fp, ctx, schema, items, value_col, ts_name, args):
        """Queue the family's build: the union build of the table's
        manifests, then this evaluation again as the ghost run (inside the
        builder's scope: it builds what is missing and runs the program)."""
        manifest = self._manifest(ctx, schema, value_col, ts_name,
                                  any(s["dedup"] for s in items))
        executor.fused_schedule_custom(fp, manifest, ctx, schema,
                                       lambda: self.try_range_eval(*args))

    def _build_sync(self, ctx, schema, items, value_col, ts_name, lo_nat, hi_nat):
        """Build (or complete) each region's planes and, where its files
        overlap, the dedup keep plane; host ms go to `build`, `upload` and
        `keep`."""
        pk = [c.name for c in schema.tag_columns()]
        pinned_ids = {r.region_id for r in ctx.regions}
        for item in items:
            if self._warm_entry(item, pk, ts_name, value_col):
                continue
            timings: dict[str, float] = {}
            entry, excluded = self.cache.super_tiles(
                item["region"], ctx.dictionary, item["metas"], pk, ts_name,
                [value_col], pinned_ids, pk, timings=timings,
            )
            for stage, ms in timings.items():
                self.qe.last_tql_timings[stage] = self.qe.last_tql_timings.get(stage, 0.0) + ms
            if entry is None or any(
                fhi >= lo_nat and flo < hi_nat for flo, fhi in (m.time_range for m in excluded)
            ):
                raise _Ineligible("region cannot tile")
            if item["dedup"]:
                t0 = time.perf_counter()
                if not self.cache.ensure_dedup_keep(entry):
                    raise _Ineligible("dedup keep plane unavailable")
                self._add_ms("keep", t0)
            item["entry"] = entry

    # ---- dispatch ----------------------------------------------------------
    def _dispatch(self, func, agg, items, dictionary, tags, ts_name, value_col, unit_ns,
                  offset, lo_nat, hi_nat, start, step, steps, range_ms,
                  eq_matchers, regex_matchers):
        t0 = time.perf_counter()
        cfg = self.db.config
        for item in items:
            if not self._warm_entry(item, tags, ts_name, value_col):
                raise _Ineligible("needed planes not resident")

        # --- geometry (pow2, as the reference's shape buckets) ---
        cards = [max(dictionary.cardinality(t), 1) for t in tags]
        radices = tuple(_pow2(c) for c in cards)
        s_pad = 1
        for r in radices:
            s_pad *= r
        w = len(steps)
        w_pad = _pow2(w)
        k = _pow2(max(-(-range_ms // step), 1))
        if s_pad * w_pad > int(cfg.tql.max_cells):
            raise _Ineligible(f"series*steps cells {s_pad}x{w_pad} exceed tql.max_cells")

        # --- matcher masks ([card_pad] bools per filtered tag) ---
        mask_arrays: dict[int, np.ndarray] = {}

        def mask_for(ti):
            if ti not in mask_arrays:
                m = np.zeros(radices[ti], dtype=bool)
                m[: cards[ti]] = True
                mask_arrays[ti] = m
            return mask_arrays[ti]

        for mt in eq_matchers:
            ti = tags.index(mt.label)
            m = mask_for(ti)
            code = dictionary.code_of(mt.label, mt.value)
            if mt.op == "=":
                sel_mask = np.zeros(len(m), dtype=bool)
                if code >= 0:
                    sel_mask[code] = True
                mask_arrays[ti] = m & sel_mask
            else:  # != — scan-filter semantics: null rows do not match
                if code >= 0:
                    m[code] = False
                nc = _null_code(dictionary, mt.label)
                if nc >= 0:
                    m[nc] = False
        for mt in regex_matchers:
            ti = tags.index(mt.label)
            m = mask_for(ti)
            pat = re.compile(mt.value)
            values = dictionary.values(mt.label)
            rx = np.zeros(len(m), dtype=bool)
            for code, v in enumerate(values):
                rx[code] = bool(pat.fullmatch(v if v is not None else ""))
            if mt.op == "!~":
                rx[: len(values)] = ~rx[: len(values)]
            mask_arrays[ti] = m & rx

        # --- fused aggregation structure ---
        agg_op = None
        keep: list[str] = []
        keep_idx: list[int] = []
        if agg is not None:
            agg_op, by, without = agg
            if by is not None:
                keep = [lbl for lbl in by if lbl in tags]
            elif without is not None:
                keep = [lbl for lbl in tags if lbl not in without]
            keep_idx = [tags.index(lbl) for lbl in keep]

        # --- device sources: the resident planes, read in place ---
        dev = self.cache.device
        masks = tuple((ti, torch.from_numpy(mask_arrays[ti]).to(dev))
                      for ti in sorted(mask_arrays))
        sources = []
        for item in items:
            entry = item["entry"]
            sources.append(RowSource(
                ts=entry.cols[ts_name], values=entry.cols[value_col], num_series=s_pad,
                codes=tuple(entry.cols[t] for t in tags), radices=radices, masks=masks,
                nulls=entry.nulls.get(value_col),
                valid=entry.valid_dedup if item["dedup"] else entry.valid,
                lo=lo_nat, hi=hi_nat, unit_ns=unit_ns, offset=offset,
            ))
        grid = RangeGrid(start, step, range_ms, n_steps=w_pad, k=k, num_series=s_pad,
                         n_steps_actual=w)
        fold = self.cache.group_csr(radices, tuple(keep_idx)) if agg_op is not None else None
        self._add_ms("plan", t0)

        t0 = time.perf_counter()
        mesh_n = self.cache.mesh_devices()
        on_mesh = mesh_n > 0 and len(sources) > 1
        mat, pres = tql_program(sources, [item["region"].region_id for item in items],
                                self.cache.mesh(mesh_n) if on_mesh else (dev,), grid, func,
                                agg_op, fold)
        if on_mesh:
            self.qe.stats.add(mesh_dispatches=1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._add_ms("dispatch", t0)
        np_mat, np_pres, pregathered = self._readback(mat, pres, cfg, compact_ok=agg_op is None)
        t0 = time.perf_counter()
        try:
            return self._assemble(np_mat, np_pres, dictionary, tags, steps, w, agg_op, keep,
                                  radices, keep_idx, pregathered)
        finally:
            self._add_ms("assemble", t0)

    def _readback(self, mat, pres, cfg, compact_ok=True):
        """Device -> host.  Past `tql.compact_readback_kb` a per-series
        result comes back in two trips: the presence bits, then only the
        present rows, gathered on the card.  Folded [G, W] results and
        small ones come back in one."""
        t0 = time.perf_counter()
        threshold = int(cfg.tql.compact_readback_kb) << 10
        pregathered = None
        np_pres = [p.cpu().numpy() for p in pres]
        if compact_ok and mat.numel() * 8 > threshold:
            pregathered = _legacy_order(np_pres)
            if pregathered:
                sel = torch.as_tensor(np.asarray(pregathered, np.int64), device=mat.device)
                np_mat = mat.index_select(0, sel).cpu().numpy()
            else:
                np_mat = np.zeros((0, mat.shape[1]))
        else:
            np_mat = mat.cpu().numpy()
        self._add_ms("readback", t0)
        return np_mat, np_pres, pregathered

    # ---- host assembly -----------------------------------------------------
    def _assemble(self, np_mat, np_pres, dictionary, tags, steps, w,
                  agg_op, keep, radices, keep_idx, pregathered=None):
        from .engine import Matrix

        # legacy series order: regions in scan order, dictionary-code
        # (= pk-sorted) order within each region, first appearance wins
        order = pregathered if pregathered is not None else _legacy_order(np_pres)
        value_lists = [dictionary.values(t) for t in tags]

        def decode(code_id, rads, vals_lists):
            codes = []
            stride = 1
            for r in reversed(rads):
                codes.append((code_id // stride) % r)
                stride *= r
            codes.reverse()
            return tuple(vals[c] if c < len(vals) else None
                         for c, vals in zip(codes, vals_lists))

        if agg_op is None:
            label_values = [decode(s, radices, value_lists) for s in order]
            if pregathered is not None:
                values = np_mat[:, :w] if order else np.zeros((0, w))
            else:
                values = (np_mat[np.asarray(order, dtype=np.int64)][:, :w]
                          if order else np.zeros((0, w)))
            return Matrix(list(tags), label_values, values, steps)

        # grouped result: legacy group order = first appearance of each group
        # key along the legacy series order
        g_order: list[int] = []
        g_seen: set[int] = set()
        for s in order:
            g = _gid_of(s, radices, keep_idx)
            if g not in g_seen:
                g_seen.add(g)
                g_order.append(g)
        kept_lists = [value_lists[i] for i in keep_idx]
        kept_radices = [radices[i] for i in keep_idx]
        label_values = [decode(g, kept_radices, kept_lists) for g in g_order]
        values = (np_mat[np.asarray(g_order, dtype=np.int64)][:, :w]
                  if g_order else np.zeros((0, w)))
        return Matrix(list(keep), label_values, values, steps)


# ---- helpers ---------------------------------------------------------------


def _legacy_order(np_pres) -> list[int]:
    """The legacy scan's series order: regions in scan order, pk-sorted
    (= dictionary-code ascending) within a region, first appearance wins."""
    order: list[int] = []
    seen: set[int] = set()
    for p in np_pres:
        for sid in np.nonzero(p)[0]:
            s = int(sid)
            if s not in seen:
                seen.add(s)
                order.append(s)
    return order


def _gid_of(sid: int, radices, keep_idx) -> int:
    """Group id of one series id (mixed radix over the kept tag subset, in
    keep order): the scalar form of `ops/rate.py::gid_map`."""
    codes = []
    stride = 1
    for r in reversed(radices):
        codes.append((sid // stride) % r)
        stride *= r
    codes.reverse()
    gid = 0
    g_stride = 1
    for i in reversed(keep_idx):
        gid += codes[i] * g_stride
        g_stride *= radices[i]
    return gid


def _null_code(dictionary, name) -> int:
    cd = dictionary._cols.get(name)
    return cd.null_code if cd is not None else -1


def _disjoint_ranges(ranges) -> bool:
    if len(ranges) <= 1:
        return True
    s = sorted(ranges)
    return all(s[i][1] < s[i + 1][0] for i in range(len(s) - 1))


def _empty_matrix(tags, agg, steps):
    from .engine import Matrix

    if agg is not None:
        _op, by, without = agg
        if by is not None:
            keep = [lbl for lbl in by if lbl in tags]
        elif without is not None:
            keep = [lbl for lbl in tags if lbl not in without]
        else:
            keep = []
        return Matrix(keep, [], np.zeros((0, len(steps))), steps)
    return Matrix(list(tags), [], np.zeros((0, len(steps))), steps)
