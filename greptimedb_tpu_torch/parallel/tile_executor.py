"""The tile executor: a lowered query over the cached super-tiles.

Counterpart of `greptimedb_tpu/parallel/tile_cache.py` `TileExecutor`:
`execute`, `_try_execute_impl`, the warm branch of `_locked_execute`,
`_encode_mem` (the memtable tail), `_fetch_result`, `_finalize`,
`_decode_result` and the `_assemble_*` helpers, for the configuration
the port implements (one device, the "sort" and "hash" strategies, no
host fast path, no cold host serve, no fused or batched builds, no dedup
plane, no window tiles, no streamed spill).  A query:

  1. snapshots each region's (files, memtables) and checks that the
     tile path may aggregate raw file rows (append-mode table, or
     pairwise-disjoint sources; no delete tombstones in the window);
  2. updates the table dictionary with the memtable tails, fetches (or
     builds and uploads, or extends by a flushed delta) each region's
     super-tile, and repairs the code planes a dictionary growth moved
     (`repair_super`);
  3. picks the group-by strategy (`choose_agg_strategy`: hash when the
     padded group space is sparse against the distinct keys) and builds
     the plan and its runtime values (parallel/tile_planner.py); a sort
     plan must fit the dense bounds (`query.max_groups` * 64 output
     groups, `query.max_internal_groups` stage-1 groups);
  4. runs one tile program over every chunk and tail — of the
     time-major copies for a bucket-only group-by — (parallel/
     tile_program.py) and reads the packed result back once;
  5. decodes it on the host.  A limb verdict of 0 (a group's
     quantization bound above 1e-7 of its sum) reruns the query with
     exact f64 accumulation; a hash overflow verdict (some row found no
     slot) reruns it on the dense plan when the dense bounds allow it,
     and otherwise declines, so the table-fed path answers.  A hash
     result decodes from the slot table: occupied slots in ascending gid
     order, the order of the dense path's rows.

`execute` returns None when the query does not apply, and the caller
takes the table-fed path.  `timings` holds the host ms per stage of the
last call: build and upload (cold entries only), delta_host and
delta_device (a flushed delta merged into a cached entry: host encode
and merge, then the K16 patches through a sync), time_major (K14 and
the K15 copies through a sync; near zero once cached), quantize (K5,
through a sync; near zero once the limb planes are cached), plan (everything else
before the dispatch), dispatch (the program through its last sync),
readback, decode.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..ops.aggregate import unpack_f64_bits
from ..ops.tiles import pad_rows
from ..query import passes
from ..storage.region import OP_COL
from .executor import COUNT_STAR, GroupByResult, _FUNC_TO_KERNEL
from .tile_planes import TileCacheManager, TileContext, _encode_host_tiles, _SuperTiles
from .tile_planner import (
    build_plan,
    choose_agg_strategy,
    choose_layout,
    disjoint,
    plan_cols,
)
from .tile_program import limb_sum_cols, tile_program


class TileExecutor:
    """Aggregation over cached device super-tiles; returns None when not
    applicable so the caller can take the table-fed path."""

    def __init__(self, cache: TileCacheManager, config):
        self.cache = cache
        self.config = config
        self.timings: dict[str, float] = {}
        # queries rerun in exact f64 after a failed limb verdict
        self.limb_reruns = 0
        # the strategy of the last query's first dispatched plan ("hash",
        # "sort", or None when it dispatched nothing), and whether its
        # hash dispatch overflowed the slot table
        self.last_strategy: str | None = None
        self.last_hash_overflow = False
        # bytes of the last result read back from the device
        self.last_readback_bytes = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- public entry --------------------------------------------------------
    def execute(self, lowering, schema, time_bounds, ctx: TileContext):
        self.timings = {}
        self.last_strategy = None
        self.last_hash_overflow = False
        # refuse an unknown strategy also when the config was changed after
        # it was built
        self.config.validate()
        scan = lowering.scan
        ts_name = schema.time_index.name if schema.time_index else None
        tag_cols = list(lowering.group_tags)
        tag_names = {c.name for c in schema.tag_columns()}
        filter_tag_cols = [
            f[0] for f in scan.filters if f[0] in tag_names and f[0] not in tag_cols
        ]
        value_cols = list(dict.fromkeys(
            [c for _f, c in lowering.agg_specs if c is not None]
            + [f[0] for f in scan.filters if f[0] not in tag_names and f[0] != ts_name]
        ))
        needs_ts = (
            lowering.bucket is not None
            or any(f == "last_value" for f, _ in lowering.agg_specs)
            or scan.time_range is not None
            or any(f[0] == ts_name for f in scan.filters)
        )
        use_ts = ts_name if (needs_ts and ts_name) else None
        pk = [c.name for c in schema.tag_columns()]
        layout_probe = choose_layout(pk, tag_cols, lowering.bucket is not None)
        needs_last = any(f == "last_value" for f, _ in lowering.agg_specs)
        if needs_last and (
            (layout_probe is not None and set(tag_cols) != set(layout_probe))
            or (lowering.bucket is not None and not tag_cols)
        ):
            return None  # LAST states cannot fold away a pk axis
        extra_tag_cols = []
        if layout_probe is not None:
            extra_tag_cols = [
                t for t in layout_probe if t not in tag_cols and t not in filter_tag_cols
            ]
        all_tag_cols = tag_cols + filter_tag_cols + extra_tag_cols
        if any(getattr(r, "merge_mode", "last_row") == "last_non_null" for r in ctx.regions) \
                and not ctx.append_mode:
            return None  # fieldwise merging: the scan path owns it
        pinned: list = []
        with ctx.dictionary.table_lock:
            try:
                return self._locked_execute(
                    lowering, schema, scan, ctx, time_bounds, pinned, ts_name,
                    tag_cols, all_tag_cols, value_cols, use_ts, pk,
                )
            finally:
                for region in pinned:
                    region.unpin_scan()

    def _locked_execute(self, lowering, schema, scan, ctx, time_bounds, pinned, ts_name,
                        tag_cols, all_tag_cols, value_cols, use_ts, pk):
        t_start = time.perf_counter()
        window = scan.time_range

        def in_window(lo: int, hi: int) -> bool:
            if window is None:
                return True
            wlo, whi = window
            return hi >= wlo and lo < whi

        # 1. snapshot + safety gate; the region stays pinned until dispatch
        region_sources = []  # (region, [FileMeta], [mem pa.Table])
        for region in ctx.regions:
            region.pin_scan()
            pinned.append(region)
            all_files, mems, version = region.tile_snapshot()
            # drop cached planes of files compaction removed, once per
            # manifest version
            self.cache.invalidate_region_if_changed(
                region.region_id, {m.file_id for m in all_files}, version
            )
            file_ranges, mem_ranges, mem_tables = [], [], []
            for meta in all_files:
                if not in_window(*meta.time_range):
                    continue
                if meta.num_deletes != 0:
                    return None  # tombstones (or unknown): dedup needed
                file_ranges.append(meta.time_range)
            for mem in mems:
                mem_table = mem.scan(None, dedup=not ctx.append_mode)
                if mem_table.num_rows == 0:
                    continue
                if OP_COL in mem_table.column_names:
                    op_rows = mem_table
                    if window is not None and ts_name in mem_table.column_names:
                        ts_i = pc.cast(mem_table[ts_name], pa.int64())
                        op_rows = mem_table.filter(pc.and_(
                            pc.greater_equal(ts_i, window[0]), pc.less(ts_i, window[1])))
                    if op_rows.num_rows and pc.sum(
                        pc.fill_null(pc.cast(op_rows[OP_COL], pa.int64()), 0)
                    ).as_py():
                        return None  # tombstones inside the window
                    mem_table = mem_table.drop_columns([OP_COL])
                if ts_name and ts_name in mem_table.column_names:
                    ts_i = pc.cast(mem_table[ts_name], pa.int64())
                    mlo, mhi = pc.min(ts_i).as_py(), pc.max(ts_i).as_py()
                    if not in_window(mlo, mhi):
                        continue
                    mem_ranges.append((mlo, mhi))
                else:
                    mem_ranges.append((0, 0))
                mem_tables.append(mem_table)
            if not ctx.append_mode:
                # a memtable version of a row beats file versions: any
                # memtable overlap stays on the scan path; overlapping files
                # need the dedup plane, which is not ported
                if mem_ranges and not disjoint(mem_ranges + file_ranges):
                    return None
                if not disjoint(file_ranges):
                    return None
            region_sources.append((region, all_files, mem_tables))
        if not any(fs or ms for _r, fs, ms in region_sources):
            return None  # empty table: the normal path shapes the output

        # 2. every dictionary mutation happens before the plan is built:
        # memtable values first, then the per-file host encodes
        for _region, _metas, mem_tables in region_sources:
            for mt in mem_tables:
                ctx.dictionary.update_table(mt, all_tag_cols)
        pinned_ids = {r.region_id for r, _f, _m in region_sources}
        build_t: dict[str, float] = {}
        entries: dict[int, _SuperTiles] = {}

        def fetch(region, metas):
            entry, excluded = self.cache.super_tiles(
                region, ctx.dictionary, metas, all_tag_cols, ts_name or use_ts,
                value_cols, pinned_ids, pk, timings=build_t,
            )
            if any(in_window(*m.time_range) for m in excluded):
                return False
            if entry is not None:
                entries[region.region_id] = entry
            return True

        for region, metas, _mems in region_sources:
            if metas and not fetch(region, metas):
                return None
        # the dictionary is final for this query: repair the code planes a
        # later growth moved, with one K15 remap each
        self.cache.repair_super(list(entries.values()), ctx.dictionary, all_tag_cols)
        if not entries and not any(ms for _r, _f, ms in region_sources):
            return None

        # 3. the strategy probe and the static plan (cards after all
        # dictionary updates; before the limb planes are decided, since a
        # hash plan accumulates exact f64)
        agg_probe = choose_agg_strategy(
            self.config, lowering, schema, scan, ctx, tag_cols, time_bounds
        )
        built = build_plan(self.config, lowering, schema, scan, ctx, tag_cols, time_bounds,
                           use_ts, agg_probe=agg_probe)
        if built is None:
            return None
        plan, dyn_host, fspec = built
        if plan.agg_strategy == "hash":
            # the dense [G] space never materializes: only the slot table
            # must fit, and size_hash_slots caps it at max_internal_groups
            passes.note("agg_strategy", True, agg_probe["why"], slots=plan.hash_slots,
                        groups=plan.num_groups, distinct_est=agg_probe["d_est"],
                        stats=agg_probe["stats_src"])
        elif not self._dense_fits(plan):
            return None  # group space too large for dense [G] states

        # 4. the device sources: chunks of each super-tile, then the tails
        need_cols = plan_cols(plan)
        limb_need = limb_sum_cols(plan)
        device_sources = []
        q_ms = tm_ms = 0.0
        for region, _metas, mem_tables in region_sources:
            s = entries.get(region.region_id)
            if s is not None:
                if s.nbytes > self.cache.budget // 2:
                    self.cache.release_unneeded(s, need_cols)
                if plan.time_major:
                    t0 = time.perf_counter()
                    cols, valid, nulls = self.cache.ensure_time_major(s, use_ts, need_cols)
                    self._sync()
                    tm_ms += (time.perf_counter() - t0) * 1e3
                else:
                    cols = {k: v for k, v in s.cols.items() if k in need_cols}
                    valid = s.valid
                    nulls = {k: v for k, v in s.nulls.items() if k in need_cols}
                t0 = time.perf_counter()
                limbs = (self.cache.ensure_limbs(s, limb_need, plan.time_major, pinned_ids)
                         if limb_need else {})
                self._sync()
                q_ms += (time.perf_counter() - t0) * 1e3
                if any(c not in limbs and c not in s.cols for c in limb_need):
                    return None
                for i in range(len(valid)):
                    device_sources.append((
                        {k: v[i] for k, v in cols.items()},
                        valid[i],
                        {k: v[i] for k, v in nulls.items()},
                        {k: v[i] for k, v in limbs.items()},
                    ))
            for mt in mem_tables:
                src = self._encode_mem(ctx.dictionary, mt, all_tag_cols, use_ts, value_cols)
                if src is None:
                    return None
                cols, valid, nulls = src
                device_sources.append((
                    {k: v for k, v in cols.items() if k in need_cols},
                    valid,
                    {k: v for k, v in nulls.items() if k in need_cols},
                    {},
                ))
        # count rows ship only for columns whose sources carry a null mask
        null_present = set()
        for _cols, _valid, nulls, _limbs in device_sources:
            null_present |= set(nulls)
        nullable_cols = tuple(sorted(
            c for _f, c in plan.agg_specs if c != COUNT_STAR and c in null_present
        ))
        dyn = {
            "filter_values": tuple(dyn_host["filter_values"]),
            "bucket_origin": int(dyn_host["bucket_origin"]),
            "bucket_interval": int(dyn_host["bucket_interval"]),
            "having_values": tuple(dyn_host.get("having_values", ())),
        }
        self.timings.update(build_t, quantize=q_ms)
        if plan.time_major:
            self.timings["time_major"] = tm_ms
        self.timings["plan"] = (time.perf_counter() - t_start) * 1e3 - sum(self.timings.values())

        # 5. one program, one readback.  A failed limb verdict reruns in
        # f64; a hash overflow reruns on the dense plan when it fits the
        # dense bounds, and otherwise the table-fed path owns the query
        if plan.agg_strategy == "hash":
            attempts = [plan]
            dense = dataclasses.replace(plan, agg_strategy="sort", hash_slots=0,
                                        acc_dtype="float64")
            if self._dense_fits(dense):
                attempts.append(dense)
        else:
            attempts = [plan, dataclasses.replace(plan, acc_dtype="float64")]
        self.last_strategy = plan.agg_strategy
        for attempt in attempts:
            program = tile_program(attempt, nullable_cols, fspec)
            t0 = time.perf_counter()
            packed = program.run_all(device_sources, dyn)
            self._sync()
            self._add_ms("dispatch", t0)
            table = self._finalize(packed, program, attempt, lowering, ctx, dyn_host)
            if table is not None:
                return table
            if attempt.agg_strategy == "hash":
                self.last_hash_overflow = True
            else:
                self.limb_reruns += 1
        return None

    def _dense_fits(self, plan) -> bool:
        """A sort plan's [G] states fit the dense bounds."""
        return (plan.num_groups <= self.config.max_groups * 64
                and plan.internal_groups <= self.config.max_internal_groups)

    def _add_ms(self, stage: str, t0: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _fetch_result(packed) -> tuple:
        """The one device -> host readback of the packed result."""
        return tuple(p.cpu().numpy() for p in packed)

    def _finalize(self, packed, program, plan, lowering, ctx, dyn_host):
        """Read the result back and decode it; None on a failed limb
        verdict (the caller reruns in f64)."""
        t0 = time.perf_counter()
        fetched = self._fetch_result(packed)
        self._add_ms("readback", t0)
        self.last_readback_bytes = sum(a.nbytes for a in fetched)
        t0 = time.perf_counter()
        try:
            return self._decode_result(fetched, program, plan, lowering, ctx, dyn_host)
        finally:
            self._add_ms("decode", t0)

    # -- sources ----------------------------------------------------------------
    def _encode_mem(self, dictionary, table, tag_cols, ts_col, value_cols):
        """Encode the memtable tail with the same host encode as file
        tiles; padded to a multiple of 4096 rows and uploaded."""
        need = list(dict.fromkeys(tag_cols + ([ts_col] if ts_col else []) + value_cols))
        if any(name not in table.column_names for name in need):
            return None
        built = _encode_host_tiles(dictionary, table, need, tag_cols, ts_col)
        if built is None:
            return None
        cols, nulls, _epochs, _nbytes = built
        n = table.num_rows
        pad = pad_rows(n)

        def up(arr, dtype=None):
            buf = np.zeros(pad, dtype=dtype or arr.dtype)
            buf[:n] = arr
            return torch.from_numpy(buf).to(self.device)

        out_cols = {name: up(arr) for name, arr in cols.items()}
        out_nulls = {name: up(arr, bool) for name, arr in nulls.items()}
        return out_cols, up(np.ones(n, bool), bool), out_nulls

    # -- readback decode ----------------------------------------------------------
    def _decode_result(self, fetched, program, plan, lowering, ctx, dyn_host):
        buf = fetched[0]
        accs64 = fetched[1] if len(fetched) > 1 else None
        spec = program.spec
        is_hash = plan.agg_strategy == "hash"
        if is_hash and buf[-1] != 0:
            # slot-table overflow: the distinct-key estimate was badly low;
            # the caller reruns dense or declines (never a wrong result)
            return None
        if program.limb_err_cols and buf[-1] == 0:
            # a group's quantization bound exceeded 1e-7 of its sum: the
            # caller reruns with exact f64 accumulation
            return None
        if spec is not None:
            g = spec.cap
        elif is_hash:
            g = plan.hash_slots
        else:
            g = plan.num_groups
        bit_packed = program.bit_packed
        int_row = -(-g // 8) if bit_packed else g
        ni = len(program.int_layout)
        off = ni * int_row * (1 if bit_packed else 4)
        ints = np.frombuffer(
            buf[:off].tobytes(), np.uint8 if bit_packed else np.int32
        ).reshape(ni, int_row)
        n32 = len(program.acc32_layout)
        accs32 = np.frombuffer(buf[off: off + n32 * g * 4].tobytes(), np.float32).reshape(n32, g)
        off += n32 * g * 4
        sel = n_out = None
        if spec is not None:
            sel = np.frombuffer(buf[off: off + g * 4].tobytes(), np.int32)
            off += g * 4
            n_out = int(np.frombuffer(buf[off: off + 4].tobytes(), np.int32)[0])
            off += 4
            n64 = len(program.acc64_layout)
            pairs = np.frombuffer(buf[off: off + n64 * g * 8].tobytes(), np.int32).reshape(n64, g, 2)
            off += n64 * g * 8
            accs64 = unpack_f64_bits(pairs)
        finals: dict[str, dict[str, np.ndarray]] = {}
        for i, (col, agg) in enumerate(program.int_layout):
            row = ints[i]
            if bit_packed:
                row = np.unpackbits(row)[:g].astype(np.int64)
            finals.setdefault(col, {})[agg] = row
        for i, (col, agg) in enumerate(program.acc32_layout):
            finals.setdefault(col, {})[agg] = accs32[i].astype(np.float64)
        for i, (col, agg) in enumerate(program.acc64_layout):
            finals.setdefault(col, {})[agg] = accs64[i]
        if spec is not None:
            table = self._assemble_compact(finals, plan, ctx, dyn_host, sel, n_out, spec)
            # the device consumed these post-ops: the host replay skips them
            lowering.post_done = dyn_host.get("post_consumed", frozenset())
            return table
        if is_hash:
            return self._assemble_hash_result(finals, plan, ctx, dyn_host, fetched[2])
        return self._assemble_result(finals, plan, ctx, dyn_host)

    def _group_key_columns(self, plan, ctx, dyn_host, gids) -> dict:
        """gid vector -> ordered {tag..., bucket} output columns (the
        mixed-radix decode of GroupByResult.to_table)."""
        cols: dict[str, object] = {}
        dims: list[tuple[str, int]] = list(zip(plan.group_tags, plan.tag_cards))
        if plan.bucket_col is not None:
            dims.append(("__bucket", plan.n_buckets))
        decoded = {}
        div = 1
        for name, card in reversed(dims):
            decoded[name] = (gids // div) % card
            div *= card
        for tag in plan.group_tags:
            values = ctx.dictionary.values(tag)
            cols[tag] = [values[c] if c < len(values) else None for c in decoded[tag]]
        if plan.bucket_col is not None:
            cols[plan.bucket_col] = (
                dyn_host["bucket_origin"]
                + decoded["__bucket"].astype(np.int64) * dyn_host["bucket_interval"]
            )
        return cols

    @staticmethod
    def _append_agg_columns(cols, finals, plan, indexer):
        """Per-agg-spec output columns, rows taken via `indexer`, with the
        count-sharing / NULL-gating / naming of `_assemble_result`."""
        presence = finals["__presence"]["count"]
        for func, col in plan.agg_specs:
            out = finals.get(col, {})
            kernel = _FUNC_TO_KERNEL[func]
            arr = out.get(kernel)
            if arr is None and kernel == "count":
                arr = presence  # count-pass sharing: presence IS the count
            arr = np.asarray(arr)[indexer]
            col_count = np.asarray(out.get("count", presence))[indexer]
            if col == COUNT_STAR:
                cols["count(*)"] = pa.array(arr.astype(np.int64))
            elif func == "count":
                cols[f"count({col})"] = pa.array(arr.astype(np.int64))
            else:
                vals = np.where(col_count > 0, arr, np.nan)
                cols[f"{func}({col})"] = pa.array(vals, mask=np.isnan(vals))
        return cols

    def _assemble_hash_result(self, finals, plan, ctx, dyn_host, table_keys):
        """[K, hash_slots] rows + the slot -> gid key table -> SQL rows: the
        occupied slots ordered by gid ascending (the order of the dense
        path's scan over [G]), keys decoded with the same mixed radix and
        the same NULL gating and naming."""
        keys = np.asarray(table_keys, dtype=np.int64)
        presence = np.asarray(finals["__presence"]["count"])
        slot_idx = np.nonzero((keys >= 0) & (presence[: keys.shape[0]] > 0))[0]
        slots = slot_idx[np.argsort(keys[slot_idx], kind="stable")]
        cols = self._group_key_columns(plan, ctx, dyn_host, keys[slots])
        return pa.table(self._append_agg_columns(cols, finals, plan, slots))

    def _assemble_compact(self, finals, plan, ctx, dyn_host, sel, n_out, spec):
        """Compact [K, cap] rows + selected group ids -> SQL rows in device
        order; the host's remaining work is the offset/limit slice and the
        tag/bucket decode of rows_out ids."""
        rows_avail = max(min(n_out, spec.cap), 0)
        start, stop = 0, rows_avail
        if spec.limit is not None:
            start = min(spec.offset, rows_avail)
            stop = min(start + spec.limit, rows_avail)
        sl = slice(start, stop)
        idx = np.asarray(sel[sl], np.int64)
        cols = self._group_key_columns(plan, ctx, dyn_host, idx)
        return pa.table(self._append_agg_columns(cols, finals, plan, sl))

    def _assemble_result(self, finals, plan, ctx, dyn_host):
        """[G]-state rows -> SQL rows (the table-fed path's decode)."""
        outputs: dict[str, np.ndarray] = {}
        presence = finals["__presence"]["count"]
        for func, col in plan.agg_specs:
            out = finals.get(col, {})
            kernel = _FUNC_TO_KERNEL[func]
            arr = out.get(kernel)
            if arr is None and kernel == "count":
                arr = presence
            arr = np.asarray(arr)
            col_count = out.get("count", presence)
            if col == COUNT_STAR:
                outputs["count(*)"] = arr.astype(np.int64)
            elif func == "count":
                outputs[f"count({col})"] = arr.astype(np.int64)
            else:
                outputs[f"{func}({col})"] = np.where(col_count > 0, arr, np.nan)
        real = dataclasses.replace(
            plan, bucket_origin=int(dyn_host["bucket_origin"]),
            bucket_interval=int(dyn_host["bucket_interval"]),
        )
        result = GroupByResult(
            outputs=outputs, non_empty=presence > 0,
            tag_values={t: ctx.dictionary.values(t) for t in plan.group_tags}, plan=real,
        )
        return result.to_table()
