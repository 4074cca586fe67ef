"""Database: the standalone facade of the port.

Counterpart of `greptimedb_tpu/database.py`, reduced to what the TSBS SQL
slice runs: catalog + TimeSeriesEngine (WAL -> memtable -> Parquet SSTs)
+ QueryEngine, with rows routed to regions by the table's partition rule,
and the per-table tag dictionaries (data_home/dicts/) the device tile
cache encodes with.  Statements: CREATE DATABASE, CREATE TABLE,
DROP TABLE, INSERT ... VALUES, SELECT, and TQL EVAL (PromQL,
query/promql/); `prewarm()` builds the tile path's planes off the query
path.  `ORDER BY vec_*_distance(col, literal) LIMIT k` over a
bare scan is answered by `_vector_search` (per-SST IVF candidates on
append-mode tables, then `ops/vector.py::topk_host` on this Database's
device; `last_vector_timings` holds its host ms per stage).  Everything
else the reference's facade does
(ALTER/DELETE/COPY, views, flows, the metric engine, information_schema,
sessions and admission) is cut and listed in ROADMAP.md.

`device` names the torch device of the lowered query path: "cuda" (the
default) or "cpu", or a list of devices — the slots of the multi-device
mesh (`tile.mesh_devices`, parallel/mesh.py), where one device may fill
several (`["cuda:0"] * 4`); the first slot is `device`.
`Database(..., device="cuda")` on a machine without a card raises; it
never runs quietly on the CPU.

The on-disk layout is the reference's, so a data home written by either
package opens in the other.
"""

from __future__ import annotations

import os
import threading

import pyarrow as pa

from .datatypes.data_type import ConcreteDataType
from .datatypes.schema import ColumnSchema, Schema, SemanticType
from .models.catalog import DEFAULT_SCHEMA, Catalog
from .models.partition import HashPartitionRule, SingleRegionRule
from .query.engine import QueryEngine
from .query.logical_plan import TableScan
from .query.sql_parser import (
    CreateDatabaseStmt,
    CreateTableStmt,
    DropStmt,
    InsertStmt,
    SelectStmt,
    TqlStmt,
    parse_sql,
)
from .storage.dictionary import DictionaryRegistry
from .storage.engine import TimeSeriesEngine
from .storage.sst import ScanPredicate
from .utils.config import Config
from .utils.errors import InvalidArgumentsError, UnsupportedError
from .utils.torch_env import resolve_devices


class Database:
    def __init__(
        self,
        data_home: str | None = None,
        device: str | list = "cuda",
        config: Config | None = None,
    ):
        self.config = config or Config()
        slots = resolve_devices(device)
        self.config.query.device = (tuple(str(d) for d in slots)
                                    if isinstance(device, (list, tuple)) else str(slots[0]))
        if data_home is not None:
            self.config.storage.data_home = data_home
            self.config.storage.wal_dir = ""
            self.config.storage.sst_dir = ""
        self.storage = TimeSeriesEngine(self.config.storage)
        self.catalog = Catalog(os.path.join(self.config.storage.data_home, "catalog.json"))
        self.dicts = DictionaryRegistry(os.path.join(self.config.storage.data_home, "dicts"))
        self.ddl_lock = threading.RLock()
        self.current_database = DEFAULT_SCHEMA
        self.query_engine = QueryEngine(
            schema_provider=self._schema_of,
            scan_provider=self._scan,
            region_scan_provider=self._region_scan,
            time_bounds_provider=self._time_bounds,
            config=self.config.query,
            tile_context_provider=self._tile_context,
            tile_config=self.config.tile,
            batch_config=self.config.batch,
            vector_search_provider=self._vector_search,
        )
        # host ms per stage of the last vector search (_vector_search)
        self.last_vector_timings: dict[str, float] = {}
        self._reopen_regions()

    @property
    def device(self) -> str:
        return self.config.query.first_device

    @property
    def devices(self) -> tuple[str, ...]:
        """The mesh slots, the first being `device`."""
        return self.config.query.slots

    def close(self):
        # the fused build's background builder first: it reads the storage
        te = self.query_engine._tile_executor
        if te is not None:
            te.shutdown_fused()
        self.storage.close()

    # ---- SQL entry --------------------------------------------------------
    def sql(self, text: str):
        """Execute ;-separated SQL; returns a list of results (pa.Table for
        queries, int affected-rows for writes, None for DDL)."""
        return [self._execute(stmt) for stmt in parse_sql(text)]

    def sql_one(self, text: str):
        out = self.sql(text)
        return out[-1] if out else None

    def _execute(self, stmt):
        if isinstance(stmt, SelectStmt):
            return self.query_engine.execute_select(stmt, self.current_database)
        if isinstance(stmt, CreateTableStmt):
            return self._create_table(stmt)
        if isinstance(stmt, CreateDatabaseStmt):
            self.catalog.create_database(stmt.name, if_not_exists=stmt.if_not_exists)
            return None
        if isinstance(stmt, InsertStmt):
            return self._insert(stmt)
        if isinstance(stmt, DropStmt) and stmt.kind == "table":
            return self._drop_table(stmt)
        if isinstance(stmt, TqlStmt):
            return self._tql(stmt)
        raise UnsupportedError(f"unsupported statement: {type(stmt).__name__}")

    # ---- TQL (PromQL-in-SQL) ----------------------------------------------
    def _tql(self, stmt: TqlStmt):
        from .query.promql.engine import PromqlEngine

        self.query_engine.last_tql_timings = {}
        engine = PromqlEngine(self)
        return engine.query_range(
            stmt.query,
            start_ms=int(stmt.start * 1000),
            end_ms=int(stmt.end * 1000),
            step_ms=int(stmt.step * 1000),
        )

    # ---- DDL --------------------------------------------------------------
    def _create_table(self, stmt: CreateTableStmt):
        if stmt.external or stmt.engine not in (None, "", "mito"):
            raise UnsupportedError(f"table engine {stmt.engine!r} is not ported")
        schema, rule = build_schema_and_rule(stmt)
        self.catalog.create_table(
            stmt.name,
            schema,
            partition_rule=rule,
            database=getattr(stmt, "database", None) or self.current_database,
            if_not_exists=stmt.if_not_exists,
            options=stmt.options,
            on_create=lambda m: [
                self.storage.create_region(
                    rid,
                    schema,
                    append_mode=_opt_bool(stmt.options, "append_mode"),
                    merge_mode=str(stmt.options.get("merge_mode", "")) or None,
                    memtable_kind=str(
                        stmt.options.get("memtable.type", stmt.options.get("memtable_type", ""))
                    )
                    or None,
                )
                for rid in m.region_ids
            ],
        )
        return None

    def _drop_table(self, stmt: DropStmt):
        db_name = stmt.database or self.current_database
        if stmt.if_exists and not self.catalog.has_table(stmt.name, db_name):
            return None
        self.catalog.table(stmt.name, db_name)  # a missing table raises with {database}.{name}
        meta = self.catalog.drop_table(stmt.name, db_name)
        cache = self.query_engine.tile_cache
        for rid in meta.region_ids:
            self.storage.drop_region(rid)
            if cache is not None:
                cache.invalidate_region(rid, set())
        self.dicts.drop(f"{db_name}.{stmt.name}")
        return None

    # ---- writes -----------------------------------------------------------
    def _insert(self, stmt: InsertStmt) -> int:
        meta = self.catalog.table(
            stmt.table, getattr(stmt, "database", None) or self.current_database
        )
        schema = meta.schema
        if getattr(stmt, "query", None) is not None:
            raise UnsupportedError("INSERT ... SELECT is not ported")
        columns = stmt.columns or schema.column_names()
        if any(not schema.has_column(c) for c in columns):
            bad = [c for c in columns if not schema.has_column(c)]
            raise InvalidArgumentsError(f"unknown columns in INSERT: {bad}")
        n_rows = len(stmt.rows)
        by_name = rows_to_columns(stmt.rows, columns)
        arrays = []
        for col in schema.columns:
            values = by_name[col.name] if col.name in by_name else [col.default] * n_rows
            arrays.append(_coerce_array(values, col))
        batch = pa.RecordBatch.from_arrays(arrays, schema=schema.to_arrow())
        return self.write_batch(meta, batch)

    def write(self, table: str, rows: pa.RecordBatch | pa.Table, database: str | None = None) -> int:
        """Write Arrow rows to a table (columns matched by name and cast to
        the table schema); WAL append then memtable, per region."""
        meta = self.catalog.table(table, database or self.current_database)
        if isinstance(rows, pa.Table):
            batches = rows.combine_chunks().to_batches()
        else:
            batches = [rows]
        return sum(self.write_batch(meta, _conform_batch(b, meta.schema)) for b in batches)

    def write_batch(self, meta, batch: pa.RecordBatch) -> int:
        """Route rows to regions via the partition rule and write each."""
        table = pa.Table.from_batches([batch])
        affected = 0
        for rid, part in zip(meta.region_ids, meta.partition_rule.split(table)):
            for b in part.to_batches():
                if b.num_rows:
                    affected += self.storage.write(rid, b)
        return affected

    def flush(self):
        """Flush every region's memtable to Parquet SSTs."""
        self.storage.flush_all()

    # ---- providers of the query engine ------------------------------------
    def _schema_of(self, table: str, database: str) -> Schema:
        return self.catalog.table(table, database).schema

    def _pred_of(self, scan: TableScan) -> ScanPredicate:
        return ScanPredicate(
            time_range=scan.time_range, filters=[tuple(f) for f in scan.filters]
        )

    def _region_scan(self, scan: TableScan) -> list[pa.Table]:
        meta = self.catalog.table(scan.table, scan.database)
        pred = self._pred_of(scan)
        return [self.storage.scan(rid, pred) for rid in meta.region_ids]

    def _scan(self, scan: TableScan) -> pa.Table:
        if not scan.table:
            return pa.table({"__dummy": [0]})  # constant SELECTs
        tables = [t for t in self._region_scan(scan) if t.num_rows]
        meta = self.catalog.table(scan.table, scan.database)
        if not tables:
            return meta.schema.to_arrow().empty_table()
        return pa.concat_tables(tables, promote_options="permissive")

    def _vector_search(self, vs) -> pa.Table:
        """Top-k nearest rows for a VectorSearch node.

        Append-mode regions consult the per-SST IVF index (reference
        vector-index applier): distances are computed only over the probed
        candidate rows; dedup-mode regions rank the authoritative merged
        scan (last-write-wins must win before ranking).  Rows with NULL
        vectors are excluded from the top-k, like the reference's index
        search.  Every table the port has is backed by its own regions, so
        a missing region raises (the reference's whole-table fallback is
        for virtual and logical tables, which the port lacks)."""
        import time

        import numpy as np

        from .ops.vector import topk_host
        from .query.vector import decode_matrix
        from .storage.sst import INDEX_VECTOR_APPLIED, _apply_residual

        q = np.frombuffer(vs.query, dtype="<f4")
        timings = {"scan": 0.0, "decode": 0.0, "upload": 0.0, "rank": 0.0, "take": 0.0}
        self.last_vector_timings = timings

        def ms_since(t0: float) -> float:
            return (time.perf_counter() - t0) * 1e3

        def topk_of(table: pa.Table) -> pa.Table:
            if table.num_rows == 0 or vs.column not in table.column_names:
                # pre-ALTER data may lack the vector column entirely: those
                # rows have NULL vectors and never rank
                return table.schema.empty_table() if table.num_rows else table
            t0 = time.perf_counter()
            mat, valid = decode_matrix(table[vs.column], len(q))
            timings["decode"] += ms_since(t0)
            _dist, sel = topk_host(mat, valid, q, vs.metric, vs.k, vs.ascending,
                                   device=self.device, timings=timings)
            t0 = time.perf_counter()
            out = table.take(pa.array(np.sort(sel)))
            timings["take"] += ms_since(t0)
            return out

        meta = self.catalog.table(vs.scan.table, vs.scan.database)
        out: list[pa.Table] = []
        pred = self._pred_of(vs.scan)
        regions = [self.storage.region(rid) for rid in meta.region_ids]
        for region in regions:
            if region.append_mode:
                # per-SST IVF candidates + memtable brute force; no dedup to
                # disturb in append mode
                for fm in region.sst_reader.prune_files(region.files(), pred):
                    t0 = time.perf_counter()
                    t = region.sst_reader.read(fm, pred)
                    timings["scan"] += ms_since(t0)
                    vi = region.sst_reader.vector_index(fm, vs.column)
                    if vi is not None and t.num_rows == fm.num_rows:
                        cand = vi.candidates(q, nprobe=8)
                        if len(cand) >= min(vs.k, vi.n) and len(cand) < t.num_rows:
                            INDEX_VECTOR_APPLIED.inc()
                            t = t.take(pa.array(np.sort(cand)))
                    out.append(topk_of(t))
                ts_name = meta.schema.time_index.name if meta.schema.time_index else None
                for mem in [*region._frozen_memtables, region.memtable]:
                    t0 = time.perf_counter()
                    mt = _apply_residual(mem.to_table(dedup=False), pred, ts_name)
                    timings["scan"] += ms_since(t0)
                    out.append(topk_of(mt))
            else:
                t0 = time.perf_counter()
                t = region.scan(pred)
                timings["scan"] += ms_since(t0)
                out.append(topk_of(t))
        tables = [t for t in out if t.num_rows]
        if not tables:
            return meta.schema.to_arrow().empty_table()
        return pa.concat_tables(tables, promote_options="permissive")

    def _tile_context(self, scan: TableScan):
        """TileContext of a scan for the device tile cache, or None when the
        scan has no table to tile."""
        from .parallel.tile_planes import TileContext

        if not scan.table:
            return None
        database = scan.database or self.current_database
        if not self.catalog.has_table(scan.table, database):
            return None
        meta = self.catalog.table(scan.table, database)
        regions = [self.storage.region(rid) for rid in meta.region_ids]
        key = f"{database}.{scan.table}"
        return TileContext(
            table_key=key,
            dictionary=self.dicts.get(key),
            regions=regions,
            append_mode=any(r.append_mode for r in regions),
        )

    def prewarm(self, tables=None, database: str | None = None) -> dict:
        """Build the tile path's super-tiles of flushed data off the query
        path (`TileExecutor.prewarm`).  Under the fused build (the default:
        `tile.fused_build` and its pass on) the fused branch runs: the
        table's base manifest is recorded and its union build runs
        host-only — the Parquet decode, encodes and (pk, ts) sort the host
        routes read, no device plane and no launch; the device planes come
        with each family's background build.  Otherwise the legacy branch:
        the host consolidation, the upload of every numeric field and K5
        over the non-null ones, so the first query of a family finds its
        planes resident.  `tables` restricts it to the named tables (bare
        or database-qualified), `database` to one database.  Returns
        {"db.table": {"regions_built", "ms"}} (with "coalesced" when a
        concurrent build led); {} with the tile cache off.  A failed build,
        upload or kernel raises."""
        te = self.query_engine.tile_executor()
        if te is None:
            return {}
        out: dict = {}
        want = set(tables) if tables else None
        for db in [database] if database else self.catalog.databases():
            for meta in self.catalog.tables(db):
                key = f"{db}.{meta.name}"
                if want is not None and meta.name not in want and key not in want:
                    continue
                ctx = self._tile_context(TableScan(table=meta.name, database=db))
                if ctx is None:
                    continue
                out[key] = te.prewarm(ctx, self._schema_of(meta.name, db))
        return out

    def _time_bounds(self, table: str, database: str) -> tuple[int, int]:
        """Min/max time over a table, from SST metadata + memtable ranges."""
        meta = self.catalog.table(table, database)
        lo, hi = None, None
        for rid in meta.region_ids:
            region = self.storage.region(rid)
            for fm in region.files():
                lo = fm.time_range[0] if lo is None else min(lo, fm.time_range[0])
                hi = fm.time_range[1] if hi is None else max(hi, fm.time_range[1])
            for mem in [region.memtable] + region._frozen_memtables:
                r = mem.time_range()
                if r is not None:
                    lo = r[0] if lo is None else min(lo, r[0])
                    hi = r[1] if hi is None else max(hi, r[1])
        if lo is None:
            return (0, 0)
        return (lo, hi)

    # ---- recovery ---------------------------------------------------------
    def _reopen_regions(self):
        for db in self.catalog.databases():
            for meta in self.catalog.tables(db):
                append = _opt_bool(meta.options, "append_mode")
                mm = str(meta.options.get("merge_mode", "")) or None
                mk = str(
                    meta.options.get("memtable.type", meta.options.get("memtable_type", ""))
                ) or None
                for rid in meta.region_ids:
                    self.storage.open_region(
                        rid, append_mode=append, memtable_kind=mk, merge_mode=mm
                    )


def build_schema_and_rule(stmt: CreateTableStmt):
    """CreateTableStmt -> (Schema, partition rule)."""
    columns: list[ColumnSchema] = []
    time_index = stmt.time_index
    pks = set(stmt.primary_key)
    for c in stmt.columns:
        if c.is_time_index:
            time_index = c.name
        if c.is_primary_key:
            pks.add(c.name)
    for c in stmt.columns:
        if c.name == time_index:
            sem = SemanticType.TIMESTAMP
        elif c.name in pks:
            sem = SemanticType.TAG
        else:
            sem = SemanticType.FIELD
        dt = ConcreteDataType.parse(c.type_name)
        vdim = None
        if dt == ConcreteDataType.VECTOR:
            import re

            m = re.match(r"vector\s*\(\s*(\d+)\s*\)", c.type_name.strip().lower())
            if not m:
                raise InvalidArgumentsError(
                    f"VECTOR column {c.name!r} needs a dimension: VECTOR(n)"
                )
            vdim = int(m.group(1))
        columns.append(
            ColumnSchema(
                name=c.name,
                data_type=dt,
                semantic_type=sem,
                nullable=c.nullable and sem == SemanticType.FIELD,
                default=c.default,
                vector_dim=vdim,
                vector_index=c.vector_index,
            )
        )
    if time_index is None:
        raise InvalidArgumentsError("table requires a TIME INDEX column")
    schema = Schema(columns=columns)
    mm = str(stmt.options.get("merge_mode", "")).strip()
    if mm not in ("", "last_row", "last_non_null"):
        raise InvalidArgumentsError(
            f"invalid merge_mode {mm!r}: expected 'last_row' or 'last_non_null'"
        )
    if mm == "last_non_null" and _opt_bool(stmt.options, "append_mode"):
        raise InvalidArgumentsError(
            "merge_mode = 'last_non_null' conflicts with append_mode "
            "(append tables keep every row; there is nothing to merge)"
        )
    rule = SingleRegionRule()
    if stmt.partition_by_hash is not None:
        cols, n = stmt.partition_by_hash
        rule = HashPartitionRule(cols, n)
    elif stmt.partition_on_columns is not None:
        raise UnsupportedError("PARTITION ON COLUMNS is not ported")
    return schema, rule


def _opt_bool(options: dict, key: str) -> bool:
    v = options.get(key)
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return bool(v)


def rows_to_columns(rows: list, columns: list[str]) -> dict:
    """Columnar transpose of INSERT VALUES rows."""
    if any(len(r) != len(columns) for r in rows):
        raise InvalidArgumentsError(
            f"INSERT row width mismatch: expected {len(columns)} "
            "values per row"
        )
    cols = list(zip(*rows)) if rows else [() for _ in columns]
    return {c: cols[i] for i, c in enumerate(columns)}


def _coerce_array(values: list, col: ColumnSchema) -> pa.Array:
    t = col.data_type.to_arrow()
    if col.data_type == ConcreteDataType.VECTOR:
        from .query.vector import parse_vector_literal

        coerced = [
            None if v is None else (v if isinstance(v, bytes) else parse_vector_literal(v, col.vector_dim))
            for v in values
        ]
        return pa.array(coerced, t)
    if col.data_type.is_timestamp():
        unit_ms = col.data_type.timestamp_unit_ns() // 1_000_000
        if all(v is None or type(v) is int for v in values):
            return pa.array(values, t)
        coerced = []
        for v in values:
            if isinstance(v, str):
                import datetime

                dt = datetime.datetime.fromisoformat(v.replace(" ", "T"))
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=datetime.timezone.utc)
                coerced.append(int(dt.timestamp() * 1000) // max(unit_ms, 1))
            else:
                coerced.append(None if v is None else int(v))
        return pa.array(coerced, t)
    return pa.array(values, t)


def _conform_batch(batch: pa.RecordBatch, schema: Schema) -> pa.RecordBatch:
    """Reorder/cast incoming batch columns to the table schema."""
    arrays = []
    for col in schema.columns:
        i = batch.schema.get_field_index(col.name)
        if i < 0:
            arrays.append(pa.nulls(batch.num_rows, col.data_type.to_arrow()))
        else:
            arr = batch.column(i)
            want = col.data_type.to_arrow()
            if arr.type != want:
                arr = arr.cast(want)
            arrays.append(arr)
    return pa.RecordBatch.from_arrays(arrays, schema=schema.to_arrow())
