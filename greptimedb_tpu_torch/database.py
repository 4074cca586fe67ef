"""Database: the standalone facade of the port.

Counterpart of `greptimedb_tpu/database.py`, reduced to what the TSBS SQL
slice runs: catalog + TimeSeriesEngine (WAL -> memtable -> Parquet SSTs)
+ QueryEngine, with rows routed to regions by the table's partition rule.
Statements: CREATE DATABASE, CREATE TABLE, INSERT ... VALUES, SELECT.
Everything else the reference's facade does (ALTER/DELETE/COPY, views,
flows, the metric engine, information_schema, sessions and admission,
PromQL) is cut and listed in ROADMAP.md.

`device` names the torch device of the lowered query path: "cuda" (the
default) or "cpu".  `Database(..., device="cuda")` on a machine without a
card raises; it never runs quietly on the CPU.

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
    InsertStmt,
    SelectStmt,
    parse_sql,
)
from .storage.engine import TimeSeriesEngine
from .storage.sst import ScanPredicate
from .utils.config import Config
from .utils.errors import InvalidArgumentsError, UnsupportedError
from .utils.torch_env import resolve_device


class Database:
    def __init__(
        self,
        data_home: str | None = None,
        device: str = "cuda",
        config: Config | None = None,
    ):
        self.config = config or Config()
        self.config.query.device = str(resolve_device(device))
        if data_home is not None:
            self.config.storage.data_home = data_home
            self.config.storage.wal_dir = ""
            self.config.storage.sst_dir = ""
        self.storage = TimeSeriesEngine(self.config.storage)
        self.catalog = Catalog(os.path.join(self.config.storage.data_home, "catalog.json"))
        self.ddl_lock = threading.RLock()
        self.current_database = DEFAULT_SCHEMA
        self.query_engine = QueryEngine(
            schema_provider=self._schema_of,
            scan_provider=self._scan,
            region_scan_provider=self._region_scan,
            time_bounds_provider=self._time_bounds,
            config=self.config.query,
        )
        self._reopen_regions()

    @property
    def device(self) -> str:
        return self.config.query.device

    def close(self):
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
        raise UnsupportedError(f"unsupported statement: {type(stmt).__name__}")

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
        columns.append(
            ColumnSchema(
                name=c.name,
                data_type=ConcreteDataType.parse(c.type_name),
                semantic_type=sem,
                nullable=c.nullable and sem == SemanticType.FIELD,
                default=c.default,
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
