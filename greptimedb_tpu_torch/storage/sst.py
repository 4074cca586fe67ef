"""Parquet SST read/write with time-range pruning.

Role-equivalent of the reference's SST layer (reference
src/mito2/src/sst/parquet/{writer.rs,reader.rs,stats.rs}): immutable sorted
Parquet files with min/max time statistics used to prune whole files and row
groups at scan time.  We persist data in the reference's "flat format"
(flat_format.rs) spirit — plain columnar, tags as dictionary-encoded
columns — because flat columns are exactly what the device tile loader wants.

Each SST with `VECTOR INDEX` columns gets a puffin sidecar
(`{file_id}.puffin`) holding one IVF-flat blob per such column, built
while the file is written (the reference's `_build_indexes`, its vector
loop; the other index kinds wait for A7, see storage/index.py).
`SstReader.vector_index` parses a file's blob once and caches it.
"""

from __future__ import annotations

import logging
import os
import threading
import uuid
from dataclasses import dataclass, field

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from ..datatypes.schema import Schema
from . import index as idx
from .index import VECTOR_BLOB
from .object_store import FsObjectStore, ObjectStore
from .puffin import PuffinReader, PuffinWriter

DEFAULT_ROW_GROUP_SIZE = 1 << 20  # rows per row group; big groups = big tiles

log = logging.getLogger("greptimedb_tpu_torch.index")


class Counter:
    """A process-wide event count (the reference's metrics.Counter, without
    the exposition): `inc()` and `get()`."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def get(self) -> int:
        return self._value


INDEX_VECTOR_APPLIED = Counter(
    "greptime_index_vector_applied_total",
    "top-k vector searches answered via the IVF index",
)


@dataclass
class FileMeta:
    """Catalog entry for one SST (reference mito2/src/sst/file.rs FileMeta)."""

    file_id: str
    time_range: tuple[int, int]  # [min_ts, max_ts] inclusive, int64 native unit
    num_rows: int
    file_size: int
    level: int = 0
    indexed_columns: list[str] = field(default_factory=list)
    index_file_size: int = 0
    # Delete-tombstone rows in the file; -1 = unknown (file written before
    # this field existed).  The device tile cache only aggregates files it
    # can PROVE tombstone-free.
    num_deletes: int = 0

    def to_dict(self) -> dict:
        return {
            "file_id": self.file_id,
            "time_range": list(self.time_range),
            "num_rows": self.num_rows,
            "file_size": self.file_size,
            "level": self.level,
            "indexed_columns": self.indexed_columns,
            "index_file_size": self.index_file_size,
            "num_deletes": self.num_deletes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FileMeta":
        return cls(
            file_id=d["file_id"],
            time_range=tuple(d["time_range"]),
            num_rows=d["num_rows"],
            file_size=d["file_size"],
            level=d.get("level", 0),
            indexed_columns=d.get("indexed_columns", []),
            index_file_size=d.get("index_file_size", 0),
            num_deletes=d.get("num_deletes", -1),
        )


@dataclass
class ScanPredicate:
    """Pushed-down predicates the reader can use for pruning: a time range
    plus simple column comparisons (reference sst/parquet/stats.rs)."""

    time_range: tuple[int, int] | None = None  # [lo, hi) half-open
    # list of (column, op, value) with op in {"=", "!=", "<", "<=", ">", ">=", "in"}
    filters: list[tuple[str, str, object]] = field(default_factory=list)


class SstWriter:
    def __init__(
        self,
        store: ObjectStore | str,
        schema: Schema,
        row_group_size: int = DEFAULT_ROW_GROUP_SIZE,
    ):
        # A bare directory path means "local fs store rooted there" — the
        # common standalone config and what unit tests pass.
        self.store = FsObjectStore(store) if isinstance(store, str) else store
        self.schema = schema
        self.row_group_size = row_group_size

    def _build_indexes(self, table: pa.Table, file_id: str) -> tuple[list[str], int]:
        """Build the IVF-flat index of every VECTOR INDEX column into the
        puffin sidecar; returns (indexed columns, sidecar bytes)."""
        vec_cols = [
            c
            for c in self.schema.columns
            if c.vector_index and c.name in table.column_names
        ]
        if not vec_cols:
            return [], 0
        writer = PuffinWriter(self.store, f"{file_id}.puffin")
        indexed = []
        for c in vec_cols:
            col = table[c.name]
            col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
            vec = idx.build_vector_index(col, c.vector_dim or 0)
            if vec is not None:
                writer.add_blob(VECTOR_BLOB, vec, {"column": c.name})
                indexed.append(c.name)
        return indexed, writer.finish()

    def write(self, table: pa.Table, level: int = 0) -> FileMeta | None:
        """Write one sorted table as one SST file; returns its FileMeta."""
        if table.num_rows == 0:
            return None
        ts_name = self.schema.time_index.name if self.schema.time_index else None
        if ts_name is not None:
            ts = pc.cast(table[ts_name], pa.int64())
            t_min, t_max = pc.min(ts).as_py(), pc.max(ts).as_py()
        else:
            t_min = t_max = 0
        num_deletes = 0
        if "__op" in table.column_names:
            num_deletes = int(
                pc.sum(
                    pc.fill_null(pc.cast(table["__op"], pa.int64()), 0)
                ).as_py()
                or 0
            )
        # Dictionary-encode tag columns: small files + pre-built codes for the device.
        for tag in self.schema.tag_columns():
            if tag.name in table.column_names and not pa.types.is_dictionary(
                table.schema.field(tag.name).type
            ):
                i = table.schema.get_field_index(tag.name)
                table = table.set_column(
                    i, tag.name, pc.dictionary_encode(table[tag.name].combine_chunks())
                )
        file_id = uuid.uuid4().hex
        key = f"{file_id}.parquet"
        scratch = self.store.scratch_path(key)
        pq.write_table(
            table,
            scratch,
            row_group_size=self.row_group_size,
            compression="zstd",
            use_dictionary=True,
        )
        file_size = os.path.getsize(scratch)
        self.store.put_file(key, scratch)
        try:
            indexed, index_size = self._build_indexes(table, file_id)
        except Exception as e:  # noqa: BLE001 — as the reference: an index
            # build failure must never lose the data write; the SST lands
            # without a sidecar (searched exactly) and the failure is loud
            log.warning("index build for %s failed; SST written unindexed: %s", file_id, e)
            indexed, index_size = [], 0
        return FileMeta(
            file_id=file_id,
            time_range=(t_min, t_max),
            num_rows=table.num_rows,
            file_size=file_size,
            level=level,
            indexed_columns=indexed,
            index_file_size=index_size,
            num_deletes=num_deletes,
        )


_INDEX_CACHE = idx.IndexCache(capacity=128)


class _VectorSidecar:
    """One SST's puffin sidecar, its vector blobs parsed once each (the
    reference's TermIndexReader, its vector route only)."""

    def __init__(self, store: ObjectStore, file_id: str):
        self.file_id = file_id
        self._puffin = PuffinReader(store, f"{file_id}.puffin", ranged=True)
        self._parsed: dict[str, idx.VectorIndex | None] = {}

    def vector_index(self, column: str) -> idx.VectorIndex | None:
        if column in self._parsed:
            return self._parsed[column]
        out = None
        try:
            bm = self._puffin.find(VECTOR_BLOB, column=column)
            if bm is not None:
                out = idx.VectorIndex(self._puffin.read_blob(bm))
        except Exception as e:  # noqa: BLE001 — as the reference: a broken
            # sidecar degrades to an exact search of the file, never a failure
            log.warning("vector index %s of %s unreadable: %s", column, self.file_id, e)
            out = None
        self._parsed[column] = out
        return out


class SstReader:
    def __init__(self, store: ObjectStore | str, schema: Schema):
        self.store = FsObjectStore(store) if isinstance(store, str) else store
        self.schema = schema

    def delete(self, file_id: str):
        """Remove an SST (and an index sidecar written by an indexing
        writer) from the store."""
        self.store.delete(f"{file_id}.parquet")
        self.store.delete(f"{file_id}.puffin")

    def vector_index(self, meta: FileMeta, column: str) -> idx.VectorIndex | None:
        """Parsed per-SST IVF index for `column`, or None."""
        if not meta.indexed_columns:
            return None
        key = f"{getattr(self.store, 'root', id(self.store))}/{meta.file_id}"
        sidecar = _INDEX_CACHE.get(key)
        if sidecar is None:
            if not self.store.exists(f"{meta.file_id}.puffin"):
                return None
            sidecar = _VectorSidecar(self.store, meta.file_id)
            _INDEX_CACHE.put(key, sidecar)
        return sidecar.vector_index(column)

    def prune_files(self, files: list[FileMeta], pred: ScanPredicate) -> list[FileMeta]:
        """File-level pruning on time range (whole-file min/max)."""
        if pred.time_range is None:
            return list(files)
        lo, hi = pred.time_range
        return [f for f in files if f.time_range[1] >= lo and f.time_range[0] < hi]

    def read(
        self,
        meta: FileMeta,
        pred: ScanPredicate | None = None,
        columns: list[str] | None = None,
    ) -> pa.Table:
        """Read one SST with row-group pruning + residual filter application."""
        pred = pred or ScanPredicate()
        pf = pq.ParquetFile(self.store.open_input(f"{meta.file_id}.parquet"))
        ts_name = self.schema.time_index.name if self.schema.time_index else None
        groups = self._prune_row_groups(pf, pred, ts_name)
        if columns:
            # tolerate requested columns the file predates (e.g. __op or a
            # column added by ALTER after this SST was written)
            columns = [c for c in columns if c in pf.schema_arrow.names]
        if not groups:
            schema = pf.schema_arrow
            if columns:
                schema = pa.schema([schema.field(c) for c in columns])
            return schema.empty_table()
        table = pf.read_row_groups(groups, columns=columns, use_threads=True)
        # Parquet has no seconds timestamp unit: a timestamp("s") column comes
        # back as timestamp("ms").  Restore the declared logical type so
        # residual predicates (expressed in the native unit) compare correctly.
        if ts_name is not None and ts_name in table.column_names:
            want = self.schema.time_index.data_type.to_arrow()
            i = table.schema.get_field_index(ts_name)
            if table.schema.field(i).type != want:
                table = table.set_column(i, ts_name, pc.cast(table[ts_name], want))
        table = _apply_residual(table, pred, ts_name)
        return table

    def _prune_row_groups(self, pf: pq.ParquetFile, pred: ScanPredicate, ts_name) -> list[int]:
        md = pf.metadata
        if pred.time_range is None or ts_name is None:
            return list(range(md.num_row_groups))
        ts_idx = pf.schema_arrow.get_field_index(ts_name)
        if ts_idx < 0:
            return list(range(md.num_row_groups))  # no stats to prune on
        unit_ns = self.schema.time_index.data_type.timestamp_unit_ns()
        lo, hi = pred.time_range
        keep = []
        for g in range(md.num_row_groups):
            stats = md.row_group(g).column(ts_idx).statistics
            if stats is None or not stats.has_min_max:
                keep.append(g)
                continue
            g_min, g_max = _ts_to_int(stats.min, unit_ns), _ts_to_int(stats.max, unit_ns)
            if g_max >= lo and g_min < hi:
                keep.append(g)
        return keep


def _ts_to_int(v, unit_ns: int) -> int:
    """Convert a parquet stats value to the column's NATIVE timestamp unit.

    pyarrow surfaces timestamp stats as datetimes; predicates arrive in the
    column's own unit, so scale by the schema's unit (not hardcoded ms)."""
    if hasattr(v, "timestamp"):
        import calendar

        ns = calendar.timegm(v.utctimetuple()) * 1_000_000_000 + v.microsecond * 1000
        return ns // unit_ns
    return int(v)


def _apply_residual(table: pa.Table, pred: ScanPredicate, ts_name) -> pa.Table:
    """Apply exact time-range + pushed filters on the decoded table."""
    if table.num_rows == 0:
        return table
    mask = None
    if pred.time_range is not None and ts_name is not None and ts_name in table.column_names:
        lo, hi = pred.time_range
        ts = pc.cast(table[ts_name], pa.int64())
        mask = pc.and_(pc.greater_equal(ts, lo), pc.less(ts, hi))
    for name, op, value in pred.filters:
        if name not in table.column_names:
            continue
        col = table[name]
        if pa.types.is_dictionary(col.type):
            col = pc.cast(col, col.type.value_type)
        m = _cmp(col, op, value)
        mask = m if mask is None else pc.and_(mask, m)
    if mask is not None:
        table = table.filter(mask)
    return table


def _cmp(col, op: str, value):
    if op in ("match", "match_term"):
        from ..utils.errors import UnsupportedError

        raise UnsupportedError(f"{op} filters are not ported yet")
    if isinstance(value, str):
        from ..datatypes.coercion import coerce_string_scalar

        value = coerce_string_scalar(value, col.type)
    if op == "=":
        return pc.equal(col, value)
    if op == "!=":
        return pc.not_equal(col, value)
    if op == "<":
        return pc.less(col, value)
    if op == "<=":
        return pc.less_equal(col, value)
    if op == ">":
        return pc.greater(col, value)
    if op == ">=":
        return pc.greater_equal(col, value)
    if op == "in":
        return pc.is_in(col, value_set=pa.array(list(value)))
    if op == "not in":
        return pc.invert(pc.is_in(col, value_set=pa.array(list(value))))
    raise ValueError(f"unknown filter op: {op}")
