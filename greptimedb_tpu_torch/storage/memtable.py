"""Time-partitioned columnar memtable.

Role-equivalent of the reference's memtables (reference
src/mito2/src/memtable/): buffered writes live in memory until flush.  The
reference keeps three builders (partition-tree, per-series, bulk); we keep a
single append-mode columnar memtable partitioned by time window (the
reference's `time_partition.rs` behavior), with last-write-wins dedup applied
on read/flush by a stable sort over (primary key, time index, sequence).
This matches the reference's `DedupReader` last-row semantics
(mito2/src/read/dedup.rs) while keeping ingestion append-only — the shape
that flushes to device-friendly columnar tiles.
"""

from __future__ import annotations

import threading

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..datatypes.schema import Schema

_SEQ_COL = "__seq"


def _partition_starts(ts: np.ndarray, window_ms: int) -> np.ndarray:
    return (ts // window_ms) * window_ms


class Memtable:
    """Append-only columnar buffer with time-window partitioning."""

    def __init__(self, schema: Schema, time_partition_ms: int = 86_400_000):
        self.schema = schema
        self.time_partition_ms = time_partition_ms
        self._chunks: list[pa.RecordBatch] = []
        self._seqs: list[np.ndarray] = []
        self._rows = 0
        self._bytes = 0
        self._lock = threading.Lock()
        self._min_ts: int | None = None
        self._max_ts: int | None = None

    # ---- write ------------------------------------------------------------
    def write(self, batch: pa.RecordBatch, sequence: int):
        """Append a batch stamped with a monotonically increasing sequence.

        The sequence plays the role of the reference's per-write `SequenceNumber`
        (store-api) — dedup keeps the highest sequence for identical
        (primary key, timestamp) rows.
        """
        ts_col = self.schema.time_index
        with self._lock:
            self._chunks.append(batch)
            self._seqs.append(np.full(batch.num_rows, sequence, dtype=np.int64))
            self._rows += batch.num_rows
            self._bytes += batch.nbytes
            if ts_col is not None and batch.num_rows:
                ts = batch.column(batch.schema.get_field_index(ts_col.name))
                mm = pc.min_max(ts)  # one pass, not two
                lo = mm["min"].cast(pa.int64()).as_py()
                hi = mm["max"].cast(pa.int64()).as_py()
                self._min_ts = lo if self._min_ts is None else min(self._min_ts, lo)
                self._max_ts = hi if self._max_ts is None else max(self._max_ts, hi)

    # ---- stats ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._rows

    @property
    def memory_usage(self) -> int:
        return self._bytes

    def is_empty(self) -> bool:
        return self._rows == 0

    def time_range(self) -> tuple[int, int] | None:
        if self._min_ts is None:
            return None
        return (self._min_ts, self._max_ts)

    # ---- read -------------------------------------------------------------
    def to_table(self, dedup: bool = True) -> pa.Table:
        """Materialize buffered rows sorted by (pk, ts), last write wins."""
        with self._lock:
            if not self._chunks:
                return self.schema.to_arrow().empty_table()
            table = pa.Table.from_batches(self._chunks, schema=self._chunks[0].schema)
            seq = pa.array(np.concatenate(self._seqs))
        table = table.append_column(_SEQ_COL, seq)
        table = _sort_and_dedup(table, self.schema, dedup=dedup)
        return table.drop_columns([_SEQ_COL])

    def scan(self, time_range: tuple[int, int] | None = None, dedup: bool = True) -> pa.Table:
        table = self.to_table(dedup=dedup)
        if time_range is not None and self.schema.time_index is not None:
            lo, hi = time_range
            ts_name = self.schema.time_index.name
            ts = pc.cast(table[ts_name], pa.int64())
            mask = pc.and_(pc.greater_equal(ts, lo), pc.less(ts, hi))
            table = table.filter(mask)
        return table

    def split_by_time_partition(self, dedup: bool = True) -> list[tuple[int, pa.Table]]:
        """Split into (window_start_ms, rows) — flush writes one SST per window
        so SSTs stay window-aligned for TWCS (reference
        mito2/src/memtable/time_partition.rs)."""
        table = self.to_table(dedup=dedup)
        ts_col = self.schema.time_index
        if table.num_rows == 0:
            return []
        if ts_col is None:
            return [(0, table)]
        ts = pc.cast(table[ts_col.name], pa.int64()).to_numpy(zero_copy_only=False)
        starts = _partition_starts(ts, self.time_partition_ms)
        out = []
        for start in np.unique(starts):
            mask = starts == start
            out.append((int(start), table.filter(pa.array(mask))))
        return out


def _sort_and_dedup(table: pa.Table, schema: Schema, dedup: bool) -> pa.Table:
    """Stable sort by (pk..., ts, seq) then keep the last row per (pk..., ts)."""
    keys = [c.name for c in schema.tag_columns()]
    ts_col = schema.time_index
    if ts_col is not None:
        keys.append(ts_col.name)
    if not keys:
        return table
    fast = _key_codes(table, keys)
    if fast is not None:
        # Vectorized fast path (the flush/scan hot shape: string tags +
        # int/timestamp keys): rank-encode each key column to int64 codes
        # ordering EXACTLY like arrow's ascending nulls-last comparator
        # (the small per-column dictionary is ranked BY arrow), then one
        # stable np.lexsort over the codes — string comparisons happen
        # O(distinct values), not O(rows log rows).
        msf, eq_cols = fast
        seq = np.asarray(
            table[_SEQ_COL].combine_chunks(), dtype=np.int64
        )
        order = np.lexsort(tuple(reversed(msf + [seq])))
        table = table.take(pa.array(order))
        if not dedup or table.num_rows <= 1:
            return table
        n = table.num_rows
        same = np.ones(n - 1, dtype=bool)
        for arr in eq_cols:
            a = arr[order]
            same &= a[:-1] == a[1:]
        keep = np.ones(n, dtype=bool)
        keep[:-1] = ~same
        return table.filter(pa.array(keep))
    sort_keys = [(k, "ascending") for k in keys] + [(_SEQ_COL, "ascending")]
    idx = pc.sort_indices(table, sort_keys=sort_keys)
    table = table.take(idx)
    if not dedup or table.num_rows <= 1:
        return table
    # Keep the LAST row of each equal-key run (highest sequence).
    n = table.num_rows
    same = np.ones(n - 1, dtype=bool)
    for k in keys:
        col = table[k].combine_chunks()
        arr = col.to_numpy(zero_copy_only=False)
        a, b = arr[:-1], arr[1:]
        if arr.dtype == object:
            eq = np.array([x == y for x, y in zip(a, b)], dtype=bool)
        else:
            eq = (a == b) | (_isnan(a) & _isnan(b))
        same &= eq
    keep = np.ones(n, dtype=bool)
    keep[:-1] = ~same  # row i dropped if identical key to row i+1 (later seq)
    return table.filter(pa.array(keep))


def _key_codes(table: pa.Table, keys: list[str]):
    """int64 code arrays ordering identically to arrow's ascending
    nulls-last sort over `keys`, or None when a column's type is not
    covered (floats etc. keep the arrow sort path).

    Returns (msf, eq_cols): `msf` = most-significant-first lexsort keys
    (a nullable int column contributes [is_null, value] so nulls land
    last); `eq_cols` = one pair-compare array per contributed key (code
    equality <=> arrow value equality, nulls equal each other — the
    dedup adjacency contract of the legacy loop)."""
    msf: list[np.ndarray] = []
    eq_cols: list[np.ndarray] = []
    for k in keys:
        col = table[k]
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        t = col.type
        if pa.types.is_dictionary(t):
            col = pc.cast(col, t.value_type)
            t = col.type
        if (pa.types.is_string(t) or pa.types.is_large_string(t)
                or pa.types.is_binary(t)):
            enc = pc.dictionary_encode(col)
            d = enc.dictionary
            # rank the (small) dictionary with ARROW's own comparator so
            # the code order is bit-identical to its string sort
            order = np.asarray(pc.sort_indices(d), dtype=np.int64)
            ranks = np.empty(len(d), dtype=np.int64)
            ranks[order] = np.arange(len(d), dtype=np.int64)
            idxs = np.asarray(pc.fill_null(enc.indices, -1), dtype=np.int64)
            if len(d) == 0:  # all-null column: one code for everything
                codes = np.zeros(len(idxs), dtype=np.int64)
            else:
                codes = np.where(
                    idxs >= 0,
                    ranks[np.clip(idxs, 0, len(d) - 1)],
                    np.int64(len(d)),  # nulls past every rank = nulls last
                )
            msf.append(codes)
            eq_cols.append(codes)
        elif (pa.types.is_integer(t) or pa.types.is_timestamp(t)
                or pa.types.is_boolean(t)):
            try:
                vals = np.asarray(
                    pc.fill_null(pc.cast(col, pa.int64()), 0), dtype=np.int64
                )
            except pa.ArrowInvalid:
                # uint64 values past 2^63 don't fit the code space —
                # keep the arrow sort path for this table
                return None
            if col.null_count:
                isnull = np.asarray(pc.is_null(col), dtype=np.int64)
                msf.append(isnull)  # nulls after values (ascending 0 < 1)
                msf.append(vals)
                # (value, is_null) pairs compare equal exactly when the
                # logical values do (null == null, null != 0)
                eq_cols.append(vals)
                eq_cols.append(isnull)
            else:
                msf.append(vals)
                eq_cols.append(vals)
        else:
            return None
    return msf, eq_cols


def _isnan(a: np.ndarray) -> np.ndarray:
    if np.issubdtype(a.dtype, np.floating):
        return np.isnan(a)
    return np.zeros(len(a), dtype=bool)


class TimeSeriesMemtable(Memtable):
    """Per-series write accumulation (reference
    mito2/src/memtable/time_series.rs `TimeSeriesMemtable`: one vector
    builder per primary key).  Batches are split by series at WRITE time
    into per-series buckets, so flush/scan concatenates pre-grouped runs
    instead of sorting the whole buffer — the right trade when series
    count is small relative to rows (dense scrape workloads), and the
    shape series_scan-style readers want.

    Read-side semantics are identical to the base memtable: sorted by
    (pk, ts), last-write-wins on (pk, ts) ties.
    """

    def __init__(self, schema: Schema, time_partition_ms: int = 86_400_000):
        super().__init__(schema, time_partition_ms)
        self._series: dict[tuple, list[pa.RecordBatch]] = {}
        self._series_seqs: dict[tuple, list[np.ndarray]] = {}
        self._pk_names = [c.name for c in schema.tag_columns()]

    def write(self, batch: pa.RecordBatch, sequence: int):
        ts_col = self.schema.time_index
        with self._lock:
            if not self._pk_names:
                key = ()
                self._series.setdefault(key, []).append(batch)
                self._series_seqs.setdefault(key, []).append(
                    np.full(batch.num_rows, sequence, dtype=np.int64)
                )
            else:
                # group rows by series key via dictionary codes (vectorized;
                # the reference hashes encoded primary keys the same way)
                import pyarrow.compute as _pc

                codes = None
                dicts = []
                for name in self._pk_names:
                    col = batch.column(batch.schema.get_field_index(name))
                    enc = _pc.dictionary_encode(col)
                    idxs = np.asarray(enc.indices, dtype=np.int64)
                    dicts.append(enc.dictionary.to_pylist())
                    codes = idxs if codes is None else codes * len(dicts[-1]) + idxs
                for code in np.unique(codes):
                    mask = codes == code
                    sub = batch.filter(pa.array(mask))
                    first = int(np.flatnonzero(mask)[0])
                    key = tuple(
                        batch.column(batch.schema.get_field_index(n))[first].as_py()
                        for n in self._pk_names
                    )
                    self._series.setdefault(key, []).append(sub)
                    self._series_seqs.setdefault(key, []).append(
                        np.full(sub.num_rows, sequence, dtype=np.int64)
                    )
            self._rows += batch.num_rows
            self._bytes += batch.nbytes
            if ts_col is not None and batch.num_rows:
                ts = batch.column(batch.schema.get_field_index(ts_col.name))
                mm = pc.min_max(ts)  # one pass, not two
                lo = mm["min"].cast(pa.int64()).as_py()
                hi = mm["max"].cast(pa.int64()).as_py()
                self._min_ts = lo if self._min_ts is None else min(self._min_ts, lo)
                self._max_ts = hi if self._max_ts is None else max(self._max_ts, hi)

    def to_table(self, dedup: bool = True) -> pa.Table:
        """Concatenate series in key order; each series sorts only its own
        rows by (ts, seq) — no global sort."""
        with self._lock:
            if not self._series:
                return self.schema.to_arrow().empty_table()
            items = sorted(self._series.items(), key=lambda kv: _series_sort_key(kv[0]))
            parts = []
            for key, chunks in items:
                t = pa.Table.from_batches(chunks, schema=chunks[0].schema)
                seq = pa.array(np.concatenate(self._series_seqs[key]))
                t = t.append_column(_SEQ_COL, seq)
                parts.append(t)
        out = []
        for t in parts:
            out.append(_sort_and_dedup_series(t, self.schema, dedup=dedup))
        merged = pa.concat_tables(out)
        return merged.drop_columns([_SEQ_COL])

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)


def _series_sort_key(key: tuple):
    # None sorts first, mirroring arrow's default null placement in the
    # base memtable's global sort
    return tuple((v is not None, v) for v in key)


def _sort_and_dedup_series(table: pa.Table, schema: Schema, dedup: bool) -> pa.Table:
    """Per-series (ts, seq) sort + last-write-wins on ts ties."""
    ts_col = schema.time_index
    if ts_col is None:
        return table
    idx = pc.sort_indices(
        table, sort_keys=[(ts_col.name, "ascending"), (_SEQ_COL, "ascending")]
    )
    table = table.take(idx)
    if not dedup or table.num_rows <= 1:
        return table
    ts = pc.cast(table[ts_col.name], pa.int64()).to_numpy(zero_copy_only=False)
    keep = np.ones(len(ts), dtype=bool)
    keep[:-1] = ts[:-1] != ts[1:]
    return table.filter(pa.array(keep))


class PartitionTreeMemtable(Memtable):
    """Primary-key-sharded buffers (reference
    mito2/src/memtable/partition_tree.rs `PartitionTreeMemtable`: a
    dictionary/shard tree over encoded primary keys).  Rows are routed to
    one of `num_shards` buckets by a hash of the pk columns at WRITE time;
    reads sort each (small) shard independently and merge — bounding sort
    working sets for high-cardinality key spaces where the per-series
    variant would explode into millions of tiny buckets.

    Read semantics identical to the base memtable: (pk, ts) sorted,
    last-write-wins."""

    def __init__(
        self, schema: Schema, time_partition_ms: int = 86_400_000, num_shards: int = 8
    ):
        super().__init__(schema, time_partition_ms)
        self.num_shards = num_shards
        self._shards: list[list[pa.RecordBatch]] = [[] for _ in range(num_shards)]
        self._shard_seqs: list[list[np.ndarray]] = [[] for _ in range(num_shards)]
        self._pk_names = [c.name for c in schema.tag_columns()]

    def write(self, batch: pa.RecordBatch, sequence: int):
        ts_col = self.schema.time_index
        with self._lock:
            if not self._pk_names:
                shard_ids = np.zeros(batch.num_rows, dtype=np.int64)
            else:
                import pyarrow.compute as _pc

                h = np.zeros(batch.num_rows, dtype=np.uint64)
                for name in self._pk_names:
                    col = batch.column(batch.schema.get_field_index(name))
                    enc = _pc.dictionary_encode(col)
                    # nulls encode as null indices: route them to a fixed
                    # salt instead of letting the uint64 cast wrap into an
                    # out-of-bounds gather
                    idxs = np.asarray(
                        _pc.fill_null(enc.indices, -1), dtype=np.int64
                    )
                    vals = enc.dictionary
                    salts = np.asarray(
                        [hash(v) & 0xFFFFFFFF for v in vals.to_pylist()] or [0],
                        dtype=np.uint64,
                    )
                    picked = np.where(
                        idxs >= 0,
                        salts[np.clip(idxs, 0, len(salts) - 1)],
                        np.uint64(0x9E3779B9),
                    )
                    h = h * np.uint64(1099511628211) + picked
                shard_ids = (h % np.uint64(self.num_shards)).astype(np.int64)
            for sid in np.unique(shard_ids):
                mask = shard_ids == sid
                sub = batch.filter(pa.array(mask))
                self._shards[int(sid)].append(sub)
                self._shard_seqs[int(sid)].append(
                    np.full(sub.num_rows, sequence, dtype=np.int64)
                )
            self._rows += batch.num_rows
            self._bytes += batch.nbytes
            if ts_col is not None and batch.num_rows:
                ts = batch.column(batch.schema.get_field_index(ts_col.name))
                mm = pc.min_max(ts)  # one pass, not two
                lo = mm["min"].cast(pa.int64()).as_py()
                hi = mm["max"].cast(pa.int64()).as_py()
                self._min_ts = lo if self._min_ts is None else min(self._min_ts, lo)
                self._max_ts = hi if self._max_ts is None else max(self._max_ts, hi)

    def to_table(self, dedup: bool = True) -> pa.Table:
        with self._lock:
            parts = []
            for sid in range(self.num_shards):
                if not self._shards[sid]:
                    continue
                t = pa.Table.from_batches(
                    self._shards[sid], schema=self._shards[sid][0].schema
                )
                t = t.append_column(
                    _SEQ_COL, pa.array(np.concatenate(self._shard_seqs[sid]))
                )
                parts.append(t)
        if not parts:
            return self.schema.to_arrow().empty_table()
        # each shard is small; the final concat needs a global sort
        # only across shard boundaries — cheaper: sort the concat of
        # per-shard-sorted runs (timsort-friendly) in one pass
        table = pa.concat_tables(parts, promote_options="permissive")
        table = _sort_and_dedup(table, self.schema, dedup=dedup)
        return table.drop_columns([_SEQ_COL])


class BulkMemtable(Memtable):
    """Bulk-ingestion parts (reference mito2/src/memtable/bulk/ +
    simple_bulk_memtable): large ingested batches are kept as immutable
    zero-copy PARTS — no per-write re-encoding or splitting — and only
    read-time materialization pays for sorting.  The right shape for
    Flight DoPut bulk loads where batches arrive large and pre-sorted."""

    # identical storage to the base memtable (whole-batch append, no
    # copies); the distinction the reference draws — write path does NO
    # per-row work — already holds, so this subclass exists to (a) name
    # the contract and (b) skip the dedup sort when parts declare
    # themselves internally sorted and non-overlapping.

    def to_table(self, dedup: bool = True) -> pa.Table:
        with self._lock:
            if not self._chunks:
                return self.schema.to_arrow().empty_table()
            if len(self._chunks) == 1 and not dedup:
                t = pa.Table.from_batches(self._chunks)
                # zero-copy only when the part IS (pk, ts)-sorted — the
                # streaming merge consumes memtable output as a sorted run
                if _is_key_sorted(t, self.schema):
                    return t
        return super().to_table(dedup=dedup)


def _is_key_sorted(t: pa.Table, schema: Schema) -> bool:
    """O(n) lexicographic non-decreasing check over (pk..., ts)."""
    keys = [c.name for c in schema.tag_columns()]
    if schema.time_index is not None:
        keys.append(schema.time_index.name)
    n = t.num_rows
    if n <= 1 or not keys:
        return True
    undecided = np.ones(n - 1, dtype=bool)  # adjacent pairs equal so far
    ok = np.ones(n - 1, dtype=bool)
    for name in keys:
        if name not in t.column_names:
            return False
        col = t[name].combine_chunks()
        a, b = col.slice(0, n - 1), col.slice(1)
        lt = np.asarray(pc.fill_null(pc.less(a, b), False))
        eq = np.asarray(pc.fill_null(pc.equal(a, b), False))
        bn = np.asarray(pc.and_(pc.is_null(a), pc.is_null(b)))
        an = np.asarray(pc.and_(pc.is_null(a), pc.invert(pc.is_null(b))))
        eq = eq | bn
        # nulls sort last: a null before a non-null is DESCENDING
        ok &= ~undecided | lt | eq
        ok &= ~(undecided & an)
        undecided &= eq
        if not ok.all():
            return False
    return bool(ok.all())


def make_memtable(schema: Schema, time_partition_ms: int, kind: str = "time_partition") -> Memtable:
    """Memtable builder selection (reference MemtableBuilderProvider,
    mito2/src/memtable/builder.rs): time_partition (default) |
    time_series (per-series vectors) | partition_tree (pk-sharded) |
    bulk (immutable bulk parts)."""
    if kind == "time_series":
        return TimeSeriesMemtable(schema, time_partition_ms)
    if kind == "partition_tree":
        return PartitionTreeMemtable(schema, time_partition_ms)
    if kind == "bulk":
        return BulkMemtable(schema, time_partition_ms)
    return Memtable(schema, time_partition_ms)
