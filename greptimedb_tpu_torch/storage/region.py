"""Region: the unit of storage, replication and scan parallelism.

Role-equivalent of the reference's `MitoRegion` (reference
src/mito2/src/region.rs:121) plus its opener (region/opener.rs): a region
owns a WAL stream, an active memtable, a set of immutable SSTs tracked by a
manifest, and a monotonically increasing sequence number.  Writes go
WAL-then-memtable (reference worker/handle_write.rs:83-135); flush turns the
memtable into time-window-aligned SSTs and advances `flushed_entry_id` so
the WAL can be truncated; open replays manifest then WAL from
`flushed_entry_id` (reference region/opener.rs:500-516).

Concurrency model: like the reference's single-writer-per-region actor
(worker.rs:459), all mutations take the region write lock; scans only read
immutable snapshots (memtable materialization + SST list copy).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pyarrow as pa

from ..datatypes.schema import Schema
from ..utils.errors import IllegalStateError, RegionReadonlyError
from .manifest import ManifestManager
from .memtable import Memtable, make_memtable
from .sst import FileMeta, ScanPredicate, SstReader, SstWriter
from .wal import RegionWal

# Per-row operation marker carried through memtable, WAL and SSTs
# (reference api::v1::OpType / mito2 key-value op types): 0 = put,
# 1 = delete tombstone.  Tombstones win dedup (they carry a later
# sequence) and are dropped from scan output; they persist through
# flush/compaction so deletes survive restarts and file merges.
OP_COL = "__op"
OP_PUT = 0
OP_DELETE = 1


class Region:
    def __init__(
        self,
        region_id: int,
        region_dir: str,
        schema: Schema,
        wal: RegionWal,
        *,
        time_partition_ms: int = 86_400_000,
        checkpoint_distance: int = 10,
        writable: bool = True,
        append_mode: bool = False,
        merge_mode: str | None = None,
        memtable_kind: str = "time_partition",
        flush_workers: int = 1,
    ):
        from .object_store import FsObjectStore, ObjectStore

        self.region_id = region_id
        # `region_dir` may be a local path (standalone default) or an
        # ObjectStore view for this region (reference: SSTs+manifest live on
        # object storage; only the WAL is local).
        if isinstance(region_dir, ObjectStore):
            self.store: ObjectStore = region_dir
            self.region_dir = None
        else:
            self.store = FsObjectStore(region_dir)
            self.region_dir = region_dir
        self.wal = wal
        self.time_partition_ms = time_partition_ms
        self._lock = threading.RLock()
        self.writable = writable
        # Dedup strategy (reference mito2 `merge_mode` table option):
        # "last_row" keeps the newest version whole; "last_non_null"
        # merges fieldwise — the newest NON-NULL value per field wins
        # (read/dedup.rs LastNonNull).
        self.merge_mode = merge_mode or "last_row"
        # Append-only mode (reference mito2 `append_mode` table option):
        # duplicates are kept (no last-write-wins dedup) and DELETE is
        # rejected — the shape log/trace workloads want, and the condition
        # under which the device tile cache can aggregate SSTs directly.
        self.append_mode = append_mode

        self.manifest_mgr = ManifestManager(self.store, region_id, checkpoint_distance)
        if self.manifest_mgr.manifest.schema is None:
            self.manifest_mgr.apply({"kind": "change", "schema": schema.to_json()})
        self.schema = self.manifest_mgr.manifest.schema
        sst_store = self.store.scoped("sst")
        self.sst_writer = SstWriter(sst_store, self.schema)
        self.sst_reader = SstReader(sst_store, self.schema)

        self.memtable_kind = memtable_kind
        self.memtable = make_memtable(self.schema, time_partition_ms, memtable_kind)
        # Frozen memtables: flushed but whose SSTs are not yet committed to the
        # manifest; readable by scans so flush never opens a visibility gap.
        self._frozen_memtables: list[Memtable] = []
        # SSTs removed from the manifest but not yet safe to delete (readers
        # in flight may hold the old file list); purged when readers drain.
        # (file_id, tombstoned_at): physical deletion waits out BOTH
        # local in-flight scans AND a wall-clock grace, because ANOTHER
        # region holder (transient split-brain during failover, or a
        # second process on shared storage) may still scan from an older
        # manifest snapshot that references these files (the reference's
        # file purger + object-store GC grace plays the same role)
        self._garbage_files: list[tuple[str, float]] = []
        self.gc_grace_secs: float = 60.0
        self._active_scans = 0
        self.sequence = self.manifest_mgr.manifest.flushed_sequence
        # Future WAL entry ids must exceed the flush watermark, else writes
        # after an obsolete()+restart would replay below it and be lost.
        self.wal.advance_to(
            max(
                self.manifest_mgr.manifest.flushed_entry_id,
                self.manifest_mgr.manifest.truncated_entry_id or 0,
            )
        )
        # Replay progress marker: the highest WAL entry id applied to this
        # region's memtable.
        self.applied_entry_id = 0
        # Pipelined ingest: parallel per-SST flush encode pool width, the
        # optional write-buffer freeze hook (set by the engine when
        # ingest.flush_overlap is on — flush moves the frozen memtable's
        # bytes out of the mutable budget so writes keep flowing during
        # the encode), and the last write's per-stage wall (wal/memtable
        # ms — the write.region span attrs; single-writer-per-region makes
        # the unlocked read safe).
        # clamp to REAL cores: on a 1-core box the pool (and the window
        # slicing keyed off it) is pure overhead — more files, more index
        # builds, zero parallelism
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:  # non-linux
            cores = os.cpu_count() or 1
        self.flush_workers = max(1, min(flush_workers, cores))
        self.buffer_mgr = None
        self.last_write_stage_ms: dict = {}
        self._conform_cache: tuple | None = None
        self._replay_wal()

    # ---- open/replay ------------------------------------------------------
    def _replay_wal(self):
        """Replay WAL entries newer than flushed_entry_id into the memtable."""
        flushed = self.manifest_mgr.manifest.flushed_entry_id
        truncated = self.manifest_mgr.manifest.truncated_entry_id or 0
        start = max(flushed, truncated)
        last = start
        replayed = 0
        for entry in self.wal.replay(start):
            self.sequence += 1
            self.memtable.write(self._conform(entry.batch), self.sequence)
            last = entry.entry_id
            replayed += entry.batch.num_rows
        self.applied_entry_id = last
        return replayed

    # ---- write ------------------------------------------------------------
    def write(self, batch: pa.RecordBatch) -> int:
        """WAL append then memtable insert; returns affected rows."""
        with self._lock:
            # the writable check lives INSIDE the lock: set_writable(False)
            # (migration downgrade) takes the same lock, so once the fence
            # returns, no in-flight write can still append to the WAL the
            # migration candidate is about to replay
            if not self.writable:
                raise RegionReadonlyError(f"region {self.region_id} is read-only")
            batch = self._conform(batch)
            t0 = time.perf_counter()
            self.wal.append(batch)
            t1 = time.perf_counter()
            self.sequence += 1
            self.memtable.write(batch, self.sequence)
            t2 = time.perf_counter()
            self.applied_entry_id = self.wal.last_entry_id
        wal_ms, mem_ms = (t1 - t0) * 1000, (t2 - t1) * 1000
        self.last_write_stage_ms = {"wal": wal_ms, "memtable": mem_ms}
        return batch.num_rows

    def _conform(self, batch: pa.RecordBatch) -> pa.RecordBatch:
        """Project a write onto the region's current schema (+ the __op
        marker): a batch built against an older (narrower) schema gets nulls
        for columns added by a concurrent ALTER, puts without a marker get
        __op=0, and columns come out in schema order so every memtable chunk
        shares one schema (the reference's write-compat shim,
        mito2/src/read/compat.rs, does this on read instead)."""
        cache = self._conform_cache
        if cache is None or cache[0] is not self.schema:
            # keyed on schema object identity: ALTER/manifest refresh swap
            # the Schema instance, invalidating the cached Arrow target
            target = self.schema.to_arrow().append(pa.field(OP_COL, pa.int8()))
            self._conform_cache = (self.schema, target)
        else:
            target = cache[1]
        if batch.schema.equals(target):
            return batch
        n = batch.num_rows
        arrays = []
        for f in target:
            i = batch.schema.get_field_index(f.name)
            if i >= 0:
                col = batch.column(i)
                arrays.append(col if col.type == f.type else col.cast(f.type))
            elif f.name == OP_COL:
                arrays.append(pa.array(np.zeros(n, dtype=np.int8)))
            else:
                arrays.append(pa.nulls(n, f.type))
        return pa.RecordBatch.from_arrays(arrays, schema=target)

    def delete(self, keys: pa.Table | pa.RecordBatch) -> int:
        """Delete by key: `keys` carries the primary-key + time-index columns
        of the rows to remove.  Writes tombstone rows (__op=1) through the
        normal WAL/memtable path — _conform null-fills the field columns —
        and dedup hides the victims immediately (reference mito2 handles
        OpType::Delete the same way)."""
        if self.append_mode:
            from ..utils.errors import UnsupportedError

            raise UnsupportedError("DELETE is not supported on append_mode tables")
        if isinstance(keys, pa.Table):
            keys = keys.combine_chunks()
            batches = keys.to_batches()
        else:
            batches = [keys]
        deleted = 0
        for b in batches:
            if b.num_rows == 0:
                continue
            op = pa.array(np.full(b.num_rows, OP_DELETE, dtype=np.int8))
            self.write(b.append_column(pa.field(OP_COL, pa.int8()), op))
            deleted += b.num_rows
        return deleted

    # ---- flush ------------------------------------------------------------
    def flush(self) -> list[FileMeta]:
        """Freeze the memtable, write one SST per time window, commit the
        manifest edit, truncate WAL.  The frozen memtable stays scannable
        (in _frozen_memtables) until the manifest edit lands, so concurrent
        scans never see the flush-in-progress rows vanish."""
        with self._lock:
            if self.memtable.is_empty():
                return []
            frozen = self.memtable
            frozen_bytes = frozen.memory_usage
            frozen_entry_id = self.wal.last_entry_id
            frozen_sequence = self.sequence
            self.memtable = make_memtable(self.schema, self.time_partition_ms, self.memtable_kind)
            self._frozen_memtables.append(frozen)
            if self.buffer_mgr is not None:
                # flush overlap (ingest.flush_overlap): the frozen bytes
                # leave the MUTABLE budget now, so new writes are admitted
                # while this encode runs; the flushing bucket keeps the
                # total bounded (see WriteBufferManager.should_stall)
                self.buffer_mgr.freeze_region(self.region_id, frozen_bytes)
        try:
            added = self._encode_sst_windows(frozen)
        finally:
            if self.buffer_mgr is not None:
                self.buffer_mgr.unfreeze_region(self.region_id, frozen_bytes)
        with self._lock:
            truncated = self.manifest_mgr.manifest.truncated_entry_id or 0
            if truncated >= frozen_entry_id:
                # a TRUNCATE landed while the SSTs were being written: the
                # frozen rows are logically gone — discard the files instead
                # of committing them (the reference versions flushes against
                # the truncate watermark the same way)
                if frozen in self._frozen_memtables:
                    self._frozen_memtables.remove(frozen)
                self._garbage_files.extend(
                (m.file_id, time.time()) for m in added
            )
                self._purge_garbage_locked()
                return []
            self.manifest_mgr.apply(
                {
                    "kind": "edit",
                    "files_to_add": [m.to_dict() for m in added],
                    "files_to_remove": [],
                    "flushed_entry_id": frozen_entry_id,
                    "flushed_sequence": frozen_sequence,
                }
            )
            self._frozen_memtables.remove(frozen)
        self.wal.obsolete(frozen_entry_id)
        return added

    # Rows per SST slice when one time window dominates a flush: a
    # window's sorted run splits into consecutive slices (disjoint key
    # ranges by construction) so the encode pool has work even when the
    # whole flush lands in ONE window (the TSBS shape: days-wide
    # partitions, minutes-wide flushes).
    _FLUSH_SLICE_ROWS = 1 << 20

    def _encode_sst_windows(self, frozen: Memtable) -> list[FileMeta]:
        """Encode the frozen memtable's time windows into SSTs — in
        parallel over `flush_workers` (ingest.flush_workers; Parquet
        encode and index builds release the GIL, so the pool overlaps
        real work).  Big single-window flushes slice their sorted run
        into consecutive ~1M-row SSTs: slices of a sorted table cover
        disjoint (pk, ts) ranges, so downstream merge/dedup treats them
        exactly like any other L0 run split.  Output order stays window
        order (slices in run order), so manifest positions are
        deterministic."""
        parts = frozen.split_by_time_partition(
            # last_non_null must NOT last-row-dedup on flush: older
            # versions' non-null fields are still live until the READ-side
            # fieldwise merge combines them
            dedup=not self.append_mode and self.merge_mode != "last_non_null"
        )
        tables: list[pa.Table] = []
        for _w, t in parts:
            if (self.flush_workers > 1
                    and t.num_rows > 2 * self._FLUSH_SLICE_ROWS):
                step = self._FLUSH_SLICE_ROWS
                tables.extend(
                    t.slice(off, step) for off in range(0, t.num_rows, step)
                )
            else:
                tables.append(t)
        if self.flush_workers > 1 and len(tables) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(self.flush_workers, len(tables)),
                thread_name_prefix=f"flush-encode-{self.region_id}",
            ) as ex:
                metas = list(ex.map(
                    lambda t: self.sst_writer.write(t, level=0), tables
                ))
        else:
            metas = [self.sst_writer.write(t, level=0) for t in tables]
        return [m for m in metas if m is not None]

    def _purge_garbage_locked(self):
        if self._active_scans > 0 or not self._garbage_files:
            return
        now = time.time()
        keep: list[tuple[str, float]] = []
        for fid, t0 in self._garbage_files:
            if now - t0 >= self.gc_grace_secs:
                self.sst_reader.delete(fid)
            else:
                keep.append((fid, t0))
        self._garbage_files = keep

    # ---- read -------------------------------------------------------------
    def scan(
        self,
        pred: ScanPredicate | None = None,
        columns: list[str] | None = None,
    ) -> pa.Table:
        """Snapshot scan: SSTs (pruned) + frozen + active memtables, dedup
        last-write-wins across sources.  Memtable rows shadow SST rows for
        equal (pk, ts) because they carry later sequences."""
        pred = pred or ScanPredicate()
        with self._lock:
            files = list(self.manifest_mgr.manifest.files.values())
            mems = list(self._frozen_memtables) + [self.memtable]
            self._active_scans += 1
        try:
            # Filters on key columns (tags + time index) are dedup-safe for
            # pruning/pre-filtering: a newer version of a row (overwrite or
            # tombstone) has the same key, so both versions pass or fail
            # together.  Filters on FIELD columns must wait until after
            # cross-source dedup — a stale SST row could pass a field filter
            # while its memtable replacement (new value / tombstone with null
            # fields) fails it, resurrecting overwritten data (the reference
            # orders DedupReader before filter eval the same way).
            key_cols = set(c.name for c in self.schema.tag_columns())
            if self.schema.time_index is not None:
                key_cols.add(self.schema.time_index.name)
            key_filters = [f for f in pred.filters if f[0] in key_cols]
            post_filters = [f for f in pred.filters if f[0] not in key_cols]
            # append_mode has no dedup, so FIELD filters (incl. fulltext
            # match) may prune files/segments too — dropping a non-matching
            # row can never resurrect an older version when versions don't
            # shadow each other (the logs fast path: matches() + fulltext
            # index pruning before any Parquet decode)
            prune_filters = list(pred.filters) if self.append_mode else key_filters
            prune_pred = ScanPredicate(time_range=pred.time_range, filters=prune_filters)

            # Projection pushdown: read only requested columns plus the
            # pk/ts/__op columns dedup needs; final select() trims extras.
            read_cols = None
            if columns:
                need = list(dict.fromkeys(columns))
                for c in self.schema.primary_key():
                    if c not in need:
                        need.append(c)
                if self.schema.time_index and self.schema.time_index.name not in need:
                    need.append(self.schema.time_index.name)
                for name, _op, _v in pred.filters:
                    if self.schema.has_column(name) and name not in need:
                        need.append(name)
                need.append(OP_COL)
                read_cols = need
            tables = []
            for meta in self.sst_reader.prune_files(files, prune_pred):
                t = self.sst_reader.read(meta, prune_pred, columns=read_cols)
                if t.num_rows:
                    tables.append(self._compat_cast(_undict(t)))
            n_sst_tables = len(tables)
            from .sst import _apply_residual

            ts_name = self.schema.time_index.name if self.schema.time_index else None
            mem_rows = 0
            keep_versions = self.merge_mode == "last_non_null"
            for mem in mems:
                mem_table = mem.scan(
                    pred.time_range,
                    dedup=not self.append_mode and not keep_versions,
                )
                if mem_table.num_rows:
                    mem_table = _apply_residual(mem_table, prune_pred, ts_name)
                if mem_table.num_rows:
                    if read_cols:
                        mem_table = mem_table.select(
                            [c for c in read_cols if c in mem_table.column_names]
                        )
                    mem_rows += mem_table.num_rows
                    tables.append(_undict(mem_table))
            if not tables:
                out = self.schema.to_arrow().empty_table()
            else:
                out = pa.concat_tables(tables, promote_options="permissive")
                out = self._dedup_across_sources(
                    out,
                    had_multiple=len(tables) > 1
                    or (n_sst_tables and mem_rows)
                    or self.merge_mode == "last_non_null",
                )
                out = self._drop_tombstones(out)
                if post_filters:
                    out = _apply_residual(
                        out, ScanPredicate(filters=post_filters), None
                    )
            # schema evolution: columns added by ALTER after this data was
            # written materialize as NULL (reference mito2/src/read/compat.rs
            # fills missing columns with default vectors at read)
            for c in self.schema.columns:
                if c.name not in out.column_names:
                    out = out.append_column(
                        c.name, pa.nulls(out.num_rows, c.data_type.to_arrow())
                    )
            if columns:
                out = out.select([c for c in columns if c in out.column_names])
            else:
                # normalize to the CURRENT schema: old SSTs may still carry
                # columns dropped by ALTER
                want = [c for c in self.schema.column_names() if c in out.column_names]
                if want != out.column_names:
                    out = out.select(want)
            return out
        finally:
            with self._lock:
                self._active_scans -= 1
                self._purge_garbage_locked()

    def _compat_cast(self, table: pa.Table) -> pa.Table:
        """Adapt an old SST to the CURRENT schema (reference
        mito2/src/read/compat.rs): cast columns to the declared type after
        ALTER ... MODIFY COLUMN, and null out name-collisions whose stored
        column_id differs — data of a DROPped column must not resurrect when
        a new column reuses its name."""
        import pyarrow.compute as pc

        for col in self.schema.columns:
            i = table.schema.get_field_index(col.name)
            if i < 0:
                continue
            fmeta = table.schema.field(i).metadata or {}
            stored_id = int(fmeta.get(b"greptime:column_id", 0))
            want = col.data_type.to_arrow()
            if stored_id and col.column_id and stored_id != col.column_id:
                table = table.set_column(
                    i, col.to_arrow(), pa.nulls(table.num_rows, want)
                )
            elif table.schema.field(i).type != want:
                table = table.set_column(
                    i, col.name, pc.cast(table.column(i), want)
                )
        return table

    @staticmethod
    def _drop_tombstones(table: pa.Table) -> pa.Table:
        """Remove delete markers from scan output (rows from pre-__op files
        have a null marker and count as puts)."""
        if OP_COL not in table.column_names:
            return table
        import pyarrow.compute as pc

        op = pc.fill_null(pc.cast(table[OP_COL], pa.int8()), OP_PUT)
        table = table.filter(pc.equal(op, OP_PUT))
        return table.drop_columns([OP_COL])

    def _dedup_across_sources(self, table: pa.Table, had_multiple: bool) -> pa.Table:
        if not had_multiple or table.num_rows <= 1:
            return table
        # Order sources oldest->newest (SSTs then memtable appended last);
        # reuse memtable sort+dedup with the append order as sequence.
        # append_mode keeps duplicates but still sorts by (pk, ts) so
        # downstream consumers (PromQL, range kernels) see ordered series.
        import numpy as np

        if self.merge_mode == "last_non_null" and not self.append_mode:
            from .merge import _SEQ, _dedup_chunk

            key_cols = [c.name for c in self.schema.tag_columns()]
            if self.schema.time_index is not None:
                key_cols.append(self.schema.time_index.name)
            seq = pa.array(np.arange(table.num_rows, dtype=np.int64))
            table = table.append_column(_SEQ, seq)
            return _dedup_chunk(table, key_cols, self.schema, True, "last_non_null")

        from .memtable import _SEQ_COL, _sort_and_dedup

        seq = pa.array(np.arange(table.num_rows, dtype=np.int64))
        table = table.append_column(_SEQ_COL, seq)
        table = _sort_and_dedup(table, self.schema, dedup=not self.append_mode)
        return table.drop_columns([_SEQ_COL])


    # ---- admin ------------------------------------------------------------
    def truncate(self):
        with self._lock:
            entry_id = self.wal.last_entry_id
            dropped = list(self.manifest_mgr.manifest.files)
            self.manifest_mgr.apply({"kind": "truncate", "truncated_entry_id": entry_id})
            self.memtable = make_memtable(self.schema, self.time_partition_ms, self.memtable_kind)
            # frozen memtables hold pre-truncate rows an in-flight flush froze;
            # drop them so scans stop seeing truncated data immediately (the
            # flush itself discards its SSTs when it observes the watermark)
            self._frozen_memtables.clear()
            self.wal.obsolete(entry_id)
            # the truncated SSTs are unreferenced now; reclaim them once
            # in-flight scans drain (same deferred purge as compaction)
            self._garbage_files.extend((fid, time.time()) for fid in dropped)
            self._purge_garbage_locked()

    def files(self) -> list[FileMeta]:
        with self._lock:
            return list(self.manifest_mgr.manifest.files.values())


def _undict(table: pa.Table) -> pa.Table:
    """Decode dictionary columns back to plain values for cross-file concat."""
    import pyarrow.compute as pc

    for i, f in enumerate(table.schema):
        if pa.types.is_dictionary(f.type):
            table = table.set_column(i, f.name, pc.cast(table[f.name], f.type.value_type))
    return table
