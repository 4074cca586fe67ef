"""TimeSeriesEngine: the region engine facade.

Counterpart of `greptimedb_tpu/storage/engine.py`: create/open/close/drop
regions, route writes and flushes, serve scans.  Flush pressure is driven
by a `WriteBufferManager` (per-region and global thresholds).  This port
keeps the local WAL and the filesystem object store; threshold flushes run
synchronously on the writing thread.  The remote WALs, the background
flush/compaction schedulers, the sharded write workers and follower
replicas are cut (listed in ROADMAP.md).
"""

from __future__ import annotations

import os
import shutil
import threading

import pyarrow as pa

from ..datatypes.schema import Schema
from ..utils.config import StorageConfig
from ..utils.errors import RegionNotFoundError
from .flush import WriteBufferManager
from .object_store import FsObjectStore
from .region import Region
from .sst import ScanPredicate
from .wal import WalManager


class TimeSeriesEngine:
    def __init__(self, config: StorageConfig | None = None):
        self.config = config or StorageConfig()
        os.makedirs(self.config.data_home, exist_ok=True)
        # SSTs + manifests live behind the object-store abstraction; the
        # WAL is a local append log.
        self.object_store = FsObjectStore(self.config.effective_sst_dir())
        self.wal_mgr = WalManager(
            self.config.effective_wal_dir(), fsync=self.config.wal_fsync
        )
        self.buffer_mgr = WriteBufferManager(
            global_limit_bytes=self.config.global_write_buffer_size_mb << 20,
            region_limit_bytes=self.config.write_buffer_size_mb << 20,
        )
        self._regions: dict[int, Region] = {}
        self._lock = threading.Lock()

    # ---- region lifecycle -------------------------------------------------
    def create_region(
        self, region_id: int, schema: Schema, writable: bool = True,
        append_mode: bool = False, memtable_kind: str | None = None,
        merge_mode: str | None = None,
    ) -> Region:
        with self._lock:
            if region_id in self._regions:
                return self._regions[region_id]
            region = self._new_region(
                region_id, schema, writable, append_mode, memtable_kind, merge_mode
            )
            self._regions[region_id] = region
            return region

    def open_region(
        self, region_id: int, append_mode: bool = False, memtable_kind: str | None = None,
        merge_mode: str | None = None,
    ) -> Region:
        """Open an existing region from its manifest + WAL (crash recovery)."""
        with self._lock:
            if region_id in self._regions:
                return self._regions[region_id]
            if not self._region_store(region_id).list("manifest"):
                raise RegionNotFoundError(f"region {region_id} has no manifest")
            region = self._new_region(
                region_id,
                Schema(columns=[]),  # overwritten by manifest recovery
                True, append_mode, memtable_kind, merge_mode,
            )
            self._regions[region_id] = region
            return region

    def _new_region(
        self, region_id, schema, writable, append_mode, memtable_kind, merge_mode
    ) -> Region:
        region = Region(
            region_id,
            self._region_store(region_id),
            schema,
            self.wal_mgr.region_wal(region_id),
            time_partition_ms=self.config.memtable_time_partition_secs * 1000,
            checkpoint_distance=self.config.manifest_checkpoint_distance,
            writable=writable,
            append_mode=append_mode,
            merge_mode=merge_mode,
            memtable_kind=memtable_kind or self.config.memtable_kind,
            flush_workers=self.config.ingest_flush_workers,
        )
        # flush overlap: freezing a memtable moves its bytes out of the
        # mutable budget for the duration of the encode
        region.buffer_mgr = self.buffer_mgr
        return region

    def close_region(self, region_id: int):
        with self._lock:
            self._regions.pop(region_id, None)
        self.buffer_mgr.remove_region(region_id)

    def drop_region(self, region_id: int):
        self.close_region(region_id)
        self.wal_mgr.drop_region(region_id)
        store = self._region_store(region_id)
        for sub in ("manifest", "sst"):
            view = store.scoped(sub)
            for name in view.list():
                view.delete(name)
        shutil.rmtree(self._region_dir(region_id), ignore_errors=True)

    def region(self, region_id: int) -> Region:
        region = self._regions.get(region_id)
        if region is None:
            raise RegionNotFoundError(f"region {region_id} not found")
        return region

    def region_ids(self) -> list[int]:
        with self._lock:
            return list(self._regions)

    # ---- request routing --------------------------------------------------
    def write(self, region_id: int, batch: pa.RecordBatch) -> int:
        region = self.region(region_id)
        if self.buffer_mgr.should_stall():
            # Under pressure: flush the biggest offenders synchronously
            # instead of rejecting (single-process analogue of stalling).
            for rid in self.buffer_mgr.pick_flush_candidates():
                self.flush_region(rid)
                if not self.buffer_mgr.should_stall():
                    break
        rows = region.write(batch)
        self.buffer_mgr.set_region_usage(region_id, region.memtable.memory_usage)
        if (
            self.buffer_mgr.should_flush_region(region_id)
            or self.buffer_mgr.should_flush_engine()
        ):
            self.flush_region(region_id)
        return rows

    def flush_region(self, region_id: int):
        region = self._regions.get(region_id)
        if region is None:
            return
        region.flush()
        self.buffer_mgr.set_region_usage(region_id, region.memtable.memory_usage)

    def flush_all(self):
        for rid in self.region_ids():
            self.flush_region(rid)

    def scan(
        self,
        region_id: int,
        pred: ScanPredicate | None = None,
        columns: list[str] | None = None,
    ) -> pa.Table:
        return self.region(region_id).scan(pred, columns)

    # ---- helpers ----------------------------------------------------------
    def _region_dir(self, region_id: int) -> str:
        return os.path.join(self.config.effective_sst_dir(), f"region_{region_id}")

    def _region_store(self, region_id: int):
        return self.object_store.scoped(f"region_{region_id}")

    def close(self):
        self.wal_mgr.close()
