"""Write buffer accounting + flush policy.

Role-equivalent of the reference's `WriteBufferManagerImpl`
(reference src/mito2/src/flush.rs:107): tracks global mutable memtable
memory, decides when the engine should flush (`should_flush_engine`,
flush.rs:152) and when writes must stall (`should_stall`, flush.rs:173).
"""

from __future__ import annotations

import threading


class WriteBufferManager:
    def __init__(self, global_limit_bytes: int, region_limit_bytes: int):
        self.global_limit = global_limit_bytes
        self.region_limit = region_limit_bytes
        self._mutable: dict[int, int] = {}  # region_id -> bytes
        # Bytes frozen for an in-flight flush encode (ingest.flush_overlap):
        # they left the mutable budget at freeze time so new writes keep
        # being admitted during the encode, but still count against the
        # hard 2x bound so a slow flush cannot let memory grow unbounded.
        self._flushing: dict[int, int] = {}
        self._lock = threading.Lock()

    def set_region_usage(self, region_id: int, bytes_: int):
        with self._lock:
            self._mutable[region_id] = bytes_

    def remove_region(self, region_id: int):
        with self._lock:
            self._mutable.pop(region_id, None)
            self._flushing.pop(region_id, None)

    def freeze_region(self, region_id: int, bytes_: int):
        """A flush froze `bytes_` of this region's memtable: move them
        from the mutable budget to the flushing bucket (called under the
        region lock, at the same instant the fresh memtable is swapped in)."""
        with self._lock:
            self._flushing[region_id] = self._flushing.get(region_id, 0) + bytes_
            cur = self._mutable.get(region_id, 0)
            self._mutable[region_id] = max(0, cur - bytes_)

    def unfreeze_region(self, region_id: int, bytes_: int):
        """The flush encode finished (committed or discarded): release the
        frozen bytes."""
        with self._lock:
            left = self._flushing.get(region_id, 0) - bytes_
            if left > 0:
                self._flushing[region_id] = left
            else:
                self._flushing.pop(region_id, None)

    def mutable_usage(self) -> int:
        with self._lock:
            return sum(self._mutable.values())

    def region_usage(self, region_id: int) -> int:
        with self._lock:
            return self._mutable.get(region_id, 0)

    def should_flush_region(self, region_id: int) -> bool:
        return self.region_usage(region_id) >= self.region_limit

    def should_flush_engine(self) -> bool:
        # Reference flushes when global mutable usage crosses 7/8 of limit.
        return self.mutable_usage() >= self.global_limit * 7 // 8

    def should_stall(self) -> bool:
        with self._lock:
            mutable = sum(self._mutable.values())
            flushing = sum(self._flushing.values())
        # Mutable alone over the limit stalls (the pre-overlap rule); with
        # flush overlap the frozen bytes no longer count as mutable, so
        # ingest keeps running during an encode — until total memory
        # (mutable + in-flight flush) hits the 2x hard bound.
        return (
            mutable >= self.global_limit
            or mutable + flushing >= self.global_limit * 2
        )

    def pick_flush_candidates(self) -> list[int]:
        """Regions to flush, largest first (greedy pressure relief)."""
        with self._lock:
            return [
                rid
                for rid, b in sorted(self._mutable.items(), key=lambda kv: -kv[1])
                if b > 0
            ]
