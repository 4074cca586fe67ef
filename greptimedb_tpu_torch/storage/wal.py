"""Write-ahead log: per-region append log with CRC-framed Arrow IPC entries.

Role-equivalent of the reference's local WAL (`RaftEngineLogStore`,
reference src/log-store/src/raft_engine/log_store.rs) behind the `LogStore`
trait (reference src/store-api/src/logstore.rs:51): append_batch, read from
an entry id, obsolete up to an entry id.  One log file per region; entries
are length+CRC32C framed so torn tails are detected and dropped on replay,
matching raft-engine's recovery behavior.

Frame layout (little-endian):
    [u32 payload_len][u32 crc32(payload)][u64 entry_id][payload bytes]
payload = Arrow IPC stream of one RecordBatch (the write's rows).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from dataclasses import dataclass

import pyarrow as pa

from ..utils.errors import StorageError

_HEADER = struct.Struct("<IIQ")

# Group-commit frames (ingest.group_commit): ONE frame carries a whole
# region-worker drain group — one Arrow IPC encode, one write syscall, one
# optional fsync — while every write in the group keeps its own entry id.
# The header's entry_id field carries the LAST id of the group with this
# bit set (bit 62, not 63: ids stay positive in
# signed int64 slots); the payload leads with [u32 n][u32 rows_i]* then one IPC
# stream of the concatenated rows.  Replay slices the decoded batch back
# into per-write entries, so everything downstream of replay — recovery,
# follower lag accounting, shared-WAL pruning — sees the same entries as
# frame-per-write.  A torn tail drops the WHOLE group (all-or-nothing),
# exactly like a torn solo frame drops its write.
GROUP_FLAG = 1 << 62
_GROUP_HEAD = struct.Struct("<I")


@dataclass
class WalEntry:
    entry_id: int
    batch: pa.RecordBatch


def _encode_batch(batch: pa.RecordBatch) -> pa.Buffer:
    """One IPC stream encode into an arrow Buffer — no BytesIO copy, and
    callers write header and payload as separate syscalls instead of
    concatenating (a 200 MB batch used to pay THREE extra full copies
    per append).  The Buffer supports len()/crc32/file.write directly."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue()


def _decode_batch(payload: bytes) -> pa.RecordBatch:
    with pa.ipc.open_stream(io.BytesIO(payload)) as r:
        batches = list(r)
    if len(batches) != 1:
        raise StorageError(f"wal payload contained {len(batches)} batches")
    return batches[0]


def _decode_group(payload: bytes) -> list[pa.RecordBatch]:
    """Decode a group-commit frame (written by a group-committing WAL, e.g.
    the reference package's): one decode, zero-copy per-write slices."""
    (n,) = _GROUP_HEAD.unpack_from(payload, 0)
    off = _GROUP_HEAD.size
    rows = []
    for _ in range(n):
        (r,) = _GROUP_HEAD.unpack_from(payload, off)
        rows.append(r)
        off += _GROUP_HEAD.size
    merged = _decode_batch(payload[off:])
    out, pos = [], 0
    for r in rows:
        out.append(merged.slice(pos, r))
        pos += r
    return out


def _frame_entry_ids(buf: bytes):
    """Entry ids of the intact frames of a WAL file image, in order."""
    pos = 0
    while pos + _HEADER.size <= len(buf):
        length, crc, entry_id = _HEADER.unpack_from(buf, pos)
        start = pos + _HEADER.size
        if start + length > len(buf):
            break
        if zlib.crc32(buf[start : start + length]) != crc:
            break
        yield entry_id
        pos = start + length


class RegionWal:
    """Append log for a single region (one file, single writer)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._file = open(path, "ab")
        # Recover last_entry_id by walking frame headers only (no Arrow
        # decode); stops at a torn tail like replay() does.
        self.last_entry_id = 0
        for entry_id in self._scan_entry_ids():
            self.last_entry_id = entry_id

    def _scan_entry_ids(self):
        # Pure-Python frame scan: validates lengths + CRCs and stops at a
        # torn tail, like replay().
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        for entry_id in _frame_entry_ids(buf):
            # a group frame's header carries the LAST id of its group, so
            # masking the flag keeps last-entry-id recovery exact
            yield entry_id & ~GROUP_FLAG

    def advance_to(self, entry_id: int):
        """Ensure future entry ids exceed `entry_id`.  Called on region open
        with the manifest's flushed_entry_id: after obsolete() empties the
        log, a restart must not reissue ids at or below the flush watermark
        (they would be skipped by replay-from-flushed on the next recovery)."""
        with self._lock:
            self.last_entry_id = max(self.last_entry_id, entry_id)

    def append(self, batch: pa.RecordBatch) -> int:
        """Append one entry; returns its entry id."""
        payload = _encode_batch(batch)
        crc = zlib.crc32(memoryview(payload))
        with self._lock:
            entry_id = self.last_entry_id + 1
            self._file.write(_HEADER.pack(len(payload), crc, entry_id))
            self._file.write(payload)
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self.last_entry_id = entry_id
        return entry_id

    def replay(self, from_entry_id: int):
        """Yield entries with id > from_entry_id; stop at a torn/corrupt tail."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc, entry_id = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break  # torn write at tail — recovery stops here
                if entry_id & GROUP_FLAG:
                    last = entry_id & ~GROUP_FLAG
                    subs = _decode_group(payload)
                    first = last - len(subs) + 1
                    for i, b in enumerate(subs):
                        if first + i > from_entry_id:
                            yield WalEntry(first + i, b)
                elif entry_id > from_entry_id:
                    yield WalEntry(entry_id, _decode_batch(payload))

    def obsolete(self, up_to_entry_id: int):
        """Drop entries <= up_to_entry_id (called after flush, reference
        store-api/src/logstore.rs:79-82).  Rewrites the log without them."""
        with self._lock:
            keep = [e for e in self.replay(up_to_entry_id)]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                for e in keep:
                    payload = _encode_batch(e.batch)
                    f.write(_HEADER.pack(
                        len(payload), zlib.crc32(memoryview(payload)), e.entry_id
                    ))
                    f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            self._file.close()
            os.replace(tmp, self.path)
            self._file = open(self.path, "ab")

    def close(self):
        with self._lock:
            self._file.close()


class WalManager:
    """LogStore facade handing out per-region logs under one directory."""

    def __init__(self, wal_dir: str, fsync: bool = False):
        self.wal_dir = wal_dir
        self.fsync = fsync
        self._regions: dict[int, RegionWal] = {}
        self._lock = threading.Lock()

    def region_wal(self, region_id: int) -> RegionWal:
        with self._lock:
            wal = self._regions.get(region_id)
            if wal is None:
                path = os.path.join(self.wal_dir, f"region_{region_id}.wal")
                wal = RegionWal(path, fsync=self.fsync)
                self._regions[region_id] = wal
            return wal

    def drop_region(self, region_id: int):
        with self._lock:
            wal = self._regions.pop(region_id, None)
        if wal is not None:
            wal.close()
            if os.path.exists(wal.path):
                os.remove(wal.path)

    def close(self):
        with self._lock:
            for wal in self._regions.values():
                wal.close()
            self._regions.clear()
