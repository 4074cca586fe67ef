"""Puffin blob container for per-SST index data.

Counterpart of `greptimedb_tpu/storage/puffin.py`, whole: the same
layout, so a sidecar written by either package reads in the other.

Role-equivalent of the reference's `puffin` crate (reference
puffin/src/puffin_manager.rs, file_format/): the Apache-Iceberg-Puffin
file layout — magic, concatenated blobs, JSON footer describing blob
offsets/types/properties, footer length, flags, trailing magic — used as
the single sidecar file holding all of an SST's secondary indexes.

Layout (matches the Puffin spec structure):

    "PFA1" | blob_0 | blob_1 | ... | footer_json | footer_len(u32 LE) |
    flags(u32 LE) | "PFA1"
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field

MAGIC = b"PFA1"


@dataclass
class BlobMeta:
    blob_type: str  # e.g. "greptime-bloom-filter-v1", "greptime-inverted-index-v1"
    offset: int
    length: int
    properties: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "type": self.blob_type,
            "offset": self.offset,
            "length": self.length,
            "properties": self.properties,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlobMeta":
        return cls(d["type"], d["offset"], d["length"], d.get("properties", {}))


def _as_store(store_or_path, key: str | None):
    """(store, key) pair from either an ObjectStore+key or a bare fs path
    (legacy call shape: PuffinWriter('/dir/x.puffin'))."""
    from .object_store import FsObjectStore, ObjectStore

    if isinstance(store_or_path, ObjectStore):
        assert key is not None, "key required with an ObjectStore"
        return store_or_path, key
    path = store_or_path
    return FsObjectStore(os.path.dirname(path) or "."), os.path.basename(path)


class PuffinWriter:
    def __init__(self, store_or_path, key: str | None = None):
        self.store, self.key = _as_store(store_or_path, key)
        self._blobs: list[tuple[BlobMeta, bytes]] = []

    def add_blob(self, blob_type: str, data: bytes, properties: dict | None = None):
        self._blobs.append((BlobMeta(blob_type, 0, len(data), properties or {}), data))

    def finish(self) -> int:
        """Write the container; returns file size. No file if no blobs."""
        if not self._blobs:
            return 0
        parts = [MAGIC]
        off = len(MAGIC)
        metas = []
        for meta, data in self._blobs:
            meta.offset = off
            parts.append(data)
            off += len(data)
            metas.append(meta.to_dict())
        footer = json.dumps({"blobs": metas}).encode()
        parts.append(footer)
        parts.append(struct.pack("<I", len(footer)))
        parts.append(struct.pack("<I", 0))  # flags
        parts.append(MAGIC)
        payload = b"".join(parts)
        self.store.write(self.key, payload)
        return len(payload)


class PuffinReader:
    """`ranged=False` (default) reads the whole container once and slices —
    right for small sidecars consumed blob-by-blob.  `ranged=True` reads
    the footer via a tail range and each blob via its own ranged read, so
    touching ONE blob of a large container (a segmented term index with
    thousands of segment blobs) costs O(blob), not O(file); `bytes_read`
    accumulates the ranged bytes actually fetched for observability."""

    def __init__(self, store_or_path, key: str | None = None, ranged: bool = False):
        self.store, self.key = _as_store(store_or_path, key)
        self.ranged = ranged
        self.bytes_read = 0
        self._metas: list[BlobMeta] | None = None
        self._data: bytes | None = None

    def exists(self) -> bool:
        return self.store.exists(self.key)

    def _payload(self) -> bytes:
        # Legacy whole-blob sidecars are small (bounded by cardinality
        # caps); one read beats three for every blob on a remote store.
        if self._data is None:
            self._data = self.store.read(self.key)
        return self._data

    def blobs(self) -> list[BlobMeta]:
        if self._metas is None:
            if self.ranged:
                size = self.store.size(self.key)
                tail = self.store.read_range(self.key, max(size - 12, 0), 12)
                self.bytes_read += len(tail)
                footer_len = struct.unpack("<I", tail[:4])[0]
                if tail[8:] != MAGIC:
                    raise ValueError(f"bad puffin trailer in {self.key}")
                footer_raw = self.store.read_range(
                    self.key, size - 12 - footer_len, footer_len
                )
                self.bytes_read += len(footer_raw)
                footer = json.loads(footer_raw)
            else:
                data = self._payload()
                if data[:4] != MAGIC:
                    raise ValueError(f"bad puffin magic in {self.key}")
                tail = data[-12:]
                footer_len = struct.unpack("<I", tail[:4])[0]
                if tail[8:] != MAGIC:
                    raise ValueError(f"bad puffin trailer in {self.key}")
                footer = json.loads(data[len(data) - 12 - footer_len : len(data) - 12])
            self._metas = [BlobMeta.from_dict(d) for d in footer["blobs"]]
        return self._metas

    def read_blob(self, meta: BlobMeta) -> bytes:
        if self.ranged and self._data is None:
            out = self.store.read_range(self.key, meta.offset, meta.length)
            self.bytes_read += len(out)
            return out
        data = self._payload()
        return data[meta.offset : meta.offset + meta.length]

    def find(self, blob_type: str, **props) -> BlobMeta | None:
        for m in self.blobs():
            if m.blob_type == blob_type and all(
                m.properties.get(k) == v for k, v in props.items()
            ):
                return m
        return None
