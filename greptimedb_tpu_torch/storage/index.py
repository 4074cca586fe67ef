"""Per-SST secondary indexes: the vector (IVF-flat) index.

Counterpart of the vector section of `greptimedb_tpu/storage/index.py`:
the blob type, its framing (a u32 header length, a JSON header, the
payload), the build from a binary-f32 vector column and the parsed
index that answers a probe with candidate rows.  The blobs are the
reference's byte for byte, so a sidecar written by either package reads
in the other.

Not ported yet (ROADMAP, A7's puffin/index item): the bloom, inverted and
fulltext blobs and the segmented term index (`greptimedb_tpu/index/`),
with the row-group pruning they feed.  The port's SST writer builds the
sidecar for `VECTOR INDEX` columns only.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import pyarrow as pa

VECTOR_BLOB = "greptime-vector-index-v1"


def _split_blob(blob: bytes) -> tuple[dict, bytes]:
    hlen = struct.unpack("<I", blob[:4])[0]
    header = json.loads(blob[4 : 4 + hlen])
    return header, blob[4 + hlen :]


class IndexCache:
    """A small LRU of parsed per-file index handles."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._data: dict[str, object] = {}

    def get(self, key: str):
        v = self._data.pop(key, None)
        if v is not None:
            self._data[key] = v
        return v

    def put(self, key: str, value):
        if key in self._data:
            self._data.pop(key)
        elif len(self._data) >= self.capacity:
            self._data.pop(next(iter(self._data)))
        self._data[key] = value


# ---- vector (ANN) index -----------------------------------------------------
# IVF-flat per SST (reference mito2/src/sst/index/vector_index/ wraps usearch
# HNSW): coarse centroids + per-row assignments, probed at query time and
# re-ranked exactly over the candidate rows.


def build_vector_index(column: pa.Array, dim: int) -> bytes | None:
    """Binary-f32 vector column -> serialized IVF-flat index (coarse
    centroids + per-row assignments).  None for empty columns."""
    from ..query.vector import build_ivf, decode_matrix

    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    mat, valid = decode_matrix(column, dim)
    if not valid.any():
        return None
    cent, assign = build_ivf(mat, valid)
    header = json.dumps(
        {"dim": dim, "nlist": len(cent), "n": len(assign)}
    ).encode()
    payload = zlib.compress(cent.astype("<f4").tobytes() + assign.astype("<i4").tobytes())
    return struct.pack("<I", len(header)) + header + payload


class VectorIndex:
    """Parsed IVF-flat blob: probe nprobe nearest cells -> candidate rows."""

    def __init__(self, blob: bytes):
        header, payload = _split_blob(blob)
        self.dim = header["dim"]
        self.nlist = header["nlist"]
        self.n = header["n"]
        raw = zlib.decompress(payload)
        cbytes = self.nlist * self.dim * 4
        self.centroids = np.frombuffer(raw[:cbytes], dtype="<f4").reshape(
            self.nlist, self.dim
        )
        self.assign = np.frombuffer(raw[cbytes:], dtype="<i4")

    def candidates(self, q: np.ndarray, nprobe: int = 4) -> np.ndarray:
        from ..query.vector import ivf_candidates

        return ivf_candidates(self.centroids, self.assign, q, nprobe)
