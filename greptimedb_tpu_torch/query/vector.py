"""Vector (embedding) values, distances, and brute-force search.

Role-equivalent of the reference's vector type + functions
(reference common/function/src/scalars/vector/: vec_cos_distance,
vec_l2sq_distance, vec_dot_product, parse/to-string conversions) over the
binary-f32 storage encoding (datatypes VECTOR).

Distance evaluation is matrix-shaped on purpose: a [N, d] x [d] product is
exactly what the TPU MXU wants — `ops/vector.py` lowers the same math to a
jax kernel for large scans; this module is the numpy/CPU authoritative
path.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..utils.errors import InvalidArgumentsError


def parse_vector_literal(text, dim: int | None = None) -> bytes:
    """'[1, 2.5, 3]' (or a list of numbers) -> little-endian f32 bytes."""
    if isinstance(text, (list, tuple)):
        vals = [float(x) for x in text]
    else:
        s = str(text).strip()
        if s.startswith("[") and s.endswith("]"):
            s = s[1:-1]
        vals = [float(x) for x in s.split(",") if x.strip()] if s.strip() else []
    if dim is not None and len(vals) != dim:
        raise InvalidArgumentsError(
            f"vector literal has {len(vals)} dims, column expects {dim}"
        )
    return np.asarray(vals, dtype="<f4").tobytes()


def vector_to_string(blob: bytes | None) -> str | None:
    if blob is None:
        return None
    v = np.frombuffer(blob, dtype="<f4")
    return "[" + ",".join(f"{x:g}" for x in v) + "]"


def decode_matrix(col, dim: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Binary arrow column of N vectors -> ([N, d] float32 matrix, valid
    mask).  Invalid (null) rows are zero-filled."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    blobs = [
        parse_vector_literal(b) if isinstance(b, str) else b for b in col.to_pylist()
    ]
    n = len(blobs)
    d = dim
    if d is None:
        for b in blobs:
            if b is not None:
                d = len(b) // 4
                break
        if d is None:
            return np.zeros((n, 0), dtype=np.float32), np.zeros(n, dtype=bool)
    mat = np.zeros((n, d), dtype=np.float32)
    valid = np.zeros(n, dtype=bool)
    for i, b in enumerate(blobs):
        if b is None:
            continue
        if isinstance(b, str):  # string-form vectors ('[1,2,3]') accepted too
            b = parse_vector_literal(b)
        v = np.frombuffer(b, dtype="<f4")
        if len(v) != d:
            raise InvalidArgumentsError(
                f"vector dimension mismatch: expected {d}, got {len(v)}"
            )
        mat[i] = v
        valid[i] = True
    return mat, valid


def distances(mat: np.ndarray, q: np.ndarray, metric: str) -> np.ndarray:
    """Batched distance, matrix-shaped (the MXU-friendly formulation):
    cos  = 1 - (A.q)/(|A||q|);  l2sq = |A|^2 - 2 A.q + |q|^2;  dot = -A.q
    (dot 'distance' is negated product so ascending sort = most similar,
    matching the reference's vec_dot_product ordering convention)."""
    dots = mat @ q.astype(np.float32)
    if metric == "dot":
        return dots  # raw product (reference returns the product itself)
    if metric == "l2sq":
        return (mat * mat).sum(axis=1) - 2.0 * dots + float(q @ q)
    if metric == "cos":
        denom = np.linalg.norm(mat, axis=1) * float(np.linalg.norm(q))
        with np.errstate(divide="ignore", invalid="ignore"):
            sim = np.where(denom > 0, dots / denom, 0.0)
        return 1.0 - sim
    raise InvalidArgumentsError(f"unknown vector metric: {metric}")


# ---- IVF-flat ANN index -----------------------------------------------------
# The reference ships an approximate per-SST vector index
# (mito2/src/sst/index/vector_index/, usearch HNSW); ours is IVF-flat:
# k-means coarse centroids + per-list row ids, probed at query time with
# exact re-ranking of the candidate rows.  Serialized into the same puffin
# sidecar as the other SST indexes.


def build_ivf(mat: np.ndarray, valid: np.ndarray, nlist: int | None = None, iters: int = 8):
    """-> (centroids [L, d], assignments [N] int32; -1 for invalid rows)."""
    n, d = mat.shape
    idx = np.flatnonzero(valid)
    assign = np.full(n, -1, dtype=np.int32)
    if len(idx) == 0 or d == 0:
        return np.zeros((0, d), dtype=np.float32), assign
    if nlist is None:
        nlist = max(1, min(int(np.sqrt(len(idx))), 256))
    rng = np.random.RandomState(0)  # deterministic index builds
    seeds = idx[rng.choice(len(idx), size=min(nlist, len(idx)), replace=False)]
    cent = mat[seeds].astype(np.float32).copy()
    pts = mat[idx]
    for _ in range(iters):
        d2 = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
        a = d2.argmin(axis=1)
        for c in range(len(cent)):
            m = a == c
            if m.any():
                cent[c] = pts[m].mean(axis=0)
    d2 = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
    assign[idx] = d2.argmin(axis=1).astype(np.int32)
    return cent, assign


def ivf_candidates(cent: np.ndarray, assign: np.ndarray, q: np.ndarray, nprobe: int) -> np.ndarray:
    """Row indices in the nprobe nearest coarse cells."""
    if len(cent) == 0:
        return np.flatnonzero(assign >= 0)
    d2 = ((cent - q.astype(np.float32)) ** 2).sum(axis=1)
    probe = np.argsort(d2)[: max(nprobe, 1)]
    return np.flatnonzero(np.isin(assign, probe))
