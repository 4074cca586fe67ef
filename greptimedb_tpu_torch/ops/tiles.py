"""Column tiles: Arrow columns -> padded torch tensors on an explicit device.

Counterpart of `greptimedb_tpu/ops/tiles.py`.  String/tag columns are
dictionary-encoded to int32 codes on the host before upload (the same code
assignment as the reference package, so group ids and row order match);
group-by and equality filters then run on codes, and the host maps codes
back to strings when shipping results.

Padding: the reference pads to the next power of two, because XLA
compiles per shape.  Nothing in this port compiles per shape, so a tile is
padded only to a multiple of `BLOCK_ROWS` (`pad_rows`), the block of the
blocked kernels: at most one block of padding instead of up to 2x the rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from .aggregate import BLOCK_ROWS


def pad_rows(n: int) -> int:
    """Padded tile length: n rounded up to a multiple of BLOCK_ROWS (at
    least one block)."""
    return max(-(-n // BLOCK_ROWS), 1) * BLOCK_ROWS


def chunk_bounds(pad: int, chunk_rows: int) -> list[tuple[int, int]]:
    """The (start, stop) rows of each chunk of a `pad`-row plane cut every
    `chunk_rows` rows (the tile cache's planes, and K14-K16's chunk
    tables)."""
    if pad <= chunk_rows:
        return [(0, pad)]
    return [(o, min(o + chunk_rows, pad)) for o in range(0, pad, chunk_rows)]


@dataclass
class TileBatch:
    """A padded, device-resident batch of columns.

    columns: name -> tensor of shape [padded_rows]
    valid:   bool [padded_rows]; False for padding rows
    nulls:   name -> bool [padded_rows] per-column validity (True = present)
    dicts:   name -> list of python values; column holds int32 codes into it
    num_rows: real (unpadded) row count
    """

    columns: dict[str, torch.Tensor]
    valid: torch.Tensor
    nulls: dict[str, torch.Tensor]
    dicts: dict[str, list] = field(default_factory=dict)
    num_rows: int = 0

    @property
    def padded_rows(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device


def tile_batch_from_numpy(
    columns: dict[str, np.ndarray],
    valid: np.ndarray,
    nulls: dict[str, np.ndarray],
    dicts: dict[str, list],
    device: str | torch.device,
    num_rows: int | None = None,
) -> TileBatch:
    """Carry a reference-package `TileBatch` across: its arrays as numpy
    (`np.asarray` of each device array) -> the port's TileBatch on
    `device`.  Codes, planes and padding are taken as they are."""
    valid_np = np.array(valid, dtype=bool)
    return TileBatch(
        columns={k: torch.from_numpy(np.array(v)).to(device) for k, v in columns.items()},
        valid=torch.from_numpy(valid_np).to(device),
        nulls={k: torch.from_numpy(np.array(v, dtype=bool)).to(device) for k, v in nulls.items()},
        dicts={k: list(v) for k, v in dicts.items()},
        num_rows=int(valid_np.sum()) if num_rows is None else num_rows,
    )


def tiles_from_table(
    table: pa.Table,
    device: str | torch.device = "cpu",
    dicts: dict[str, dict] | None = None,
    rows: int | None = None,
) -> TileBatch:
    """Host-side: convert an Arrow table to a padded TileBatch on `device`.

    `dicts` optionally pins pre-agreed dictionary code assignments (needed
    when multiple shards must agree on tag codes for a global group-by).
    Columns are padded to `rows` (shards of one group-by share a size),
    by default to `pad_rows(table.num_rows)`."""
    n = table.num_rows
    padded = pad_rows(n) if rows is None else int(rows)
    if padded < n:
        raise ValueError(f"cannot pad {n} rows to {padded}")
    columns: dict[str, torch.Tensor] = {}
    nulls: dict[str, torch.Tensor] = {}
    out_dicts: dict[str, list] = {}

    for name in table.column_names:
        col = table[name].combine_chunks() if table.num_rows else table[name]
        arr, null_mask, dict_values = _encode_column(col, name, dicts)
        if dict_values is not None:
            out_dicts[name] = dict_values
        pad_arr = np.zeros(padded, dtype=arr.dtype)
        pad_arr[:n] = arr
        columns[name] = torch.from_numpy(pad_arr).to(device)
        if null_mask is not None:
            pad_null = np.zeros(padded, dtype=bool)
            pad_null[:n] = null_mask
            nulls[name] = torch.from_numpy(pad_null).to(device)

    valid_np = np.zeros(padded, dtype=bool)
    valid_np[:n] = True
    valid = torch.from_numpy(valid_np).to(device)
    return TileBatch(columns=columns, valid=valid, nulls=nulls, dicts=out_dicts, num_rows=n)


def _encode_column(col: pa.ChunkedArray, name: str, pinned: dict[str, dict] | None):
    """Return (np values, null mask present=True or None, dict values or None)."""
    t = col.type
    null_mask = None
    if col.null_count:
        null_mask = np.asarray(pc.is_valid(col))  # True = value present
    if pa.types.is_dictionary(t):
        col = pc.cast(col, t.value_type)
        t = t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
        if pinned and name in pinned:
            # vectorized lookup against the pre-agreed code assignment
            dict_values = _mapping_to_list(pinned[name])
            none_code = pinned[name].get(None, -1)
            idx = pc.index_in(col, value_set=pa.array(dict_values, t))
            codes = np.asarray(
                pc.fill_null(idx, -1).to_numpy(zero_copy_only=False), np.int32
            )
            if none_code >= 0 and col.null_count:
                null_np = np.asarray(
                    pc.is_null(col).to_numpy(zero_copy_only=False), bool
                )
                codes = np.where(null_np, none_code, codes)
        else:
            flat = col
            if isinstance(flat, pa.ChunkedArray):
                flat = flat.combine_chunks()
                if isinstance(flat, pa.ChunkedArray):
                    flat = (
                        flat.chunk(0)
                        if flat.num_chunks
                        else pa.array([], type=t)
                    )
            enc = pc.dictionary_encode(flat)  # Array in -> DictionaryArray out
            dict_values = enc.dictionary.to_pylist()
            codes = np.asarray(
                pc.fill_null(enc.indices, -1).to_numpy(zero_copy_only=False),
                np.int32,
            )
            if col.null_count:
                # nulls become a dictionary value of their own
                null_np = np.asarray(
                    pc.is_null(col).to_numpy(zero_copy_only=False), bool
                )
                codes = np.where(null_np, len(dict_values), codes)
                dict_values = dict_values + [None]
        return codes, null_mask, dict_values
    if pa.types.is_timestamp(t) or pa.types.is_duration(t):
        arr = np.asarray(pc.cast(col, pa.int64()).to_numpy(zero_copy_only=False))
        return arr, null_mask, None
    if pa.types.is_boolean(t):
        return col.to_numpy(zero_copy_only=False).astype(bool), null_mask, None
    arr = col.to_numpy(zero_copy_only=False)
    if arr.dtype == object:  # nullable numeric came back as object
        arr = np.array([0 if v is None else v for v in arr], dtype=np.float64)
    elif null_mask is not None and np.issubdtype(arr.dtype, np.floating):
        arr = np.nan_to_num(arr, nan=0.0)  # nulls decoded as NaN -> 0 + mask
    return arr, null_mask, None


def _mapping_to_list(mapping: dict) -> list:
    out = [None] * len(mapping)
    for v, code in mapping.items():
        if 0 <= code < len(out):
            out[code] = v
    return out

