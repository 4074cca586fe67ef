"""Dedup helpers for sorted chunks: `last_row` and `last_non_null`.

Counterpart of the dedup half of `greptimedb_tpu/storage/merge.py`
(reference read/dedup.rs `DedupReader` strategies); the streaming k-way
merger is cut with the streaming scan (ROADMAP.md).

  * last_row:       keep the newest (max seq) version of each (pk, ts)
  * last_non_null:  fieldwise — the newest NON-NULL value per field wins
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..datatypes.schema import Schema

_SEQ = "__seq"


def _dedup_chunk(
    t: pa.Table, key_cols: list[str], schema: Schema, dedup: bool, mode: str
) -> pa.Table:
    """Chunk-local dedup.  Rows are key-sorted; versions of one key may be
    in any seq order within their group (runs from different sources), so
    sort by (key, seq) first."""
    sort_keys = [(c, "ascending") for c in key_cols] + [(_SEQ, "ascending")]
    idx = pc.sort_indices(t, sort_keys=sort_keys)
    t = t.take(idx)
    if not dedup or t.num_rows <= 1:
        return t.drop_columns([_SEQ]) if _SEQ in t.column_names else t
    keys = [t[c] for c in key_cols]
    n = t.num_rows
    same = np.ones(n - 1, dtype=bool)
    for col in keys:
        a = col.slice(0, n - 1)
        b = col.slice(1)
        eq = pc.equal(a, b)
        both_null = pc.and_(pc.is_null(a), pc.is_null(b))
        same &= np.asarray(pc.fill_null(pc.or_(eq, both_null), False))
    group_last = np.concatenate([~same, [True]])
    if mode == "last_non_null":
        from .region import OP_COL

        if OP_COL in t.column_names:
            # a delete tombstone kills every version at or before it
            # (reference dedup.rs LastNonNull skips deleted versions);
            # the group's newest delete index is broadcast to ALL of the
            # group's rows so earlier versions die too
            n2 = t.num_rows
            op = np.asarray(
                pc.fill_null(pc.cast(t[OP_COL], pa.int64()), 0)
            )
            ridx = np.arange(n2, dtype=np.int64)
            dcand = np.where(op != 0, ridx, -1)
            starts = np.nonzero(np.concatenate([[True], ~same]))[0]
            gmax_del = np.maximum.reduceat(dcand, starts)
            bcast = np.repeat(gmax_del, np.diff(np.append(starts, n2)))
            keep = ridx > bcast
            t = t.filter(pa.array(keep)).drop_columns([OP_COL])
            if t.num_rows == 0:
                return t.drop_columns([_SEQ]) if _SEQ in t.column_names else t
            # groups changed: recompute boundaries
            keys2 = [t[c] for c in key_cols]
            m = t.num_rows
            if m > 1:
                same2 = np.ones(m - 1, dtype=bool)
                for col in keys2:
                    a2, b2 = col.slice(0, m - 1), col.slice(1)
                    eq2 = pc.equal(a2, b2)
                    bn2 = pc.and_(pc.is_null(a2), pc.is_null(b2))
                    same2 &= np.asarray(pc.fill_null(pc.or_(eq2, bn2), False))
                group_last = np.concatenate([~same2, [True]])
            else:
                group_last = np.ones(m, dtype=bool)
        t = _last_non_null(t, group_last, schema, key_cols)
    else:
        t = t.filter(pa.array(group_last))
    return t.drop_columns([_SEQ]) if _SEQ in t.column_names else t


def _last_non_null(
    t: pa.Table, group_last: np.ndarray, schema: Schema, key_cols: list[str]
) -> pa.Table:
    """Fieldwise merge: for each (pk, ts) group take the newest NON-NULL
    value of every field column (reference read/dedup.rs LastNonNull).
    Vectorized: forward-fill each field within groups (seq-ascending rows)
    via a masked running index, then gather at group-last rows."""
    n = t.num_rows
    group_id = np.concatenate([[0], np.cumsum(group_last[:-1])]).astype(np.int64)
    last_rows = np.nonzero(group_last)[0]
    arrays: dict[str, pa.Array] = {}
    key_set = set(key_cols)
    for name in t.column_names:
        if name == _SEQ:
            continue
        col = t[name].combine_chunks()
        if name in key_set:
            arrays[name] = col.take(pa.array(last_rows))
            continue
        valid = np.asarray(pc.is_valid(col))
        ridx = np.arange(n, dtype=np.int64)
        # running "latest non-null row index" via max-accumulate; a carry
        # from a previous group is detected by group-id mismatch and
        # treated as no-value
        cand = np.where(valid, ridx, -1)
        ff = np.maximum.accumulate(cand)
        has = ff >= 0
        ok = has & (group_id[np.clip(ff, 0, None)] == group_id)
        pick = ff[last_rows]
        pick_ok = ok[last_rows]
        taken = col.take(pa.array(np.where(pick_ok, pick, 0)))
        if not pick_ok.all():
            mask = pa.array(~pick_ok)
            taken = pc.if_else(mask, pa.nulls(len(last_rows), taken.type), taken)
        arrays[name] = taken
    return pa.table({name: arrays[name] for name in t.column_names if name != _SEQ})
