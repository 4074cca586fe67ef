"""Persistent per-table tag dictionaries: stable codes for string group keys.

Copied from `greptimedb_tpu/storage/dictionary.py` (pure Python, no
device code); the JSON files under data_home/dicts/ are the reference's,
so either package reads the other's.

Role-equivalent of the reference's primary-key pre-encoding at write time
(reference mito-codec/src/row_converter/ — keys are encoded once, and every
consumer agrees on the encoding).  Here the unit is a per-table, per-column
dictionary: a SORTED list of distinct tag values whose position is the
value's int32 code.

Why sorted (not first-seen):
  * the storage engine sorts rows by (pk, ts); with value-sorted codes the
    group ids computed from codes are non-decreasing in scan order, which is
    exactly the layout the sorted-block aggregation kernel needs
    (ops/aggregate.py `_segment_blocked`);
  * inequality filters on tag columns (`host > 'host_5'`) become integer
    comparisons on codes — impossible with first-seen code assignment.

Growth: inserting new values shifts codes of larger values.  Each insertion
bumps `epoch` and records a permutation old-code -> new-code, so cached
device tiles encoded at an older epoch are repaired with one gather instead
of re-reading the SST (`perm_since`).  None (SQL NULL) is always the LAST
code, matching Arrow's nulls-last sort order in the memtable.
"""

from __future__ import annotations

import bisect
import json
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


class _ColumnDict:
    def __init__(self, values: list | None = None, has_null: bool = False):
        self.values: list = values or []  # sorted, non-null values
        self.has_null = has_null
        self._value_set: pa.Array | None = None  # cache for index_in

    @property
    def size(self) -> int:
        return len(self.values) + (1 if self.has_null else 0)

    @property
    def null_code(self) -> int:
        return len(self.values) if self.has_null else -1

    def value_set(self) -> pa.Array:
        if self._value_set is None or len(self._value_set) != len(self.values):
            self._value_set = pa.array(self.values, pa.string())
        return self._value_set

    def all_values(self) -> list:
        """Code -> value list, including the None slot."""
        return self.values + ([None] if self.has_null else [])


class TableDictionary:
    """Sorted value<->code tables for every string tag column of one table."""

    def __init__(self, path: str | None = None):
        self._path = path
        self._lock = threading.RLock()
        # Coarse per-table gate for epoch-sensitive multi-step operations
        # (the tile executor holds it from tile fetch through arg packing so
        # concurrent queries can't repair shared tiles mid-pack or decode
        # against a dictionary that grew after encoding).
        self.table_lock = threading.RLock()
        self._cols: dict[str, _ColumnDict] = {}
        self.epoch = 0
        # perm history: _perms[i] maps codes at epoch i -> epoch i+1
        self._perms: dict[str, list[np.ndarray]] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            self.epoch = int(d.get("epoch", 0))
            for name, cd in d.get("columns", {}).items():
                self._cols[name] = _ColumnDict(cd["values"], cd.get("has_null", False))

    # ---- persistence -------------------------------------------------------
    def _save_locked(self):
        if not self._path:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "epoch": self.epoch,
                    "columns": {
                        n: {"values": c.values, "has_null": c.has_null}
                        for n, c in self._cols.items()
                    },
                },
                f,
            )
        os.replace(tmp, self._path)

    # ---- growth ------------------------------------------------------------
    def update(self, name: str, col: pa.Array | pa.ChunkedArray) -> bool:
        """Insert any unseen values of `col`; returns True if the dictionary
        grew (codes of existing values may have shifted — see perm_since)."""
        if pa.types.is_dictionary(col.type):
            col = pc.cast(col, col.type.value_type)
        uniq = pc.unique(col)
        with self._lock:
            cd = self._cols.get(name)
            if cd is None:
                cd = self._cols[name] = _ColumnDict()
            new_null = False
            if uniq.null_count and not cd.has_null:
                new_null = True
            if len(cd.values):
                hits = pc.index_in(uniq, value_set=cd.value_set())
                missing = uniq.filter(
                    pc.and_kleene(pc.is_null(hits), pc.is_valid(uniq))
                )
            else:
                missing = uniq.drop_null()
            new_vals = [v for v in missing.to_pylist()]
            if not new_vals and not new_null:
                return False
            old_values = cd.values
            old_has_null = cd.has_null
            merged = sorted(set(old_values) | set(new_vals))
            # permutation old code -> new code (None slot stays last)
            pos = {v: i for i, v in enumerate(merged)}
            perm = np.empty(len(old_values) + (1 if old_has_null else 0), np.int32)
            for i, v in enumerate(old_values):
                perm[i] = pos[v]
            if old_has_null:
                perm[len(old_values)] = len(merged)
            cd.values = merged
            cd.has_null = old_has_null or new_null
            cd._value_set = None
            self._perms.setdefault(name, [])
            # pad the history so every column's list is indexed by epoch
            while len(self._perms[name]) < self.epoch:
                self._perms[name].append(None)  # identity at that epoch
            self._perms[name].append(perm)
            for other, hist in self._perms.items():
                if other != name:
                    while len(hist) < self.epoch + 1:
                        hist.append(None)
            self.epoch += 1
            self._save_locked()
            return True

    def update_table(self, table: pa.Table, columns: list[str]) -> bool:
        grew = False
        for name in columns:
            if name in table.column_names:
                grew |= self.update(name, table[name])
        return grew

    # ---- encode ------------------------------------------------------------
    def encode(self, name: str, col: pa.Array | pa.ChunkedArray) -> np.ndarray:
        """Vectorized value->code (no Python per-row loop).  Values absent
        from the dictionary encode as -1; nulls get the null slot (or -1 if
        the column never saw a null)."""
        if pa.types.is_dictionary(col.type):
            col = pc.cast(col, col.type.value_type)
        with self._lock:
            cd = self._cols.get(name)
            if cd is None:
                return np.full(len(col), -1, np.int32)
            idx = pc.index_in(col, value_set=cd.value_set())
            out = np.asarray(
                pc.fill_null(idx, -1).to_numpy(zero_copy_only=False), np.int32
            )
            if cd.has_null:
                null_np = np.asarray(
                    pc.is_null(col).to_numpy(zero_copy_only=False), bool
                )
                out = np.where(null_np, cd.null_code, out)
            return out

    def cardinality(self, name: str) -> int:
        with self._lock:
            cd = self._cols.get(name)
            return cd.size if cd else 0

    def values(self, name: str) -> list:
        with self._lock:
            cd = self._cols.get(name)
            return cd.all_values() if cd else []

    # ---- filter literals ---------------------------------------------------
    def code_of(self, name: str, value) -> int:
        """Exact code of `value`, or -1 when absent (matches nothing)."""
        with self._lock:
            cd = self._cols.get(name)
            if cd is None:
                return -1
            if value is None:
                return cd.null_code
            i = bisect.bisect_left(cd.values, value)
            if i < len(cd.values) and cd.values[i] == value:
                return i
            return -1

    def bound(self, name: str, value) -> int:
        """Insertion point of `value` in sorted code order — lets inequality
        filters on strings run on codes: col < v  <=>  code < bound(v);
        col >= v <=> code >= bound(v); col <= v <=> code < bisect_right;
        col > v <=> code >= bisect_right."""
        with self._lock:
            cd = self._cols.get(name)
            if cd is None:
                return 0
            return bisect.bisect_left(cd.values, value)

    def bound_right(self, name: str, value) -> int:
        with self._lock:
            cd = self._cols.get(name)
            if cd is None:
                return 0
            return bisect.bisect_right(cd.values, value)

    # ---- cache repair ------------------------------------------------------
    def perm_since(self, name: str, epoch: int) -> np.ndarray | None:
        """Composed permutation mapping codes assigned at `epoch` to current
        codes; None = identity (nothing changed for this column)."""
        with self._lock:
            hist = self._perms.get(name, [])
            chain = [p for p in hist[epoch:] if p is not None]
            if not chain:
                return None
            perm = chain[0]
            for p in chain[1:]:
                # grow perm to p's domain if needed (identity on new codes)
                perm = p[perm]
            return perm


class DictionaryRegistry:
    """Per-table dictionaries living under data_home/dicts/."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._dicts: dict[str, TableDictionary] = {}
        os.makedirs(root, exist_ok=True)

    def get(self, table_key: str) -> TableDictionary:
        with self._lock:
            d = self._dicts.get(table_key)
            if d is None:
                safe = table_key.replace("/", "%2F")
                d = self._dicts[table_key] = TableDictionary(
                    os.path.join(self.root, f"{safe}.json")
                )
            return d

    def drop(self, table_key: str):
        with self._lock:
            d = self._dicts.pop(table_key, None)
        path = os.path.join(self.root, f"{table_key.replace('/', '%2F')}.json")
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
