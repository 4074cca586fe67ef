"""Region partition rules: route rows to regions.

Role-equivalent of the reference's expression-based partitioning
(reference partition/src/multi_dim.rs `MultiDimPartitionRule`,
manager.rs:192 `split_rows`): a table's rows are split across regions by a
rule evaluated per row.  We provide three rules:

  SingleRegionRule  — everything in one region (default, like an
                      unpartitioned reference table)
  HashPartitionRule — hash(tag columns) % n, the common TSBS layout
  RangePartitionRule— ordered ranges over one column's values, the
                      reference's PARTITION ON COLUMNS surface
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


@dataclass
class RegionRoute:
    """One region's placement: the leader datanode that serves writes plus
    optional read-only follower replicas (reference
    partition/src/manager.rs RegionRoute with leader_peer + follower_peers).

    The wire/KV form stays backward compatible: a bare int is a route with
    no followers (what every pre-replica KV holds), a dict carries both.
    """

    leader: int
    followers: list[int] = field(default_factory=list)

    def to_wire(self):
        if not self.followers:
            return self.leader
        return {"leader": self.leader, "followers": list(self.followers)}

    @staticmethod
    def from_wire(v) -> "RegionRoute":
        if isinstance(v, dict):
            return RegionRoute(int(v["leader"]), [int(f) for f in v.get("followers", [])])
        return RegionRoute(int(v))


class PartitionRule:
    def num_partitions(self) -> int:
        raise NotImplementedError

    def partition_indices(self, table: pa.Table) -> np.ndarray:
        """Per-row partition index [0, num_partitions)."""
        raise NotImplementedError

    def split(self, table: pa.Table) -> list[pa.Table]:
        """Split rows into per-partition tables (reference split_rows):
        ONE compute pass for the indices, ONE stable-ordered `take`, then
        zero-copy slices — instead of one filter mask per partition.
        Row order within each partition is preserved (stable argsort), so
        last-write-wins append order survives routing."""
        n = self.num_partitions()
        if n == 1 or table.num_rows == 0:
            return [table] + [table.schema.empty_table() for _ in range(n - 1)]
        idx = self.partition_indices(table)
        counts = np.bincount(idx, minlength=n)
        empty = table.schema.empty_table()
        hot = int(counts.argmax())
        if counts[hot] == table.num_rows:
            # all rows in one partition (the bulk-ingest common case):
            # skip the take copy entirely
            out = [empty] * n
            out[hot] = table
            return out
        order = np.argsort(idx, kind="stable")
        taken = table.take(pa.array(order))
        offsets = np.concatenate(([0], np.cumsum(counts)))
        return [
            taken.slice(int(offsets[p]), int(counts[p])) if counts[p] else empty
            for p in range(n)
        ]

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "PartitionRule":
        kind = d["kind"]
        if kind == "single":
            return SingleRegionRule()
        if kind == "hash":
            return HashPartitionRule(d["columns"], d["n"])
        if kind == "range":
            return RangePartitionRule(d["column"], d["bounds"])
        if kind == "multi_dim":
            return MultiDimPartitionRule(d["columns"], d["exprs"])
        raise ValueError(f"unknown partition rule kind: {kind}")


@dataclass
class SingleRegionRule(PartitionRule):
    def num_partitions(self) -> int:
        return 1

    def partition_indices(self, table: pa.Table) -> np.ndarray:
        return np.zeros(table.num_rows, dtype=np.int32)

    def to_dict(self) -> dict:
        return {"kind": "single"}


@dataclass
class HashPartitionRule(PartitionRule):
    columns: list[str]
    n: int

    def num_partitions(self) -> int:
        return self.n

    def partition_indices(self, table: pa.Table) -> np.ndarray:
        h = np.zeros(table.num_rows, dtype=np.uint64)
        for c in self.columns:
            col = table[c]
            if pa.types.is_dictionary(col.type):
                col = pc.cast(col, col.type.value_type)
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            # crc32 per DISTINCT value (dictionary-encode in C++), gathered
            # back via one vectorized take — stable across processes
            # (unlike Python hash()) and identical to the per-row loop.
            enc = pc.dictionary_encode(col)
            salts = np.array(
                [zlib.crc32(repr(v).encode()) for v in enc.dictionary.to_pylist()]
                or [0],
                dtype=np.uint64,
            )
            idxs = np.asarray(pc.fill_null(enc.indices, -1), dtype=np.int64)
            hc = np.where(
                idxs >= 0,
                salts[np.clip(idxs, 0, len(salts) - 1)],
                np.uint64(zlib.crc32(repr(None).encode())),
            )
            h = h * np.uint64(1000003) + hc
        return (h % np.uint64(self.n)).astype(np.int32)

    def to_dict(self) -> dict:
        return {"kind": "hash", "columns": self.columns, "n": self.n}


@dataclass
class MultiDimPartitionRule(PartitionRule):
    """Expression-based multi-dimensional partitioning (reference
    partition/src/multi_dim.rs:50 `MultiDimPartitionRule`, RFC
    2024-02-21-multi-dimension-partition-rule): one boolean expression per
    region, evaluated per row; first matching region wins.

    Expressions persist as SQL text (re-parsed lazily) so the rule
    round-trips through the JSON catalog like the other rules.  A row that
    matches no expression is a rule-completeness violation and raises —
    the reference's checker.rs rejects incomplete rules at CREATE; we
    enforce at write time as the backstop."""

    columns: list[str]
    exprs: list[str]  # SQL boolean expressions, one per region

    def __post_init__(self):
        self._parsed = None

    def _compiled(self):
        if self._parsed is None:
            from ..query.sql_parser import Parser

            self._parsed = [Parser(e).parse_expr() for e in self.exprs]
        return self._parsed

    def num_partitions(self) -> int:
        return len(self.exprs)

    def partition_indices(self, table: pa.Table) -> np.ndarray:
        from ..query.cpu_exec import eval_expr

        n = table.num_rows
        out = np.full(n, -1, dtype=np.int32)
        unassigned = np.ones(n, dtype=bool)
        for p, expr in enumerate(self._compiled()):
            m = eval_expr(expr, table)
            if isinstance(m, pa.Scalar):
                mask = np.full(n, bool(m.as_py()))
            else:
                mask = np.asarray(pc.fill_null(m, False))
            hit = unassigned & mask
            out[hit] = p
            unassigned &= ~mask
            if not unassigned.any():
                break
        if unassigned.any():
            i = int(np.flatnonzero(unassigned)[0])
            row = {c: table[c][i].as_py() for c in self.columns if c in table.column_names}
            raise ValueError(
                f"row {row} matches no partition expression (incomplete rule)"
            )
        return out

    def to_dict(self) -> dict:
        return {"kind": "multi_dim", "columns": self.columns, "exprs": self.exprs}


@dataclass
class RangePartitionRule(PartitionRule):
    """Ranges over one column: bounds [b0, b1, ...] define len(bounds)+1
    partitions: (-inf, b0), [b0, b1), ..., [bn, +inf)."""

    column: str
    bounds: list = field(default_factory=list)

    def num_partitions(self) -> int:
        return len(self.bounds) + 1

    def partition_indices(self, table: pa.Table) -> np.ndarray:
        n = table.num_rows
        if not self.bounds:
            return np.zeros(n, dtype=np.int32)
        # Sorted bounds (the only shape CREATE emits): the break-at-first-
        # failing-bound count equals the total >=-count, which vectorizes
        # to one compute pass per bound (nulls compare null -> False -> 0,
        # matching the scalar loop's None handling).
        try:
            ascending = all(
                self.bounds[i] <= self.bounds[i + 1]
                for i in range(len(self.bounds) - 1)
            )
        except TypeError:
            ascending = False
        if ascending:
            try:
                out = np.zeros(n, dtype=np.int32)
                col = table[self.column]
                for b in self.bounds:
                    ge = pc.fill_null(pc.greater_equal(col, pa.scalar(b)), False)
                    if isinstance(ge, pa.ChunkedArray):
                        ge = ge.combine_chunks()
                    out += np.asarray(ge, dtype=np.int32)
                return out
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError):
                pass  # mixed-type bounds: scalar loop below decides
        vals = table[self.column].to_pylist()
        out = np.empty(n, dtype=np.int32)
        for i, v in enumerate(vals):
            p = 0
            for b in self.bounds:
                if v is not None and v >= b:
                    p += 1
                else:
                    break
            out[i] = p
        return out

    def to_dict(self) -> dict:
        return {"kind": "range", "column": self.column, "bounds": self.bounds}
