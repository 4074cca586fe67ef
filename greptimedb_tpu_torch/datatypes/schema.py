"""Schema / ColumnSchema with time-index and semantic-type metadata.

Mirrors the reference's `Schema`/`ColumnSchema` (reference
src/datatypes/src/schema/) and the TAG/FIELD/TIMESTAMP semantic split that
the metric engine and PromQL planner rely on (reference
src/store-api/src/metadata.rs `SemanticType`).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field

import pyarrow as pa

from ..utils.errors import ColumnNotFoundError, InvalidArgumentsError
from .data_type import ConcreteDataType


class SemanticType(enum.IntEnum):
    TAG = 0        # primary-key member (series identity)
    FIELD = 1      # measured value
    TIMESTAMP = 2  # the single time index


@dataclass
class ColumnSchema:
    name: str
    data_type: ConcreteDataType
    semantic_type: SemanticType = SemanticType.FIELD
    nullable: bool = True
    default: object = None
    # Stable column identity (reference store-api ColumnMetadata.column_id):
    # survives renames of other columns and distinguishes a re-added column
    # from a previously dropped one of the same name.  0 = unassigned; the
    # Schema constructor allocates ids.
    column_id: int = 0
    # Fulltext-indexed (reference datatypes fulltext options on ColumnSchema;
    # declared as `col STRING FULLTEXT INDEX` — SSTs get a tokenized
    # inverted index consulted by matches()/matches_term()).
    fulltext: bool = False
    # VECTOR(dim) columns: embedding dimension (reference VectorType dim;
    # values are little-endian f32 bytes).  `VECTOR INDEX` adds an IVF-flat
    # ANN sidecar at flush.
    vector_dim: int | None = None
    vector_index: bool = False

    def __post_init__(self):
        if self.semantic_type == SemanticType.TIMESTAMP:
            if not self.data_type.is_timestamp():
                raise InvalidArgumentsError(
                    f"time index column {self.name!r} must be a timestamp, got {self.data_type}"
                )
            self.nullable = False

    def to_arrow(self) -> pa.Field:
        meta = {
            b"greptime:semantic_type": str(int(self.semantic_type)).encode(),
            b"greptime:type": self.data_type.value.encode(),
            b"greptime:column_id": str(self.column_id).encode(),
        }
        return pa.field(self.name, self.data_type.to_arrow(), nullable=self.nullable, metadata=meta)

    @classmethod
    def from_arrow(cls, f: pa.Field) -> "ColumnSchema":
        meta = f.metadata or {}
        sem = SemanticType(int(meta.get(b"greptime:semantic_type", b"1")))
        return cls(
            name=f.name,
            data_type=ConcreteDataType.from_arrow(f.type),
            semantic_type=sem,
            nullable=f.nullable,
            column_id=int(meta.get(b"greptime:column_id", 0)),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "data_type": self.data_type.value,
            "semantic_type": int(self.semantic_type),
            "nullable": self.nullable,
            "default": self.default,
            "column_id": self.column_id,
            "fulltext": self.fulltext,
            "vector_dim": self.vector_dim,
            "vector_index": self.vector_index,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnSchema":
        return cls(
            name=d["name"],
            data_type=ConcreteDataType(d["data_type"]),
            semantic_type=SemanticType(d["semantic_type"]),
            nullable=d.get("nullable", True),
            default=d.get("default"),
            column_id=d.get("column_id", 0),
            fulltext=d.get("fulltext", False),
            vector_dim=d.get("vector_dim"),
            vector_index=d.get("vector_index", False),
        )


@dataclass
class Schema:
    columns: list[ColumnSchema] = field(default_factory=list)
    version: int = 0
    # Monotonic id allocator — never reused, even after DROP COLUMN, so a
    # re-added name gets a NEW id and old SST data for the dropped column
    # reads as NULL instead of resurrecting (reference mito2 compat by
    # column_id).  0 = derive from the columns present.
    next_column_id: int = 0

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise InvalidArgumentsError(f"duplicate column names in schema: {names}")
        ts = [c for c in self.columns if c.semantic_type == SemanticType.TIMESTAMP]
        if len(ts) > 1:
            raise InvalidArgumentsError("schema may have at most one time index column")
        # Allocate ids for unassigned columns (fresh CREATE or legacy data):
        # position-based, deterministic across identical schema builds.
        max_id = max((c.column_id for c in self.columns), default=0)
        for c in self.columns:
            if c.column_id == 0:
                max_id += 1
                c.column_id = max_id
        if self.next_column_id <= max_id:
            self.next_column_id = max_id + 1
        self._index = {c.name: i for i, c in enumerate(self.columns)}

    # ---- access -----------------------------------------------------------
    def column(self, name: str) -> ColumnSchema:
        i = self._index.get(name)
        if i is None:
            raise ColumnNotFoundError(f"column not found: {name}")
        return self.columns[i]

    def column_index(self, name: str) -> int:
        i = self._index.get(name)
        if i is None:
            raise ColumnNotFoundError(f"column not found: {name}")
        return i

    def has_column(self, name: str) -> bool:
        return name in self._index

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def time_index(self) -> ColumnSchema | None:
        for c in self.columns:
            if c.semantic_type == SemanticType.TIMESTAMP:
                return c
        return None

    def tag_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.semantic_type == SemanticType.TAG]

    def field_columns(self) -> list[ColumnSchema]:
        return [c for c in self.columns if c.semantic_type == SemanticType.FIELD]

    def primary_key(self) -> list[str]:
        return [c.name for c in self.tag_columns()]

    # ---- evolution (reference mito2/src/read/compat.rs) -------------------
    def add_column(self, col: ColumnSchema) -> "Schema":
        if self.has_column(col.name):
            raise InvalidArgumentsError(f"column {col.name!r} already exists")
        import dataclasses

        col = dataclasses.replace(col, column_id=self.next_column_id)
        return Schema(
            columns=self.columns + [col],
            version=self.version + 1,
            next_column_id=self.next_column_id + 1,
        )

    def drop_column(self, name: str) -> "Schema":
        col = self.column(name)
        if col.semantic_type != SemanticType.FIELD:
            raise InvalidArgumentsError("only FIELD columns can be dropped")
        return Schema(
            columns=[c for c in self.columns if c.name != name],
            version=self.version + 1,
            next_column_id=self.next_column_id,
        )

    # ---- conversions ------------------------------------------------------
    def to_arrow(self) -> pa.Schema:
        return pa.schema(
            [c.to_arrow() for c in self.columns],
            metadata={b"greptime:version": str(self.version).encode()},
        )

    @classmethod
    def from_arrow(cls, s: pa.Schema) -> "Schema":
        version = int((s.metadata or {}).get(b"greptime:version", b"0"))
        return cls(columns=[ColumnSchema.from_arrow(f) for f in s], version=version)

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "next_column_id": self.next_column_id,
                "columns": [c.to_dict() for c in self.columns],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Schema":
        d = json.loads(s)
        return cls(
            columns=[ColumnSchema.from_dict(c) for c in d["columns"]],
            version=d["version"],
            next_column_id=d.get("next_column_id", 0),
        )
