"""ConcreteDataType: the logical type lattice over Arrow physical types.

Mirrors the reference's `ConcreteDataType` (reference
src/datatypes/src/data_type.rs) but maps directly onto pyarrow types; the
device path additionally defines the torch dtype each type lowers to (strings and
other non-numeric types are dictionary-encoded to int32 codes on the host
before tiling, the same trick as the reference's primary-key pre-encoding in
mito-codec/src/row_converter/).
"""

from __future__ import annotations

import enum

import numpy as np
import pyarrow as pa

from ..utils.errors import InvalidArgumentsError


class ConcreteDataType(enum.Enum):
    NULL = "null"
    BOOLEAN = "boolean"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"
    BINARY = "binary"
    DATE = "date"
    TIMESTAMP_SECOND = "timestamp_s"
    TIMESTAMP_MILLISECOND = "timestamp_ms"
    TIMESTAMP_MICROSECOND = "timestamp_us"
    TIMESTAMP_NANOSECOND = "timestamp_ns"
    INTERVAL = "interval"
    JSON = "json"
    # Fixed-dimension float32 embedding, stored as little-endian f32 bytes
    # (reference datatypes vector type, stored as binary with dim metadata;
    # the dimension lives on ColumnSchema.vector_dim).
    VECTOR = "vector"

    # ---- classification ---------------------------------------------------
    def is_timestamp(self) -> bool:
        return self.value.startswith("timestamp")

    def is_numeric(self) -> bool:
        return self in _NUMERIC

    def is_float(self) -> bool:
        return self in (ConcreteDataType.FLOAT32, ConcreteDataType.FLOAT64)

    def is_signed(self) -> bool:
        return self in (
            ConcreteDataType.INT8,
            ConcreteDataType.INT16,
            ConcreteDataType.INT32,
            ConcreteDataType.INT64,
        )

    def is_string(self) -> bool:
        return self in (ConcreteDataType.STRING, ConcreteDataType.JSON)

    def timestamp_unit_ns(self) -> int:
        """Nanoseconds per unit of this timestamp type."""
        return {
            ConcreteDataType.TIMESTAMP_SECOND: 1_000_000_000,
            ConcreteDataType.TIMESTAMP_MILLISECOND: 1_000_000,
            ConcreteDataType.TIMESTAMP_MICROSECOND: 1_000,
            ConcreteDataType.TIMESTAMP_NANOSECOND: 1,
        }[self]

    # ---- conversions ------------------------------------------------------
    def to_arrow(self) -> pa.DataType:
        return _TO_ARROW[self]

    @classmethod
    def from_arrow(cls, t: pa.DataType) -> "ConcreteDataType":
        if pa.types.is_dictionary(t):
            return cls.from_arrow(t.value_type)
        for cdt, at in _TO_ARROW.items():
            if at == t:
                return cdt
        if pa.types.is_timestamp(t):
            return _TS_BY_UNIT[t.unit]
        if pa.types.is_large_string(t) or pa.types.is_string_view(t):
            return cls.STRING
        if pa.types.is_large_binary(t):
            return cls.BINARY
        raise InvalidArgumentsError(f"unsupported arrow type: {t}")

    @classmethod
    def parse(cls, s: str) -> "ConcreteDataType":
        """Parse a SQL type name (CREATE TABLE surface)."""
        key = s.strip().lower()
        if key in _SQL_ALIASES:
            return _SQL_ALIASES[key]
        if key.startswith("vector(") and key.endswith(")"):
            return cls.VECTOR
        raise InvalidArgumentsError(f"unknown data type: {s!r}")

    def to_numpy(self) -> np.dtype:
        if self.is_timestamp():
            return np.dtype("int64")
        if self == ConcreteDataType.BOOLEAN:
            return np.dtype("bool")
        if self in (
            ConcreteDataType.STRING,
            ConcreteDataType.BINARY,
            ConcreteDataType.JSON,
            ConcreteDataType.VECTOR,
        ):
            return np.dtype("object")
        return np.dtype(self.value)

    def to_torch(self):
        """The on-device dtype this column lowers to (None = host-encoded)."""
        import torch

        if self.is_timestamp() or self in (ConcreteDataType.INT64, ConcreteDataType.UINT64):
            return torch.int64
        if self == ConcreteDataType.BOOLEAN:
            return torch.bool
        if self in (ConcreteDataType.FLOAT32,):
            return torch.float32
        if self == ConcreteDataType.FLOAT64:
            return torch.float64
        if self.is_numeric():
            return torch.int32
        return None  # dictionary-encode on host -> int32 codes


_NUMERIC = {
    ConcreteDataType.INT8,
    ConcreteDataType.INT16,
    ConcreteDataType.INT32,
    ConcreteDataType.INT64,
    ConcreteDataType.UINT8,
    ConcreteDataType.UINT16,
    ConcreteDataType.UINT32,
    ConcreteDataType.UINT64,
    ConcreteDataType.FLOAT32,
    ConcreteDataType.FLOAT64,
}

_TO_ARROW = {
    ConcreteDataType.NULL: pa.null(),
    ConcreteDataType.BOOLEAN: pa.bool_(),
    ConcreteDataType.INT8: pa.int8(),
    ConcreteDataType.INT16: pa.int16(),
    ConcreteDataType.INT32: pa.int32(),
    ConcreteDataType.INT64: pa.int64(),
    ConcreteDataType.UINT8: pa.uint8(),
    ConcreteDataType.UINT16: pa.uint16(),
    ConcreteDataType.UINT32: pa.uint32(),
    ConcreteDataType.UINT64: pa.uint64(),
    ConcreteDataType.FLOAT32: pa.float32(),
    ConcreteDataType.FLOAT64: pa.float64(),
    ConcreteDataType.STRING: pa.string(),
    ConcreteDataType.BINARY: pa.binary(),
    ConcreteDataType.DATE: pa.date32(),
    ConcreteDataType.TIMESTAMP_SECOND: pa.timestamp("s"),
    ConcreteDataType.TIMESTAMP_MILLISECOND: pa.timestamp("ms"),
    ConcreteDataType.TIMESTAMP_MICROSECOND: pa.timestamp("us"),
    ConcreteDataType.TIMESTAMP_NANOSECOND: pa.timestamp("ns"),
    ConcreteDataType.INTERVAL: pa.duration("ms"),
    ConcreteDataType.JSON: pa.string(),
    ConcreteDataType.VECTOR: pa.binary(),
}

_TS_BY_UNIT = {
    "s": ConcreteDataType.TIMESTAMP_SECOND,
    "ms": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "us": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "ns": ConcreteDataType.TIMESTAMP_NANOSECOND,
}

_SQL_ALIASES = {
    "boolean": ConcreteDataType.BOOLEAN,
    "bool": ConcreteDataType.BOOLEAN,
    "tinyint": ConcreteDataType.INT8,
    "int8": ConcreteDataType.INT8,
    "smallint": ConcreteDataType.INT16,
    "int16": ConcreteDataType.INT16,
    "int": ConcreteDataType.INT32,
    "integer": ConcreteDataType.INT32,
    "int32": ConcreteDataType.INT32,
    "bigint": ConcreteDataType.INT64,
    "int64": ConcreteDataType.INT64,
    "tinyint unsigned": ConcreteDataType.UINT8,
    "uint8": ConcreteDataType.UINT8,
    "smallint unsigned": ConcreteDataType.UINT16,
    "uint16": ConcreteDataType.UINT16,
    "int unsigned": ConcreteDataType.UINT32,
    "uint32": ConcreteDataType.UINT32,
    "bigint unsigned": ConcreteDataType.UINT64,
    "uint64": ConcreteDataType.UINT64,
    "float": ConcreteDataType.FLOAT32,
    "float32": ConcreteDataType.FLOAT32,
    "real": ConcreteDataType.FLOAT32,
    "double": ConcreteDataType.FLOAT64,
    "float64": ConcreteDataType.FLOAT64,
    "string": ConcreteDataType.STRING,
    "text": ConcreteDataType.STRING,
    "varchar": ConcreteDataType.STRING,
    "char": ConcreteDataType.STRING,
    "binary": ConcreteDataType.BINARY,
    "varbinary": ConcreteDataType.BINARY,
    "blob": ConcreteDataType.BINARY,
    "date": ConcreteDataType.DATE,
    "timestamp": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "timestamp_s": ConcreteDataType.TIMESTAMP_SECOND,
    "timestamp_ms": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "timestamp_us": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "timestamp_ns": ConcreteDataType.TIMESTAMP_NANOSECOND,
    "timestamp(0)": ConcreteDataType.TIMESTAMP_SECOND,
    "timestamp(3)": ConcreteDataType.TIMESTAMP_MILLISECOND,
    "timestamp(6)": ConcreteDataType.TIMESTAMP_MICROSECOND,
    "timestamp(9)": ConcreteDataType.TIMESTAMP_NANOSECOND,
    "json": ConcreteDataType.JSON,
    "interval": ConcreteDataType.INTERVAL,
}
