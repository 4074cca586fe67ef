from .data_type import ConcreteDataType
from .schema import ColumnSchema, Schema, SemanticType

__all__ = ["ConcreteDataType", "ColumnSchema", "Schema", "SemanticType"]
