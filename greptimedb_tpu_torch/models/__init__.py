from .catalog import Catalog, TableMeta
from .partition import PartitionRule, HashPartitionRule, RangePartitionRule, SingleRegionRule

__all__ = [
    "Catalog",
    "TableMeta",
    "PartitionRule",
    "HashPartitionRule",
    "RangePartitionRule",
    "SingleRegionRule",
]
