"""PromQL (TQL) for the port: the parser, the range-query engine and the
warm tile path over the device-resident super-tiles."""

from .engine import PromqlEngine

__all__ = ["PromqlEngine"]
