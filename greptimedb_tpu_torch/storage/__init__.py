from .engine import TimeSeriesEngine

__all__ = ["TimeSeriesEngine"]
