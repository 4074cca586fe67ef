from .engine import QueryEngine

__all__ = ["QueryEngine"]
