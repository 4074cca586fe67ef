"""Build and load the port's hand-written CUDA kernels (csrc/*.cu)."""

from ._build import KERNEL_SOURCES, build_all

__all__ = ["KERNEL_SOURCES", "build_all"]
