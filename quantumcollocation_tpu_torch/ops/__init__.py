"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""

from .build import build_all, launch_counts, reset_launch_counts

__all__ = ["build_all", "launch_counts", "reset_launch_counts"]
