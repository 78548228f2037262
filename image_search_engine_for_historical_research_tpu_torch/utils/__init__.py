"""Utilities: metrics logging."""

from .profiling import MetricsLogger

__all__ = ["MetricsLogger"]
