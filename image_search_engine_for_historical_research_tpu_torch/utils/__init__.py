"""Utilities: metrics logging, and the tracing spans (``utils.tracing``)."""

from .profiling import MetricsLogger

__all__ = ["MetricsLogger"]
