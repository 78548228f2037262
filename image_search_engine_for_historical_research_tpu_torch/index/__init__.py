"""Search backends with the build/search/save/load contract (HNSW so far)."""

from .base import load_index, normalize_rows, register, save_index
from .hnsw import HNSWIndex, build_hnsw

__all__ = [
    "load_index", "normalize_rows", "register", "save_index",
    "HNSWIndex", "build_hnsw",
]
