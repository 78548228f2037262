"""Search backends with the build/search/save/load contract: the exact flat
index and HNSW (native host build or device build)."""

from .base import load_index, normalize_rows, register, save_index
from .flat import FlatIndex, build_flat
from .graph_build import build_hnsw_device
from .hnsw import HNSWIndex, build_hnsw

__all__ = [
    "load_index", "normalize_rows", "register", "save_index",
    "FlatIndex", "build_flat", "HNSWIndex", "build_hnsw", "build_hnsw_device",
]
