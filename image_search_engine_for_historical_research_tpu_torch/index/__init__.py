"""Search backends with the build/search/save/load contract: the exact flat
index, HNSW (native host build or device build) and the PQ family (PQ,
HNSW over PQ codes, IVF-PQ)."""

from .base import load_index, normalize_rows, register, save_index
from .flat import FlatIndex, build_flat
from .graph_build import build_hnsw_device
from .hnsw import HNSWIndex, HNSWPQIndex, build_hnsw, build_hnsw_pq
from .ivfpq import IVFPQIndex, build_ivfpq
from .pq import PQIndex, build_pq

__all__ = [
    "load_index", "normalize_rows", "register", "save_index",
    "FlatIndex", "build_flat", "HNSWIndex", "build_hnsw", "build_hnsw_device",
    "PQIndex", "build_pq", "IVFPQIndex", "build_ivfpq", "HNSWPQIndex", "build_hnsw_pq",
]
