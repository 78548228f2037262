"""Search backends with the build/search/save/load contract: the exact flat
indexes (f32/bf16 and int8), HNSW (native host build or device build), the
RP-forest and the PQ family (PQ, HNSW over PQ codes, IVF-PQ)."""

from .base import load_index, normalize_rows, register, save_index
from .flat import FlatIndex, Int8FlatIndex, build_flat, build_flat_i8
from .graph_build import build_hnsw_device
from .hnsw import HNSWIndex, HNSWPQIndex, build_hnsw, build_hnsw_pq
from .ivfpq import IVFPQIndex, build_ivfpq
from .pq import PQIndex, build_pq
from .rpforest import RPForestIndex, build_rpforest

__all__ = [
    "load_index", "normalize_rows", "register", "save_index",
    "FlatIndex", "build_flat", "Int8FlatIndex", "build_flat_i8", "RPForestIndex",
    "build_rpforest", "HNSWIndex", "build_hnsw", "build_hnsw_device",
    "PQIndex", "build_pq", "IVFPQIndex", "build_ivfpq", "HNSWPQIndex", "build_hnsw_pq",
]
