"""Exact (flat) indexes: the brute-force matcher as a device-resident scan.

Port of ``FlatIndex``, ``build_flat``, ``Int8FlatIndex`` and
``build_flat_i8`` in
``image_search_engine_for_historical_research_tpu/index/flat.py`` (:23-215).
Vectors are stored row-normalized for ``metric="cosine"``, so a search is
one score GEMM + top-k (``ops.topk.exact_topk``); bf16 storage halves the
bytes a scan reads. bf16 vectors are saved as a uint16 bit-cast
(``vectors_bf16``), as the JAX package saves them, so either package loads
the other's artifact.

``Int8FlatIndex`` (kind ``flat_i8``) keeps the gallery as per-row int8
codes and scales (``ops.int8``), with an optional bf16 copy that re-ranks a
``shortlist`` exactly (saved as ``rerank_bf16``, a uint16 bit-cast).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.int8 import QUANT_CHUNK, _iter_blocks, int8_topk, int8_topk_rerank, quantize_rows_int8
from ..ops.topk import exact_topk
from ..utils import tracing
from .base import normalize_rows, register


@register("flat")
@dataclass
class FlatIndex:
    vectors: torch.Tensor         # (N, D), normalized when metric == "cosine"
    metric: str = "cosine"        # "cosine" (ip on normalized rows) or "l2"
    storage_dtype: str = "float32"

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def search(self, queries, k: int, chunk: int = 262144,
               approximate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``k`` ``(scores, ids)``. ``approximate`` is accepted for the
        JAX signature; the scan is exact on every device (``exact_topk``).
        The device span ``index.flat.search``."""
        with tracing.span("index.flat.search", device=self.device):
            q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
            if self.metric == "cosine":
                q = normalize_rows(q)
                metric = "ip"
            else:
                metric = "l2"
            matmul_dtype = torch.bfloat16 if self.storage_dtype == "bfloat16" else None
            return exact_topk(q, self.vectors, k, metric=metric, chunk=chunk,
                              matmul_dtype=matmul_dtype, approximate=approximate)

    def to_arrays(self):
        meta = {"metric": self.metric, "storage_dtype": self.storage_dtype}
        if self.storage_dtype == "bfloat16":
            # npz has no bf16: keep the bits at native width as uint16
            return meta, {"vectors_bf16": _bf16_to_bits(self.vectors)}
        return meta, {"vectors": self.vectors.float().cpu().numpy()}

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)
        if "vectors_bf16" in arrays:
            v = _bits_to_bf16(arrays["vectors_bf16"])
        else:  # includes f32-persisted bf16 artifacts
            bf16 = meta.get("storage_dtype") == "bfloat16"
            v = torch.as_tensor(np.asarray(arrays["vectors"], np.float32))
            v = v.to(torch.bfloat16) if bf16 else v
        return cls(vectors=v.to(dev), metric=meta["metric"],
                   storage_dtype=meta.get("storage_dtype", "float32"))


def build_flat(vecs, metric: str = "cosine", storage_dtype: str = "float32",
               device="cuda") -> FlatIndex:
    """Flat index over ``vecs (N, D)`` on ``device``: rows normalized for
    ``"cosine"``, then stored in ``storage_dtype``."""
    dev = resolve_device(device)
    v = torch.as_tensor(vecs, device=dev)
    if v.dtype not in (torch.float32, torch.bfloat16):
        v = v.float()
    if metric == "cosine":
        v = normalize_rows(v)
    if storage_dtype == "bfloat16":
        v = v.to(torch.bfloat16)
    return FlatIndex(vectors=v, metric=metric, storage_dtype=storage_dtype)


def _bf16_to_bits(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np.uint16)


def _bits_to_bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


@register("flat_i8")
@dataclass
class Int8FlatIndex:
    """Flat index over an int8 gallery: 1 byte a dimension and one f32 scale
    a row (2 GB at 1M x 2048). ``rerank_vectors`` (bf16) re-ranks the int8
    scan's ``shortlist`` exactly; without it the int8 scores rank alone.
    Cosine metric only."""

    codes: torch.Tensor                            # (N, D) int8
    scales: torch.Tensor                           # (N,) f32
    rerank_vectors: Optional[torch.Tensor] = None  # (N, D) bf16
    shortlist: int = 512

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def search(self, queries, k: int,
               approximate: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``k`` ``(scores, ids)`` of the normalized queries. ``approximate``
        is accepted for the JAX signature; the top-k is exact (``ops.int8``)."""
        q = normalize_rows(torch.as_tensor(queries, dtype=torch.float32, device=self.device))
        if self.rerank_vectors is not None:
            return int8_topk_rerank(q, self.codes, self.scales, self.rerank_vectors, k,
                                    shortlist=max(self.shortlist, k))
        return int8_topk(q, self.codes, self.scales, k)

    def to_arrays(self):
        meta = {"shortlist": self.shortlist, "has_rerank": self.rerank_vectors is not None}
        arrays = {"codes": self.codes.cpu().numpy(),
                  "scales": self.scales.float().cpu().numpy()}
        if self.rerank_vectors is not None:
            arrays["rerank_bf16"] = _bf16_to_bits(self.rerank_vectors)
        return meta, arrays

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)
        rr = None
        if meta.get("has_rerank") and "rerank_bf16" in arrays:
            rr = _bits_to_bf16(arrays["rerank_bf16"]).to(dev)
        return cls(
            codes=torch.as_tensor(np.asarray(arrays["codes"], np.int8), device=dev),
            scales=torch.as_tensor(np.asarray(arrays["scales"], np.float32), device=dev),
            rerank_vectors=rr,
            shortlist=int(meta.get("shortlist", 512)),
        )


def build_flat_i8(vecs, rerank: str = "bfloat16", shortlist: int = 512,
                  chunk: int = QUANT_CHUNK, device="cuda") -> Int8FlatIndex:
    """Quantize a gallery ``(N, D)`` to int8 on ``device``: rows are
    normalized in f32 a ``chunk``-row block at a time into one bf16 copy (no
    full-size f32 temporary; host input is uploaded block-wise), then
    quantized. ``rerank="bfloat16"`` keeps that copy for the exact re-rank;
    ``rerank="none"`` keeps codes and scales only."""
    dev = resolve_device(device)
    N, D = vecs.shape
    v = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for start, blk in _iter_blocks(vecs, chunk, dev):
        b = blk.float()
        v[start:start + b.shape[0]] = b / torch.linalg.vector_norm(
            b, dim=1, keepdim=True).clamp(min=1e-30)
    codes, scales = quantize_rows_int8(v, chunk)
    return Int8FlatIndex(codes=codes, scales=scales,
                         rerank_vectors=v if rerank == "bfloat16" else None,
                         shortlist=shortlist)
