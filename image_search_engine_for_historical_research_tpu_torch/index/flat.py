"""Exact (flat) index: the brute-force matcher as a device-resident scan.

Port of ``FlatIndex`` and ``build_flat`` in
``image_search_engine_for_historical_research_tpu/index/flat.py`` (:23-95).
Vectors are stored row-normalized for ``metric="cosine"``, so a search is
one score GEMM + top-k (``ops.topk.exact_topk``); bf16 storage halves the
bytes a scan reads. bf16 vectors are saved as a uint16 bit-cast
(``vectors_bf16``), as the JAX package saves them, so either package loads
the other's artifact. ``Int8FlatIndex`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import exact_topk
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
        JAX signature; the scan is exact on every device (``exact_topk``)."""
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
            bits = self.vectors.to(torch.bfloat16).cpu().view(torch.int16).numpy()
            return meta, {"vectors_bf16": bits.view(np.uint16)}
        return meta, {"vectors": self.vectors.float().cpu().numpy()}

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)
        if "vectors_bf16" in arrays:
            bits = np.ascontiguousarray(arrays["vectors_bf16"]).view(np.int16)
            v = torch.from_numpy(bits).view(torch.bfloat16)
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
