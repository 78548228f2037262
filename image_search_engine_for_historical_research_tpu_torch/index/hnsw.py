"""HNSW index: native C++ build on the host, level-0 search in the CUDA kernel.

Port of ``HNSWIndex`` and ``build_hnsw`` in
``image_search_engine_for_historical_research_tpu/index/hnsw.py`` (:38-209).

One behaviour differs from the JAX default on purpose: ``search`` routes to
the beam-search kernel (``use_kernel=True``, the counterpart of the JAX
``use_pallas=True``), because that kernel is the at-scale search path; the
JAX default, the lockstep traversal ``hnsw_search_batch``, is
``use_kernel=False`` here. The vectors may be f32 (``build_hnsw``) or bf16
(``graph_build.build_hnsw_device``); artifacts store them as f32, as the JAX
package does. ``HNSWPQIndex`` is not ported yet.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..native import load as load_native
from ..ops import beam_search
from ..ops.graph_search import hnsw_descend_entries, hnsw_search_batch
from .base import normalize_rows, register

MAX_LEVELS = 6


def _build_graph(data: np.ndarray, m: int, m0: int, ef: int, seed: int):
    """Run the native graph construction; returns (nbr0, nbru, levels, entry, top)."""
    lib = load_native("hnsw")
    ptr = ctypes.c_void_p
    lib.hnsw_build.argtypes = [
        ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ptr, ptr, ptr, ptr,
    ]
    lib.hnsw_build.restype = ctypes.c_int
    n, d = data.shape
    data = np.ascontiguousarray(data, np.float32)
    nbr0 = np.empty((n, m0), np.int32)
    nbru = np.empty((MAX_LEVELS - 1, n, m), np.int32)
    levels = np.empty((n,), np.int32)
    meta = np.empty((2,), np.int32)
    rc = lib.hnsw_build(
        data.ctypes.data, n, d, m, m0, ef, MAX_LEVELS, seed,
        nbr0.ctypes.data, nbru.ctypes.data, levels.ctypes.data, meta.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"hnsw_build failed with code {rc}")
    return nbr0, nbru, levels, int(meta[0]), int(meta[1])


@register("hnsw")
@dataclass
class HNSWIndex:
    vectors: torch.Tensor     # (N, D) f32 or bf16, L2-normalized
    nbr0: torch.Tensor        # (N, m0) int32, -1 padded
    nbru: torch.Tensor        # (MAX_LEVELS-1, N, m) int32, -1 padded
    entry: int
    ef_default: int = 100
    coarse_ids: Optional[torch.Tensor] = None  # upper-level member ids (seeds)
    _coarse_vecs: Optional[torch.Tensor] = field(default=None, init=False, repr=False)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return normalize_rows(q)

    def search(self, queries, k: int, ef: Optional[int] = None,
               use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``k`` ``(scores, ids)``; scores are ``-squared L2`` (descending).
        ``use_kernel=False`` takes the lockstep traversal (the JAX default)."""
        q = self._queries(queries)
        ef = ef or max(self.ef_default, k)
        if not use_kernel:
            return hnsw_search_batch(self.vectors, self.nbr0, self.nbru, self.entry, q, k, ef,
                                     coarse_ids=self.coarse_ids)
        return self.search_kernel(q, k, ef)

    def search_kernel(self, queries, k: int, ef: int, n_seeds: int = 1):
        """Level-0 beam search in the kernel (``ops.beam_search``).

        Entry points are the top inner products of the queries with the
        coarse (upper-level) nodes when the index has them, else the greedy
        upper-level descent. ``n_seeds > 1`` runs one beam per top-``n_seeds``
        coarse entry in a single launch and merges each query's beams,
        demoting ids already seen at a better score."""
        q = self._queries(queries)
        Q = q.shape[0]
        use_coarse = self.coarse_ids is not None and self.coarse_ids.shape[0] > 0
        s = max(1, int(n_seeds))
        if use_coarse:
            s = min(s, int(self.coarse_ids.shape[0]))
            if self._coarse_vecs is None:   # in the queries' f32, as JAX casts them
                self._coarse_vecs = self.vectors[self.coarse_ids.long()].to(q.dtype)
            _, top = torch.topk(q @ self._coarse_vecs.T, s, dim=1)
            starts = self.coarse_ids[top]                         # (Q, s)
        else:
            s = 1
            starts = hnsw_descend_entries(self.vectors, self.nbru, self.entry, q)[:, None]
        if s == 1:
            scores, ids = beam_search.beam_search(
                self.vectors, self.nbr0, q, starts[:, 0].contiguous(), ef=ef
            )
            return scores[:, :k], ids[:, :k]

        qs = q.repeat_interleave(s, dim=0)                        # (Q*s, D)
        scores, ids = beam_search.beam_search(
            self.vectors, self.nbr0, qs, starts.reshape(-1).contiguous(), ef=ef
        )
        scores = scores.reshape(Q, -1)
        ids = ids.reshape(Q, -1)
        order = torch.argsort(-scores, dim=1, stable=True)
        ids_o = ids.gather(1, order)
        sc_o = scores.gather(1, order)
        L = ids_o.shape[1]
        earlier = torch.ones(L, L, dtype=torch.bool, device=q.device).tril(-1)
        dup = ((ids_o[:, :, None] == ids_o[:, None, :]) & earlier).any(2)
        sc_o = sc_o.masked_fill(dup, float("-inf"))
        # stable descending sort: ties keep the lower index, as lax.top_k does
        ts, t = torch.sort(sc_o, dim=1, descending=True, stable=True)
        return ts[:, :k], ids_o.gather(1, t[:, :k])

    def to_arrays(self):
        arrays = {
            "vectors": self.vectors.float().cpu().numpy(),
            "nbr0": self.nbr0.cpu().numpy().astype(np.int32),
            "nbru": self.nbru.cpu().numpy().astype(np.int32),
        }
        if self.coarse_ids is not None:
            arrays["coarse_ids"] = self.coarse_ids.cpu().numpy().astype(np.int32)
        return {"entry": self.entry, "ef_default": self.ef_default}, arrays

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)

        def t(name, dtype):
            return torch.as_tensor(np.array(arrays[name], dtype), device=dev)

        return cls(
            vectors=t("vectors", np.float32),
            nbr0=t("nbr0", np.int32),
            nbru=t("nbru", np.int32),
            entry=int(meta["entry"]),
            ef_default=int(meta.get("ef_default", 100)),
            coarse_ids=t("coarse_ids", np.int32) if "coarse_ids" in arrays else None,
        )


def build_hnsw(
    vecs,
    m: int = 16,
    m0: Optional[int] = None,
    ef_construction: int = 100,
    seed: int = 42,
    normalize: bool = True,
    device="cuda",
) -> HNSWIndex:
    """Build an HNSW graph with the native C++ code on the host (m0 = 2m by
    default) and place the index on ``device``."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(vecs, np.float32))
    if normalize:
        v = normalize_rows(v)
    m0 = m0 or 2 * m
    nbr0, nbru, levels, entry, _ = _build_graph(v.numpy(), m, m0, ef_construction, seed)
    coarse = np.where(levels >= 1)[0].astype(np.int32)
    return HNSWIndex(
        vectors=v.to(dev),
        nbr0=torch.from_numpy(nbr0).to(dev),
        nbru=torch.from_numpy(nbru).to(dev),
        entry=entry,
        ef_default=max(ef_construction, 16),
        coarse_ids=torch.from_numpy(coarse).to(dev) if len(coarse) else None,
    )
