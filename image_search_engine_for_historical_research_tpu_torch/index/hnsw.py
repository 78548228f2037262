"""HNSW index: native C++ build on the host, level-0 search in the CUDA kernel.

Port of ``image_search_engine_for_historical_research_tpu/index/hnsw.py``:
``HNSWIndex`` and ``build_hnsw`` (:38-209), and the PQ variant
``HNSWPQIndex`` / ``build_hnsw_pq`` with ``_rerank_members`` and
``_rerank_refine`` (:212-963).

One behaviour differs from the JAX default on purpose: ``search`` routes to
the beam-search kernel (``use_kernel=True``, the counterpart of the JAX
``use_pallas=True``), because that kernel is the at-scale search path; the
JAX default, the lockstep traversal ``hnsw_search_batch``, is
``use_kernel=False`` here. The vectors may be f32 (``build_hnsw``) or bf16
(``graph_build.build_hnsw_device``); artifacts store them as f32, as the JAX
package does.

The PQ variant keeps the reference's structure: encode the database,
deduplicate identical code rows, build the graph over the unique codes'
decodes, search with the asymmetric LUT (or a full ADC scan of the unique
codes), then expand unique-code hits to image ids through two flat group
arrays, on the host, as the JAX package does. Its graph is built by the
native builder or on the device (``builder="device"``; ``"tpu"``, the JAX
package's name, is accepted for it); ``"auto"`` takes the device above 32,768
unique codes. Node centroid sums are ``ops.kmeans.segment_sum_rows``, in row
order on every device.
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
from ..ops.graph_search import (
    hnsw_descend_entries,
    hnsw_search_batch,
    hnsw_search_batch_pq,
    hnsw_search_batch_pq_centroid,
)
from ..ops.kmeans import segment_sum_rows
from ..ops.pq import (
    PQCodebook,
    codes_from_numpy,
    codes_to_numpy,
    pq_decode,
    pq_encode,
    pq_refine_rerank,
    pq_search,
)
from ..ops.topk import _top_exact
from .base import StageClock, normalize_rows, register
from .pq import _f32, fit_and_encode

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
            _, top = _top_exact(q @ self._coarse_vecs.T, s)     # lax.top_k's ties
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


def _rerank_members(vectors, q, cand_idx, valid, k: int):
    """Exact inner-product re-rank of expanded member candidates against the
    L2-normalized gallery ``vectors`` (the query in the gallery's dtype)."""
    v = vectors[cand_idx.long()]                                # (Q, E, D)
    s = torch.bmm(v, q.to(v.dtype)[:, :, None])[:, :, 0]
    s = torch.where(valid, s.float(), float("-inf"))
    top_s, top_j = _top_exact(s, k)
    return top_s, cand_idx.gather(1, top_j)


# the JAX package's name for the codes-only re-rank of expanded members (the
# unique-code rows are the coarse side)
_rerank_refine = pq_refine_rerank


@register("hnsw_pq")
@dataclass
class HNSWPQIndex:
    codewords: torch.Tensor     # (M, Ks, ds)
    unique_codes: torch.Tensor  # (U, M)
    nbr0: torch.Tensor          # (U, m0) int32
    nbru: torch.Tensor
    entry: int
    group_offsets: np.ndarray   # (U+1,) member ranges into group_members (host)
    group_members: np.ndarray   # (N,) image ids grouped by unique code (host)
    ef_default: int = 100
    coarse_ids: Optional[torch.Tensor] = None  # upper-level members (ADC seeds)
    # second-level residual codes, indexed by image id (members of one code
    # differ in their residual): the codes-only *+refine re-rank
    refine_codewords: Optional[torch.Tensor] = None  # (Mr, Ksr, dsr)
    refine_codes: Optional[torch.Tensor] = None      # (N, Mr)
    # OPQ rotations: coarse codes live in rotated space, refine codes
    # quantize original-space residuals
    rotation: Optional[torch.Tensor] = None
    refine_rotation: Optional[torch.Tensor] = None
    # per-node centroid refine codes and ||centroid||^2 (the centroid walk)
    node_codes: Optional[torch.Tensor] = None        # (U, Mr)
    node_norm2: Optional[torch.Tensor] = None        # (U,) f32

    @property
    def n(self) -> int:
        return int(self.group_members.shape[0])

    @property
    def device(self) -> torch.device:
        return self.unique_codes.device

    def search(self, queries, k: int, ef: Optional[int] = None, method: str = "auto",
               vectors=None, expand: int = 4, n_seeds: int = 8,
               centroid_walk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(scores, ids)`` over image ids: unique-code hits expanded in rank
        order until ``k`` member slots are filled.

        ``method``: ``"adc"`` (exact ADC scan of the unique codes, then
        expand); ``"adc+rerank"`` (expand to ``expand * k`` slots and re-rank
        by inner product against the raw normalized ``vectors``);
        ``"adc+refine"`` (the same expansion, re-ranked from coarse + residual
        codes; build with ``refine_M > 0``); ``"graph"`` (the beam walk over
        the code graph); ``"graph+refine"`` (an ``ef``-wide walk with
        ``n_seeds`` coarse seeds, then the refine re-rank); ``"auto"``
        (``"adc+refine"`` with refine codes, else ``"adc"``). The walks use
        the centroid distance when the index has node codes and
        ``centroid_walk``."""
        q = normalize_rows(torch.as_tensor(queries, dtype=torch.float32, device=self.device))
        U = self.unique_codes.shape[0]
        if method == "auto":
            method = "adc+refine" if self.refine_codes is not None else "adc"
        rerank = method == "adc+rerank"
        refine = method in ("adc+refine", "graph+refine")
        if rerank and vectors is None:
            raise ValueError("method='adc+rerank' requires the raw `vectors`")
        if refine and self.refine_codes is None:
            raise ValueError(f"method={method!r} requires refine codes (build with refine_M > 0)")
        n_slots = min(expand * k, self.n) if (rerank or refine) else k
        if method in ("adc", "adc+rerank", "adc+refine"):
            k_unique = min(max(n_slots, 1), U)
            scores_u, idx_u = pq_search(PQCodebook(self.codewords, self.rotation),
                                        self.unique_codes, q, k_unique)
        elif method in ("graph", "graph+refine"):
            # the walk's shortlist is its beam: ef unique codes, expanded to
            # n_slots member slots
            ef_eff = ef or max(self.ef_default, k)
            k_unique = min(max(ef_eff, k), U) if refine else min(k, U)
            if centroid_walk and self.node_codes is not None:
                scores_u, idx_u = hnsw_search_batch_pq_centroid(
                    self.unique_codes, self.codewords, self.node_codes, self.refine_codewords,
                    self.node_norm2, self.nbr0, self.nbru, self.entry, q, k_unique,
                    max(ef_eff, k_unique), coarse_ids=self.coarse_ids, n_seeds=n_seeds,
                    rotation=self.rotation, node_rotation=self.refine_rotation,
                )
            else:
                q_g = q @ self.rotation if self.rotation is not None else q
                scores_u, idx_u = hnsw_search_batch_pq(
                    self.unique_codes, self.codewords, self.nbr0, self.nbru, self.entry, q_g,
                    k_unique, max(ef_eff, k_unique), coarse_ids=self.coarse_ids,
                    n_seeds=n_seeds,
                )
        else:
            raise ValueError(f"unknown method {method!r}")
        out_scores, out_idx, out_u, valid, total = self._expand_members(
            idx_u.cpu().numpy(), scores_u.float().cpu().numpy(), n_slots
        )
        dev = self.device
        if rerank:
            top_s, top_i = _rerank_members(
                torch.as_tensor(vectors, device=dev), q, torch.as_tensor(out_idx, device=dev),
                torch.as_tensor(valid, device=dev), k,
            )
            out_scores = top_s.cpu().numpy().astype(np.float32)
            out_idx = top_i.cpu().numpy().astype(np.int32)
        elif refine:
            top_s, top_i = _rerank_refine(
                PQCodebook(self.codewords, self.rotation), self.unique_codes,
                PQCodebook(self.refine_codewords, self.refine_rotation), self.refine_codes, q,
                torch.as_tensor(out_u, device=dev), torch.as_tensor(out_idx, device=dev),
                torch.as_tensor(valid, device=dev), k,
            )
            out_scores = top_s.cpu().numpy().astype(np.float32)
            out_idx = top_i.cpu().numpy().astype(np.int32)

        for row in np.nonzero(total < k)[0]:  # rare: backfill with unlisted ids
            fill = int(min(total[row], k))
            missing = np.setdiff1d(np.arange(self.n), out_idx[row, :fill])[: k - fill]
            out_idx[row, fill:fill + len(missing)] = missing
        return (torch.as_tensor(np.ascontiguousarray(out_scores[:, :k]), device=dev),
                torch.as_tensor(np.ascontiguousarray(out_idx[:, :k]), device=dev))

    def _expand_members(self, idx_u, scores_u, k):
        """Rank-order group expansion to ``k`` member slots on the host (the
        JAX package's numpy, as it is): slot j of query q belongs to the hit
        whose cumulative member count first exceeds j. Returns (scores, idx,
        ucode_idx, valid, total): (Q, k) arrays and (Q,) totals; ``ucode_idx``
        is each slot's unique-code row."""
        U = self.unique_codes.shape[0]
        Q, ku = idx_u.shape
        offs, members = self.group_offsets, self.group_members

        safe_u = np.clip(idx_u, 0, U - 1)
        cnt = np.where(idx_u >= 0, offs[safe_u + 1] - offs[safe_u], 0)  # (Q, ku)
        cum = np.cumsum(cnt, axis=1)
        total = cum[:, -1]
        before = cum - cnt  # member slots filled before each hit

        band = np.int64(self.n + 1)  # cum <= n < band: rows occupy disjoint bands
        rows = band * np.arange(Q, dtype=np.int64)[:, None]
        flat_cum = (cum + rows).ravel()
        j = np.arange(k, dtype=np.int64)[None, :]
        r = np.searchsorted(flat_cum, (j + rows).ravel(), side="right").reshape(
            Q, k
        ) - ku * np.arange(Q, dtype=np.int64)[:, None]
        valid = j < np.minimum(total, k)[:, None]
        r = np.minimum(r, ku - 1)

        qi = np.arange(Q)[:, None]
        pos = offs[safe_u[qi, r]] + (j - before[qi, r])
        out_idx = np.where(valid, members[np.minimum(pos, self.n - 1)], 0).astype(
            np.int32
        )
        out_scores = np.where(valid, scores_u[qi, r], -np.inf).astype(np.float32)
        out_u = np.where(valid, safe_u[qi, r], 0).astype(np.int32)
        return out_scores, out_idx, out_u, valid, total

    def to_arrays(self):
        arrays = {
            "codewords": _f32(self.codewords),
            "unique_codes": codes_to_numpy(self.unique_codes),
            "nbr0": self.nbr0.cpu().numpy().astype(np.int32),
            "nbru": self.nbru.cpu().numpy().astype(np.int32),
            "group_offsets": np.asarray(self.group_offsets, np.int64),
            "group_members": np.asarray(self.group_members, np.int32),
        }
        if self.coarse_ids is not None:
            arrays["coarse_ids"] = self.coarse_ids.cpu().numpy().astype(np.int32)
        if self.refine_codes is not None:
            arrays["refine_codewords"] = _f32(self.refine_codewords)
            arrays["refine_codes"] = codes_to_numpy(self.refine_codes)
        if self.rotation is not None:
            arrays["rotation"] = _f32(self.rotation)
        if self.refine_rotation is not None:
            arrays["refine_rotation"] = _f32(self.refine_rotation)
        if self.node_codes is not None:
            arrays["node_codes"] = codes_to_numpy(self.node_codes)
            arrays["node_norm2"] = _f32(self.node_norm2)
        return {"entry": self.entry, "ef_default": self.ef_default}, arrays

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)

        def f32(name):
            if name not in arrays:
                return None
            return torch.as_tensor(np.asarray(arrays[name], np.float32), device=dev)

        def codes(name):
            return codes_from_numpy(arrays[name], dev) if name in arrays else None

        return cls(
            codewords=f32("codewords"),
            unique_codes=codes("unique_codes"),
            nbr0=torch.as_tensor(np.asarray(arrays["nbr0"], np.int32), device=dev),
            nbru=torch.as_tensor(np.asarray(arrays["nbru"], np.int32), device=dev),
            entry=int(meta["entry"]),
            group_offsets=np.asarray(arrays["group_offsets"]),
            group_members=np.asarray(arrays["group_members"]),
            ef_default=int(meta.get("ef_default", 100)),
            coarse_ids=(torch.as_tensor(np.asarray(arrays["coarse_ids"], np.int32), device=dev)
                        if "coarse_ids" in arrays else None),
            refine_codewords=f32("refine_codewords"),
            refine_codes=codes("refine_codes"),
            rotation=f32("rotation"),
            refine_rotation=f32("refine_rotation"),
            node_codes=codes("node_codes"),
            node_norm2=f32("node_norm2"),
        )


def build_hnsw_pq(
    vecs,
    M: int = 16,
    Ks: int = 256,
    m: int = 16,
    m0: Optional[int] = None,
    ef_construction: int = 100,
    iters: int = 20,
    seed: int = 42,
    normalize: bool = True,
    train_sample: Optional[int] = None,
    builder: str = "auto",
    refine_M: int = 32,
    refine_Ks: int = 256,
    opq=False,
    opq_iters: int = 10,
    n: Optional[int] = None,
    max_graph_bytes: int = 12 << 30,
    graph_k_candidates: int = 96,
    graph_alpha: float = 1.2,
    device="cuda",
    stats: Optional[dict] = None,
) -> HNSWPQIndex:
    """PQ-encode, dedupe the codes, and graph the unique codes, on ``device``.

    ``builder``: ``"native"`` (the C++ insert on the host), ``"device"``
    (kNN graph + prune on the device, ``index.graph_build``; ``"tpu"`` is
    the same), or ``"auto"`` (the device above 32,768 unique codes).
    ``refine_M > 0`` (default 32; clamped to the largest divisor of D) adds
    per-image residual codes and per-node centroid codes for the
    ``*+refine`` methods and the centroid walk. ``opq``: ``True`` rotates
    both code levels, ``"refine"`` only the residual level (the coarse codes
    keep their dedup). When the f32 centroid buffers would pass
    ``max_graph_bytes``, each node's centroid code is its first member's.

    ``vecs`` passed as a one-element list is taken out of the list (the
    caller's reference goes, so the gallery can be freed before the decoded
    graph rows exist). **Streaming build**: ``vecs`` may be a callable
    yielding ``(c, D)`` row chunks with the total row count as ``n=``; fits
    then train on gathered samples (equal to an in-memory build given the
    same explicit ``train_sample``) and one more pass encodes both levels.
    ``stats``, when a dict, receives each stage's seconds, ``U`` and the
    builder taken."""
    if isinstance(vecs, list):
        vecs = vecs.pop()  # empty the caller's holder: transfer ownership
    if opq not in (False, True, "refine"):
        raise ValueError(f"opq must be False, True, or 'refine'; got {opq!r}")
    if builder not in ("auto", "native", "device", "tpu"):
        raise ValueError(f"unknown builder {builder!r}")
    dev = resolve_device(device)
    clock = StageClock(stats, dev)
    # opq=True rotates both levels, "refine" only the residual level
    cb, codes_dev, rcb, refine_codes = fit_and_encode(
        vecs, n, M, Ks, iters, seed, normalize, train_sample, opq is True, bool(opq), opq_iters,
        refine_M, refine_Ks, dev, clock, "build_hnsw_pq")
    del vecs

    N = codes_dev.shape[0]
    codes = codes_to_numpy(codes_dev)
    del codes_dev
    unique, inverse = np.unique(codes, return_inverse=True, axis=0)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=unique.shape[0])
    offsets = np.zeros(unique.shape[0] + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    members = order.astype(np.int32)

    m0 = m0 or 2 * m
    U = unique.shape[0]
    if builder == "auto":
        builder = "device" if U > 32_768 else "native"
    clock.tick("unique_s")
    if stats is not None:
        stats.update(U=int(U), builder=builder)
    codewords, rotation = cb.codewords, cb.rotation
    del cb

    # node centroids: each unique code's mean member residual, re-quantized
    # with the refine codebook (the centroid walk's node distance); over the
    # memory budget, each node takes its first member's refine code
    node_codes = node_norm2 = None
    D_full = int(codewords.shape[0] * codewords.shape[2])
    if refine_codes is not None and (2 * 4 + 2) * U * D_full > max_graph_bytes:
        node_codes = codes_from_numpy(codes_to_numpy(refine_codes)[members[offsets[:-1]]], dev)
    elif refine_codes is not None:
        inv = torch.as_tensor(inverse, device=dev)
        acc = torch.zeros((U, D_full), dtype=torch.float32, device=dev)
        step_n = 131072
        for s0 in range(0, N, step_n):
            segment_sum_rows(acc, inv[s0:s0 + step_n], pq_decode(rcb, refine_codes[s0:s0 + step_n]))
        invcnt = torch.as_tensor((1.0 / counts).astype(np.float32), device=dev)
        acc *= invcnt[:, None]
        node_codes = pq_encode(rcb, acc)
        del acc, inv
    clock.tick("centroids_s")

    if builder in ("device", "tpu"):
        from .graph_build import build_hnsw_graph_device

        # the unique-code graph lives decoded on the device: refuse clearly
        # when it cannot fit instead of running out of memory mid-build
        graph_bytes = int(U) * D_full * 2
        if graph_bytes > max_graph_bytes:
            raise ValueError(
                f"unique-code graph needs {graph_bytes / 2**30:.1f} GiB decoded ({U} unique "
                f"codes), over the max_graph_bytes budget ({max_graph_bytes / 2**30:.1f} GiB). "
                "PQ dedup collapses at this scale/Ks; use build_ivfpq(refine_M=...) for the "
                "beyond-graph regime, or raise max_graph_bytes if the device has the memory."
            )
        # decoded to bf16 a chunk at a time, straight into one buffer; the
        # graph rows are coarse decodes (in the rotated space), the centroid
        # norms are of coarse + refine decodes in the original space
        uq = codes_from_numpy(unique, dev)
        decoded = torch.empty((U, D_full), dtype=torch.bfloat16, device=dev)
        n2 = torch.empty((U,), dtype=torch.float32, device=dev) if node_codes is not None else None
        step = 131072
        for s in range(0, U, step):
            chunk = uq[s:s + step]
            decoded[s:s + step] = pq_decode(PQCodebook(codewords), chunk).to(torch.bfloat16)
            if node_codes is not None:
                cent = (pq_decode(PQCodebook(codewords, rotation), chunk)
                        + pq_decode(rcb, node_codes[s:s + step]))
                n2[s:s + step] = (cent * cent).sum(1)
        del uq
        node_norm2 = n2
        nbr0, nbru, levels, entry, _ = build_hnsw_graph_device(
            decoded, m=m, m0=m0, seed=seed, k_candidates=graph_k_candidates, alpha=graph_alpha,
        )
        del decoded
    else:
        cw = codewords.float().cpu().numpy()
        M_, _, ds = cw.shape
        decoded = cw[np.arange(M_)[None, :], unique.astype(np.int64), :]
        decoded = np.ascontiguousarray(decoded.reshape(U, M_ * ds), np.float32)
        if node_codes is not None:
            # per-node centroid norms (the graph rows stay coarse decodes)
            rcw = rcb.codewords.float().cpu().numpy()
            Mr_, _, dsr = rcw.shape
            nc = codes_to_numpy(node_codes).astype(np.int64)
            rdec = rcw[np.arange(Mr_)[None, :], nc, :].reshape(U, Mr_ * dsr)
            if rcb.rotation is not None:
                rdec = rdec @ rcb.rotation.float().cpu().numpy().T
            cent = (decoded @ rotation.float().cpu().numpy().T
                    if rotation is not None else decoded) + rdec
            node_norm2 = torch.as_tensor(
                np.sum(cent.astype(np.float64) ** 2, axis=1).astype(np.float32), device=dev)
            del cent, rdec
        nbr0, nbru, levels, entry, _ = _build_graph(decoded, m, m0, ef_construction, seed)
    clock.tick("graph_s")
    coarse = np.where(levels >= 1)[0].astype(np.int32)
    return HNSWPQIndex(
        codewords=codewords,
        unique_codes=codes_from_numpy(unique, dev),
        nbr0=torch.from_numpy(np.ascontiguousarray(nbr0)).to(dev),
        nbru=torch.from_numpy(np.ascontiguousarray(nbru)).to(dev),
        entry=entry,
        group_offsets=offsets,
        group_members=members,
        ef_default=max(ef_construction, 16),
        coarse_ids=torch.from_numpy(coarse).to(dev) if len(coarse) else None,
        refine_codewords=rcb.codewords if rcb is not None else None,
        refine_codes=refine_codes,
        rotation=rotation,
        refine_rotation=rcb.rotation if rcb is not None else None,
        node_codes=node_codes,
        node_norm2=node_norm2,
    )
