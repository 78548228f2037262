"""PQ index: compressed search by an asymmetric-distance code scan.

Port of ``PQIndex`` and ``build_pq`` in
``image_search_engine_for_historical_research_tpu/index/pq.py`` (:31-333).
Codes are ``(N, M)`` in the JAX package's dtype (uint16 at Ks=2^13), or
``(N, M/2)`` uint8 when ``pack4``; with ``refine_M > 0`` a
second PQ over the residuals gives every row ``refine_M`` more bytes and
``search`` re-ranks an ADC shortlist from the two-level reconstructions
(faiss ``IndexPQR``). The artifact (kind ``"pq"``) has the JAX package's
arrays and dtypes, so either package loads the other's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pq import (
    PQCodebook,
    cat_codes,
    codes_from_numpy,
    codes_to_numpy,
    opq_train,
    pq_decode,
    pq_encode,
    pq_pack4,
    pq_refine_rerank,
    pq_search,
    pq_train,
    train_indices,
)
from .base import StageClock, normalize_rows, register
from .streaming import f32_rows, row_pieces, stream_encode_pieces, stream_gather_rows


def _clamp_divisor(refine_M: int, D: int) -> int:
    """The largest divisor of ``D`` not above ``refine_M``."""
    refine_M = min(refine_M, D)
    while D % refine_M:
        refine_M -= 1
    return refine_M


def _f32(a) -> np.ndarray:
    """A float tensor as a host f32 array (an artifact's)."""
    return a.float().cpu().numpy()


def _opt(arrays, name, device, codes=False):
    if name not in arrays:
        return None
    if codes:
        return codes_from_numpy(arrays[name], device)
    return torch.as_tensor(np.asarray(arrays[name], np.float32), device=device)


@register("pq")
@dataclass
class PQIndex:
    codewords: torch.Tensor   # (M, Ks, ds); codes (N, M), or (N, M/2) when
    codes: torch.Tensor       # packed4 (two 4-bit codes a byte, Ks <= 16)
    normalized: bool = True
    packed4: bool = False
    rotation: Optional[torch.Tensor] = None          # OPQ orthogonal pre-rotation
    refine_codewords: Optional[torch.Tensor] = None  # (Mr, Ksr, dsr)
    refine_codes: Optional[torch.Tensor] = None      # (N, Mr)
    refine_rotation: Optional[torch.Tensor] = None

    @property
    def codebook(self) -> PQCodebook:
        return PQCodebook(codewords=self.codewords, rotation=self.rotation)

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def search(self, queries, k: int, chunk: int = 262144,
               method: str = "auto", expand: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
        """``method``: ``"adc"`` (the full-scan LUT accumulate),
        ``"adc+refine"`` (an ADC shortlist of ``expand * k``, re-ranked from
        the two-level reconstructions; build with ``refine_M > 0``) or
        ``"auto"`` (``"adc+refine"`` when refine codes exist)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.normalized:
            q = normalize_rows(q)
        if method == "auto":
            method = "adc+refine" if self.refine_codes is not None else "adc"
        if method == "adc":
            return pq_search(self.codebook, self.codes, q, k, chunk=chunk, packed4=self.packed4)
        if method != "adc+refine":
            raise ValueError(f"unknown method {method!r}")
        if self.refine_codes is None:
            raise ValueError("method='adc+refine' requires refine codes (build with refine_M > 0)")
        if self.packed4:
            raise ValueError("adc+refine does not support packed4 codes")
        k_cand = min(max(expand * k, k), self.n)
        _, cand = pq_search(self.codebook, self.codes, q, k_cand, chunk=chunk)
        return pq_refine_rerank(
            self.codebook, self.codes,
            PQCodebook(self.refine_codewords, self.refine_rotation),
            self.refine_codes, q, cand, cand, torch.ones(cand.shape, dtype=torch.bool,
                                                         device=self.device), k,
        )

    def to_arrays(self):
        arrays = {"codewords": _f32(self.codewords), "codes": codes_to_numpy(self.codes)}
        if self.rotation is not None:
            arrays["rotation"] = _f32(self.rotation)
        if self.refine_codes is not None:
            arrays["refine_codewords"] = _f32(self.refine_codewords)
            arrays["refine_codes"] = codes_to_numpy(self.refine_codes)
            if self.refine_rotation is not None:
                arrays["refine_rotation"] = _f32(self.refine_rotation)
        return {"normalized": self.normalized, "packed4": self.packed4}, arrays

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)
        return cls(
            codewords=_opt(arrays, "codewords", dev),
            codes=_opt(arrays, "codes", dev, codes=True),
            normalized=bool(meta.get("normalized", True)),
            packed4=bool(meta.get("packed4", False)),
            rotation=_opt(arrays, "rotation", dev),
            refine_codewords=_opt(arrays, "refine_codewords", dev),
            refine_codes=_opt(arrays, "refine_codes", dev, codes=True),
            refine_rotation=_opt(arrays, "refine_rotation", dev),
        )


def _train_refine(residuals, refine_M, refine_Ks, iters, seed, opq, opq_iters):
    """The residual (refine) codebook: OPQ when ``opq``, else plain PQ."""
    if opq:
        return opq_train(residuals, M=refine_M, Ks=refine_Ks, iters=iters,
                         opq_iters=opq_iters, seed=seed + 1)
    return pq_train(residuals, M=refine_M, Ks=refine_Ks, iters=iters, seed=seed + 1)


def fit_and_encode(vecs, n, M, Ks, iters, seed, normalize, train_sample, coarse_opq,
                   refine_opq, opq_iters, refine_M, refine_Ks, dev, clock, who, mesh=None):
    """The codebooks and codes of a PQ build (``build_pq`` and
    ``build_hnsw_pq`` share them): ``(cb, codes (N, M), rcb, refine codes
    (N, refine_M))``, the refine pair None without ``refine_M``.

    ``vecs`` is a matrix, or a callable chunk source with ``n=`` rows. The
    coarse fit is OPQ when ``coarse_opq``; the residual fit, on a
    ``max(16384, 32 * refine_Ks)``-row sample (``train_indices`` with
    ``seed + 1``), when ``refine_opq``. ``refine_M`` is clamped to the
    largest divisor of D. A streamed source trains on gathered samples (the
    in-memory rule), and either way one pass over the build grid
    (``index.streaming``) encodes both levels, so a streamed build equals an
    in-memory one bit for bit given the same explicit ``train_sample``.
    ``mesh`` shards the coarse fit (``ops.pq.pq_train`` / ``opq_train``);
    the residual fit runs on each rank alone, as in the JAX package."""
    streaming = callable(vecs)
    if streaming:
        if n is None:
            raise ValueError(f"{who}(vecs=<callable>) needs the total row count n=")
        N = int(n)
    else:
        v = f32_rows(torch.as_tensor(vecs, device=dev), normalize)
        N = v.shape[0]
    rs = min(N, max(16384, 32 * refine_Ks))
    ridx = train_indices(N, rs, seed + 1) if rs < N else np.arange(N)
    if streaming:
        ts = min(N, train_sample if train_sample is not None else max(65536, 32 * Ks))
        idx_sets = [train_indices(N, ts, seed) if ts < N else np.arange(N)]
        gathered = stream_gather_rows(vecs, N, idx_sets + ([ridx] if refine_M else []),
                                      normalize=normalize, device=dev)
        fit_rows, refine_rows = gathered[0], (gathered[1] if refine_M else None)
        del gathered
        clock.tick("gather_s")
        # the gathered rows are the sample; an explicit train_sample passes
        # through to OPQ (parity with the in-memory build), None keeps
        # opq_train's own 8*Ks / 16*Ks budgets
        ts = int(fit_rows.shape[0])
        pq_ts, opq_ts = ts, (ts if train_sample is not None else None)
    else:
        fit_rows = v
        refine_rows = v[torch.as_tensor(ridx, device=dev)] if refine_M else None
        pq_ts = opq_ts = train_sample
    D = int(fit_rows.shape[1])
    if coarse_opq:
        cb = opq_train(fit_rows, M=M, Ks=Ks, iters=iters, opq_iters=opq_iters, seed=seed,
                       train_sample=opq_ts, mesh=mesh)
    else:
        cb = pq_train(fit_rows, M=M, Ks=Ks, iters=iters, seed=seed, train_sample=pq_ts,
                      mesh=mesh)
    del fit_rows
    clock.tick("fit_s")
    rcb = None
    if refine_M:
        # the residual codebook trains on the row sample, encoded on its own
        # (pq_encode is row-local) before the one pass over every row
        residuals = refine_rows - pq_decode(cb, pq_encode(cb, refine_rows))
        del refine_rows
        rcb = _train_refine(residuals, _clamp_divisor(refine_M, D), refine_Ks, iters, seed,
                            refine_opq, opq_iters)
        del residuals
        clock.tick("refine_fit_s")
    pieces = (stream_encode_pieces(vecs, N, normalize=normalize, device=dev)
              if streaming else row_pieces(v))
    parts, rparts = [], []
    for _, piece in pieces:
        code = pq_encode(cb, piece)
        parts.append(code)
        if rcb is not None:
            rparts.append(pq_encode(rcb, piece - pq_decode(cb, code)))
        del piece, code
    codes = cat_codes(parts)
    del parts
    rcodes = cat_codes(rparts) if rcb is not None else None
    clock.tick("encode_s")
    return cb, codes, rcb, rcodes


def build_pq(
    vecs,
    M: int = 16,
    Ks: int = 256,
    iters: int = 20,
    seed: int = 42,
    normalize: bool = True,
    train_sample: Optional[int] = None,
    pack4: bool = False,
    opq: bool = False,
    opq_iters: int = 10,
    n: Optional[int] = None,
    refine_M: int = 0,
    refine_Ks: int = 256,
    device="cuda",
    stats: Optional[dict] = None,
    mesh=None,
) -> PQIndex:
    """Train the codebooks on the database and encode it, on ``device``.

    Rows are L2-normalized first (``normalize``) and held in f32. Above
    Ks=2048 the fit subsamples and runs bf16 assignment matmuls unless told
    otherwise (``ops.pq.pq_train``). ``refine_M > 0`` (clamped to the largest
    divisor of D) adds the residual codes of the ``adc+refine`` route;
    ``opq`` learns an orthogonal pre-rotation for both levels; ``pack4``
    packs Ks <= 16 codes two a byte.

    **Streaming build**: ``vecs`` may be a callable yielding ``(c, D)`` row
    chunks (numpy or tensors) with the total row count as ``n=``
    (``fit_and_encode``). ``stats``, when a dict, receives each stage's
    seconds. ``mesh`` (a ``parallel.data_mesh``) shards the coarse fit's
    rows over the ranks, each of which builds the same index."""
    if pack4 and refine_M:
        raise ValueError("refine_M and pack4 are mutually exclusive")
    if pack4 and Ks > 16:
        raise ValueError("pack4 requires Ks <= 16 (the Quick-ADC geometry)")
    dev = resolve_device(device)
    if mesh is not None:
        from ..parallel.mesh import full_rows

        vecs = full_rows(vecs)
    cb, codes, rcb, rcodes = fit_and_encode(
        vecs, n, M, Ks, iters, seed, normalize, train_sample, opq, opq, opq_iters, refine_M,
        refine_Ks, dev, StageClock(stats, dev), "build_pq", mesh=mesh)
    if pack4:
        codes = pq_pack4(codes)
    return PQIndex(codewords=cb.codewords, codes=codes, normalized=normalize, packed4=pack4,
                   rotation=cb.rotation,
                   refine_codewords=rcb.codewords if rcb else None, refine_codes=rcodes,
                   refine_rotation=rcb.rotation if rcb else None)
