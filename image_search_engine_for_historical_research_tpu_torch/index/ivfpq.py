"""IVF-PQ index: coarse quantizer + residual PQ codes in flat inverted lists.

Port of ``image_search_engine_for_historical_research_tpu/index/ivfpq.py``
(:43-506): ``_ivfpq_search``, ``_ivfpq_rerank_refine``,
``IVFPQIndex`` and ``build_ivfpq``. FAISS ``IndexIVFPQ`` semantics: codes
are PQ codes of the residual ``x - coarse_center(x)``; a query probes its
``nprobe`` nearest lists. The lists are stored flat and sorted by list id
with per-list offsets and lengths; a probe scans a ``seg``-row window from
its list's offset (``seg`` defaults to the P99 list length rounded up to a
power of two, and longer lists are split into virtual lists that share the
centre). With ``refine_M > 0`` a second PQ over the reconstruction residual
gives the codes-only ``adc+refine`` re-rank (faiss ``IndexIVFPQR``).

- **Probing.** The JAX package maps over queries and scans over probes, each
  step a ``top_k`` of ``[best, segment]``. That equals one ``lax.top_k``
  over the probe-ordered concatenation of all ``nprobe * seg`` candidates
  behind ``k`` empty slots, which is what the port computes
  (``ops.topk._top_exact``), in blocks of queries so the gathered codes stay
  within ``PROBE_BUDGET`` elements.
- **Random draws.** The training sample (``_train_sample``) and the coarse
  fit (``_coarse_fit``) are the two places a build draws its randomness,
  from host generators seeded by ``seed``.
- **Sharded build.** ``mesh=`` (a ``parallel.data_mesh``) rounds the
  sample down to a multiple of the world size and shards the rows of the
  coarse, PQ (or OPQ) and refine fits over the ranks, each of which builds
  the same index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kmeans import _host_generator, kmeans_fit, kmeans_fit_sharded
from ..ops.pq import (
    PQCodebook,
    adc,
    codes_to_numpy,
    opq_train,
    pq_decode,
    pq_dist_table,
    pq_encode,
    pq_train,
    rerank_reconstructed,
)
from ..ops.topk import _top_exact
from .base import StageClock, normalize_rows, register
from .pq import _f32
from .streaming import f32_rows, row_pieces, stream_encode_pieces, stream_gather_rows

# elements of the (queries, nprobe, seg, M) code gather a query block may hold
PROBE_BUDGET = 1 << 26


def _ivfpq_search(
    coarse_centers,  # (nlist, D)
    codewords,       # (M, Ks, ds)
    flat_codes,      # (Npad, M) uint8/int32, sorted by list
    flat_ids,        # (Npad,) int32, -1 padding
    offsets,         # (nlist,) int32 start of each list
    lens,            # (nlist,) int32 true list lengths
    queries,         # (Q, D)
    rotation,        # None, or (D, D) orthogonal OPQ pre-rotation of residuals
    k: int,
    nprobe: int,
    seg: int,
):
    """``(scores (Q, k), ids (Q, k), flat positions (Q, k))`` of the best
    ``k`` ADC candidates in each query's ``nprobe`` nearest lists; empty
    slots score ``-inf`` with id -1 and position 0."""
    Q, D = queries.shape
    dev = queries.device
    M = codewords.shape[0]
    cb = PQCodebook(codewords, rotation)

    dots = queries @ coarse_centers.T
    c2 = (coarse_centers ** 2).sum(1)
    coarse_d = c2[None, :] - 2.0 * dots                                 # (Q, nlist)
    _, probe = _top_exact(-coarse_d, nprobe)                            # (Q, nprobe)

    seg_iota = torch.arange(seg, device=dev)
    block = max(1, PROBE_BUDGET // (nprobe * seg * M))
    out_s, out_i, out_p = [], [], []
    for b0 in range(0, Q, block):
        pb = probe[b0:b0 + block]
        B = pb.shape[0]
        pos = offsets[pb].long()[:, :, None] + seg_iota                 # (B, nprobe, seg)
        codes_seg = flat_codes[pos].long().reshape(B * nprobe, seg, M)
        ids_seg = flat_ids[pos]
        # residual LUTs of every probed list: (B * nprobe, M, Ks)
        resid = (queries[b0:b0 + block, None, :] - coarse_centers[pb]).reshape(B * nprobe, D)
        d = adc(pq_dist_table(cb, resid), codes_seg).reshape(B, nprobe, seg)
        in_list = seg_iota < lens[pb].long()[:, :, None]
        s = torch.where(in_list & (ids_seg >= 0), -d, float("-inf"))
        cand_s = torch.cat([torch.full((B, k), float("-inf"), device=dev), s.reshape(B, -1)], 1)
        cand_i = torch.cat([torch.full((B, k), -1, dtype=flat_ids.dtype, device=dev),
                            ids_seg.reshape(B, -1)], 1)
        cand_p = torch.cat([torch.zeros((B, k), dtype=torch.long, device=dev),
                            pos.reshape(B, -1)], 1)
        top_s, sel = _top_exact(cand_s, k)
        out_s.append(top_s)
        out_i.append(cand_i.gather(1, sel))
        out_p.append(cand_p.gather(1, sel))
    return torch.cat(out_s), torch.cat(out_i), torch.cat(out_p)


def _ivfpq_rerank_refine(coarse_centers, cb, flat_codes, flat_list, rcb, flat_refine,
                         q, cand_pos, cand_ids, k: int):
    """Codes-only re-rank of probed candidates (IVFADC+R): each candidate is
    ``coarse_center + decode(residual code) + decode(refine code)``, scored
    ``2 q.x - ||x||^2`` against the query."""
    Q, E = cand_pos.shape
    pos = cand_pos.reshape(-1)
    codes = flat_codes[pos].long()
    rcodes = flat_refine[pos].long()
    centers = coarse_centers[flat_list[pos].long()]
    recon = (centers + pq_decode(cb, codes) + pq_decode(rcb, rcodes)).reshape(Q, E, -1)
    return rerank_reconstructed(q, recon, cand_ids, cand_ids >= 0, k)


@register("ivfpq")
@dataclass
class IVFPQIndex:
    coarse_centers: torch.Tensor   # (nlist, D)
    codewords: torch.Tensor        # (M, Ks, ds)
    flat_codes: torch.Tensor       # (Npad, M), sorted by list
    flat_ids: torch.Tensor         # (Npad,), -1 padding
    offsets: torch.Tensor          # (nlist,)
    lens: torch.Tensor             # (nlist,)
    seg: int                       # per-probe scan window
    nprobe: int = 64
    normalized: bool = True
    rotation: Optional[torch.Tensor] = None  # optional (D, D) OPQ residual pre-rotation
    # second-level refinement codes over x - center - decode(code), in flat
    # (list-sorted) order beside flat_codes
    refine_codewords: Optional[torch.Tensor] = None  # (Mr, Ksr, dsr)
    flat_refine: Optional[torch.Tensor] = None       # (Npad, Mr)
    flat_list: Optional[torch.Tensor] = None         # (Npad,) int32 slot -> list id

    @property
    def n(self) -> int:
        return int(self.lens.sum())

    @property
    def device(self) -> torch.device:
        return self.flat_codes.device

    def search(self, queries, k: int, nprobe: Optional[int] = None, method: str = "auto",
               expand: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probe ``nprobe`` lists and rank by ADC. ``method``: ``"adc"``
        (faiss IndexIVFPQ), ``"adc+refine"`` (``expand * k`` candidate slots
        re-ranked from two-level reconstructions; build with ``refine_M >
        0``), ``"auto"`` (``"adc+refine"`` when refine codes exist)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.normalized:
            q = normalize_rows(q)
        k = min(k, self.n)
        if method == "auto":
            method = "adc+refine" if self.flat_refine is not None else "adc"
        if method not in ("adc", "adc+refine"):
            raise ValueError(f"unknown method {method!r}")
        if method == "adc+refine" and self.flat_refine is None:
            raise ValueError(
                "method='adc+refine' requires refine codes (build_ivfpq with refine_M > 0)"
            )
        n_slots = min(expand * k, self.n) if method == "adc+refine" else k
        s, i, p = _ivfpq_search(
            self.coarse_centers, self.codewords, self.flat_codes, self.flat_ids, self.offsets,
            self.lens, q, self.rotation, n_slots,
            min(nprobe or self.nprobe, self.coarse_centers.shape[0]), self.seg,
        )
        if method == "adc":
            return s, i
        return _ivfpq_rerank_refine(
            self.coarse_centers, PQCodebook(self.codewords, self.rotation), self.flat_codes,
            self.flat_list, PQCodebook(self.refine_codewords, None), self.flat_refine, q, p, i, k,
        )

    def to_arrays(self):
        arrays = {
            "coarse_centers": _f32(self.coarse_centers),
            "codewords": _f32(self.codewords),
            "flat_codes": codes_to_numpy(self.flat_codes),
            "flat_ids": self.flat_ids.cpu().numpy().astype(np.int32),
            "offsets": self.offsets.cpu().numpy().astype(np.int32),
            "lens": self.lens.cpu().numpy().astype(np.int32),
        }
        if self.rotation is not None:
            arrays["rotation"] = _f32(self.rotation)
        if self.flat_refine is not None:
            arrays["refine_codewords"] = _f32(self.refine_codewords)
            arrays["flat_refine"] = codes_to_numpy(self.flat_refine)
            arrays["flat_list"] = self.flat_list.cpu().numpy().astype(np.int32)
        return {"nprobe": self.nprobe, "normalized": self.normalized, "seg": self.seg}, arrays

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)

        def t(name, dtype=None):
            if name not in arrays:
                return None
            a = np.asarray(arrays[name]) if dtype is None else np.asarray(arrays[name], dtype)
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        return cls(
            coarse_centers=t("coarse_centers", np.float32),
            codewords=t("codewords", np.float32),
            flat_codes=t("flat_codes"),
            flat_ids=t("flat_ids", np.int32),
            offsets=t("offsets", np.int32),
            lens=t("lens", np.int32),
            seg=int(meta["seg"]),
            nprobe=int(meta["nprobe"]),
            normalized=bool(meta.get("normalized", True)),
            rotation=t("rotation", np.float32),
            refine_codewords=t("refine_codewords", np.float32),
            flat_refine=t("flat_refine"),
            flat_list=t("flat_list", np.int32),
        )


def _train_sample(N: int, n_train: int, seed: int) -> np.ndarray:
    """The training rows of a build: ``n_train`` distinct row ids in draw
    order, from a host generator seeded by ``seed``."""
    return torch.randperm(N, generator=_host_generator(seed))[:n_train].numpy()


def _coarse_fit(sample: torch.Tensor, nlist: int, iters: int, seed: int,
                mesh=None) -> torch.Tensor:
    """The coarse quantizer: ``nlist`` k-means centres of the sample, its
    rows sharded over ``mesh`` when one is given."""
    if mesh is not None:
        return kmeans_fit_sharded(sample, nlist, mesh, iters, seed=seed)[0]
    return kmeans_fit(sample, nlist, iters, seed=seed)[0]


def build_ivfpq(
    vecs,
    nlist: int = 316,
    M: int = 16,
    Ks: int = 256,
    nprobe: int = 64,
    iters: int = 20,
    seed: int = 42,
    train_fraction: float = 0.2,
    normalize: bool = True,
    seg: Optional[int] = None,
    opq: bool = False,
    opq_iters: int = 10,
    refine_M: int = 0,
    refine_Ks: int = 256,
    split_long: bool = True,
    n: Optional[int] = None,
    device="cuda",
    stats: Optional[dict] = None,
    mesh=None,
) -> IVFPQIndex:
    """Train the coarse and residual-PQ quantizers on a ``train_fraction``
    sample and pack flat inverted lists, on ``device`` (FAISS defaults:
    nlist=316, nprobe=64). ``opq`` learns an orthogonal pre-rotation of the
    residuals; ``refine_M > 0`` trains a second plain PQ over the
    reconstruction residuals; ``split_long`` splits lists longer than
    ``seg`` into ``seg``-row virtual lists that share the centre.

    **Streaming build**: ``vecs`` may be a callable yielding ``(c, D)`` row
    chunks with the total row count as ``n=``; the sample is gathered chunk
    by chunk in draw order (so the fits equal the in-memory ones) and the
    encode pass streams the chunks again. ``stats``, when a dict, receives
    each stage's seconds, ``seg`` and the number of (virtual) lists.
    ``mesh`` (a ``parallel.data_mesh``) rounds ``n_train`` down to a
    multiple of the world size and shards every fit's rows."""
    dev = resolve_device(device)
    clock = StageClock(stats, dev)
    world = 1
    if mesh is not None:
        from ..parallel.mesh import full_rows, mesh_size

        vecs, world = full_rows(vecs), mesh_size(mesh)
    streaming = callable(vecs)
    if streaming:
        if n is None:
            raise ValueError("build_ivfpq(vecs=<callable>) needs the total row count n=")
        N = int(n)
    else:
        v = f32_rows(torch.as_tensor(vecs, device=dev), normalize)
        N = v.shape[0]

    n_train = max(min(N, 64), int(N * train_fraction))
    n_train = max(world, n_train // world * world)     # sharded fits need rows that divide
    sample_idx = _train_sample(N, n_train, seed)
    if streaming:
        sample = stream_gather_rows(vecs, N, sample_idx, normalize=normalize, device=dev)
    else:
        sample = v[torch.as_tensor(sample_idx, device=dev)]

    clock.tick("sample_s")
    nlist = min(nlist, N)
    coarse_centers = _coarse_fit(sample, nlist, iters, seed, mesh=mesh)
    clock.tick("coarse_fit_s")

    # the residual PQ trains on the sample only (faiss semantics)
    c2 = (coarse_centers ** 2).sum(1)
    s_assign = torch.argmin(c2[None, :] - 2.0 * (sample @ coarse_centers.T), dim=1)
    r1 = sample - coarse_centers[s_assign]
    if opq:
        cb = opq_train(r1, M=M, Ks=Ks, iters=iters, opq_iters=opq_iters, seed=seed, mesh=mesh)
    else:
        cb = pq_train(r1, M=M, Ks=Ks, iters=iters, seed=seed, mesh=mesh)
    rcb = None
    if refine_M > 0:
        r2 = r1 - pq_decode(cb, pq_encode(cb, r1))
        rcb = pq_train(r2, M=refine_M, Ks=refine_Ks, iters=iters, seed=seed + 1, mesh=mesh)
        del r2
    del sample, s_assign, r1
    clock.tick("fit_s")

    # assign and residual-encode the database in row chunks (the chunk also
    # bounds the (chunk, nlist) coarse-score block)
    chunk_rows = min(131072, max(8192, (1 << 30) // (4 * nlist)))
    assign_h = np.empty((N,), np.int64)
    codes_h = np.empty((N, M), np.uint8 if Ks <= 256 else np.int32)
    refine_h = (np.empty((N, refine_M), np.uint8 if refine_Ks <= 256 else np.int32)
                if refine_M > 0 else None)

    pieces = (stream_encode_pieces(vecs, N, chunk_rows, normalize=normalize, device=dev)
              if streaming else row_pieces(v, chunk_rows))
    for s, part in pieces:
        a = torch.argmin(c2[None, :] - 2.0 * (part @ coarse_centers.T), dim=1)
        r = part - coarse_centers[a]
        code = pq_encode(cb, r)
        assign_h[s:s + part.shape[0]] = a.cpu().numpy()
        codes_h[s:s + part.shape[0]] = codes_to_numpy(code)
        if refine_M > 0:
            refine_h[s:s + part.shape[0]] = codes_to_numpy(pq_encode(rcb, r - pq_decode(cb, code)))

    clock.tick("encode_s")
    # pack flat sorted lists with offsets/lens
    order = np.argsort(assign_h, kind="stable")
    counts = np.bincount(assign_h, minlength=nlist)
    offsets = np.zeros(nlist, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])

    if seg is None:
        p99 = int(np.quantile(counts, 0.99)) if nlist > 1 else int(counts.max())
        seg = 1 << max(int(np.ceil(np.log2(max(p99, 128)))), 7)
    # tail padding so every probe window stays in bounds
    Npad = N + seg
    flat_codes = np.zeros((Npad, M), codes_h.dtype)
    flat_codes[:N] = codes_h[order]
    flat_ids = np.full((Npad,), -1, np.int32)
    flat_ids[:N] = order

    # virtual-list split: entries of an oversized list past the scan window
    # would be unreachable; seg-sized virtual lists sharing the centre tie in
    # the coarse top-k, so a big cluster takes adjacent probe slots
    parts = np.maximum(1, -(-counts // seg)) if split_long else np.ones(nlist, np.int64)
    if split_long and int(parts.sum()) > nlist:
        v_center = np.repeat(np.arange(nlist), parts)            # (nvirt,)
        first = np.cumsum(parts) - parts
        part_idx = np.arange(len(v_center)) - np.repeat(first, parts)
        v_offsets = offsets[v_center] + part_idx * seg
        v_lens = np.clip(counts[v_center] - part_idx * seg, 0, seg)
        centers_out = coarse_centers[torch.as_tensor(v_center, device=dev)]
        offsets_out, lens_out = v_offsets, v_lens
        # per-slot virtual list id (the refine re-rank gathers its centre by it)
        slot_list = first[assign_h[order]] + (np.arange(N) - offsets[assign_h[order]]) // seg
    else:
        centers_out, offsets_out, lens_out = coarse_centers, offsets, counts
        slot_list = assign_h[order]

    flat_refine = flat_list = None
    if refine_M > 0:
        fr = np.zeros((Npad, refine_M), refine_h.dtype)
        fr[:N] = refine_h[order]
        fl = np.zeros((Npad,), np.int32)
        fl[:N] = slot_list
        flat_refine = torch.as_tensor(fr, device=dev)
        flat_list = torch.as_tensor(fl, device=dev)
    clock.tick("pack_s")
    if stats is not None:
        stats.update(seg=int(seg), lists=int(centers_out.shape[0]))

    return IVFPQIndex(
        coarse_centers=centers_out,
        codewords=cb.codewords,
        flat_codes=torch.as_tensor(flat_codes, device=dev),
        flat_ids=torch.as_tensor(flat_ids, device=dev),
        offsets=torch.as_tensor(np.asarray(offsets_out, np.int32), device=dev),
        lens=torch.as_tensor(np.asarray(lens_out, np.int32), device=dev),
        seg=int(seg),
        nprobe=min(nprobe, centers_out.shape[0]),
        normalized=normalize,
        rotation=cb.rotation,
        refine_codewords=rcb.codewords if rcb is not None else None,
        flat_refine=flat_refine,
        flat_list=flat_list,
    )
