"""Device graph construction: exact kNN candidates + heuristic prune.

Port of ``image_search_engine_for_historical_research_tpu/index/graph_build.py``
(:37-557). The native builder (``native/hnsw_build.cpp``) inserts one node at
a time on one host core; this builder does the distance work on the device,
which is what makes a 1M-image HNSW gallery buildable:

1. an exact kNN candidate graph from batched score GEMM + top-k scans
   (``ops.topk.exact_topk`` in bf16 with f32 scores);
2. the HNSW heuristic prune (keep a candidate only if it is closer to the
   node than, up to ``alpha``, to every neighbour already kept), run on the
   device: the JAX package's vmapped ``lax.scan`` becomes a loop over the K
   candidate columns, vectorised over a chunk's rows;
3. reverse edges (every kept edge ``src -> dst`` offered back to ``dst``),
   unioned with the candidates and pruned again;
4. geometric levels from ``np.random.default_rng(seed)`` on the host (so
   levels, entry point and coarse ids equal the JAX build's), a kNN graph per
   upper level, and the splice of those hierarchy edges into the level-0
   table.

The candidate pass is always exact (the JAX ``approximate=True`` is the
TPU's fused ``approx_max_k``; on the CPU JAX computes exact top-k too).
With ``mesh=`` (a ``parallel.data_mesh``) each batch's candidate scan is
``parallel.sharded_exact_topk`` over the gallery's rows sharded across the
ranks; pruning and levels are unchanged, so every rank builds the graph the
unsharded build gives (up to the order of exactly tied scores). Prune chunks
are bounded by a 1 GiB candidate-gather budget and a numpy source is
uploaded in chunks, so a 1M x 2048 build stays within the card's memory.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import exact_topk
from .base import normalize_rows

INF = float("inf")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _normalize_bf16_chunk(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize one chunk in f32 and emit bf16 (:37-43)."""
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=1, keepdim=True)
    return (x32 / n.clamp(min=1e-30)).to(torch.bfloat16)


def _prune_core(vectors, nbr_ids, nbr_scores, m: int, alpha: float = 1.2):
    """Heuristic-prune each node's candidate list (:46-104; the JAX
    ``_prune_chunk`` is this function under ``jit``).

    ``nbr_ids (B, K)`` are candidates by ascending distance (self
    excluded), ``nbr_scores (B, K)`` their f32 inner products with the node.
    Returns ``(ids (B, m) -1 padded, scores (B, m) -inf padded, n_kept (B,))``;
    ``n_kept`` counts the heuristic survivors only, the slots after them hold
    the nearest skipped candidates (keepPrunedConnections backfill)."""
    B, K = nbr_ids.shape
    if K < m:  # tiny galleries / m > k_candidates: pad candidate columns
        pad = m - K
        nbr_ids = torch.cat([nbr_ids, nbr_ids.new_full((B, pad), -1)], 1)
        nbr_scores = torch.cat([nbr_scores, nbr_scores.new_full((B, pad), -1e30)], 1)
        K = m
    cand = vectors[nbr_ids.clamp(min=0).long()]                 # (B, K, D)
    # pairwise candidate similarity -> squared L2 (unit vectors): 2 - 2 s
    if cand.dtype == torch.float32:
        sims = torch.bmm(cand, cand.transpose(1, 2))
    elif cand.device.type == "cuda":
        sims = torch.bmm(cand, cand.transpose(1, 2), out_dtype=torch.float32)
    else:
        c32 = cand.float()
        sims = torch.bmm(c32, c32.transpose(1, 2))
    d_cc = 2.0 - 2.0 * sims                                     # (B, K, K)
    d_nc = 2.0 - 2.0 * nbr_scores.float()                       # (B, K)

    # scan the candidates in order: keep j iff no kept neighbour is closer to
    # j (by the factor alpha, Vamana-style relaxed pruning) than the node is
    valid_in = nbr_ids >= 0
    kept = torch.zeros((B, K), dtype=torch.bool, device=nbr_ids.device)
    n_kept = torch.zeros(B, dtype=torch.int32, device=nbr_ids.device)
    for j in range(K):
        d_j_kept = torch.where(kept, d_cc[:, j, :], INF)
        closer_to_kept = (d_j_kept * alpha < d_nc[:, j:j + 1]).any(1)
        ok = ~closer_to_kept & (n_kept < m) & valid_in[:, j]
        kept[:, j] = ok
        n_kept += ok.int()
    # survivors first, then the nearest skipped candidates
    cols = torch.arange(K, device=nbr_ids.device)
    order = torch.argsort((~kept).long() * K + cols, dim=1)[:, :m]
    chosen = nbr_ids.gather(1, order)
    valid = chosen >= 0
    sc = torch.where(valid, nbr_scores.gather(1, order), -INF)
    return torch.where(valid, chosen, -1), sc, torch.clamp(n_kept, max=m)


def _dedup_rows_dev(ids, sc):
    """Mark duplicate ids within each row invalid (id -1, score -inf),
    keeping the earliest column among equals (:107-126)."""
    B, W = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    dup_sorted = torch.zeros((B, W), dtype=torch.bool, device=ids.device)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, -1, ids), torch.where(dup, -INF, sc)


def _union_reprune_chunk(vectors, c_ids, c_sc, b_ids, b_sc, m: int, alpha: float):
    """Reverse-edge union + re-prune for one node chunk (:129-144): concat
    candidates with backlinks, dedup, stable sort by descending score,
    heuristic-prune to ``m``."""
    u_ids = torch.cat([c_ids, b_ids], 1)
    u_sc = torch.cat([c_sc.float(), b_sc.float()], 1)
    u_ids, u_sc = _dedup_rows_dev(u_ids, u_sc)
    order = torch.argsort(-u_sc, dim=1, stable=True)
    ids, _, n_kept = _prune_core(vectors, u_ids.gather(1, order), u_sc.gather(1, order),
                                 m, alpha)
    return ids, n_kept


def _drop_self_chunk(sc, ix, row0: int):
    """Drop each row's own id from its top list wherever it appears; a row
    without a self hit drops its last column instead (:147-160)."""
    B, Ke = ix.shape
    rows = row0 + torch.arange(B, dtype=ix.dtype, device=ix.device)[:, None]
    self_mask = ix == rows
    first_self = self_mask.int().argmax(dim=1)
    has_self = self_mask.gather(1, first_self[:, None])[:, 0]
    drop = torch.where(has_self, first_self, Ke - 1)
    j = torch.arange(Ke - 1, device=ix.device)[None, :]
    gidx = j + (j >= drop[:, None]).long()
    return sc.gather(1, gidx), ix.gather(1, gidx)


def build_knn_graph(vectors: torch.Tensor, k: int = 64, batch: int = 4096,
                    matmul_dtype=torch.bfloat16, mesh=None):
    """Exact kNN graph ``(ids (N, k) int32, scores (N, k) f32)``, self
    excluded, from batched scans on ``vectors``' device (:163-222). With
    ``mesh``, each batch is scanned by ``parallel.sharded_exact_topk`` over
    the rows sharded across the ranks (N must divide the mesh)."""
    N = vectors.shape[0]
    k_eff = min(k + 1, N)
    if mesh is not None:
        from ..parallel import sharded_exact_topk
        from ..parallel.mesh import full_rows

        vectors = full_rows(vectors)

        def scan(q):
            return sharded_exact_topk(q, vectors, k_eff, mesh, matmul_dtype=matmul_dtype)
    else:
        def scan(q):
            return exact_topk(q, vectors, k_eff, matmul_dtype=matmul_dtype)
    id_chunks, sc_chunks = [], []
    for s in range(0, N, batch):
        sc, ix = scan(vectors[s:s + batch])
        sc, ix = _drop_self_chunk(sc, ix, s)
        sc_chunks.append(sc)
        id_chunks.append(ix.to(torch.int32))
    return torch.cat(id_chunks), torch.cat(sc_chunks)


def build_hnsw_graph_device(
    vectors: torch.Tensor,
    m: int = 16,
    m0: Optional[int] = None,
    k_candidates: int = 96,
    max_levels: int = 6,
    seed: int = 42,
    batch: int = 8192,
    alpha: float = 1.2,
    verbose: bool = False,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Full graph build on ``vectors``' device; returns ``(nbr0, nbru,
    levels, entry, top_level)`` as host arrays in the native builder's
    format. Port of ``build_hnsw_graph_tpu`` (:225-405). ``verbose`` prints
    each stage's seconds (host clock after a device synchronize). ``mesh``
    shards the kNN candidate pass (``build_knn_graph``)."""
    N, D = vectors.shape
    dev = vectors.device
    m0 = m0 or 2 * m
    k_candidates = min(k_candidates, N - 1)

    t0 = time.perf_counter()

    def _tick(stage):
        nonlocal t0
        if verbose:
            _sync(dev)
            t1 = time.perf_counter()
            print(f"[graph_build] {stage}: {t1 - t0:.3f} s", flush=True)
            t0 = t1

    cand_ids, cand_scores = build_knn_graph(vectors, k_candidates, batch, mesh=mesh)
    _tick("kNN candidate pass")

    # the prune stages gather (B, W, D) candidate rows per chunk: their batch
    # is capped by a 1 GiB gather budget, independent of the kNN batch
    def _prune_batch(W):
        budget = 1 << 30
        return max(256, min(batch, budget // (W * D * vectors.element_size())))

    p_chunks, s_chunks, k_chunks = [], [], []
    pb = _prune_batch(cand_ids.shape[1])
    for s in range(0, N, pb):
        p_c, s_c, k_c = _prune_core(vectors, cand_ids[s:s + pb], cand_scores[s:s + pb],
                                     m0, alpha)
        p_chunks.append(p_c)
        s_chunks.append(s_c)
        k_chunks.append(k_c)
    pruned, pruned_sc = torch.cat(p_chunks), torch.cat(s_chunks)
    fwd_kept = torch.cat(k_chunks)
    del p_chunks, s_chunks, k_chunks
    _tick("forward prune")

    # reverse-edge union: the heuristic again over candidates + backlinks
    bl_ids, bl_sc = _gather_backlinks_dev(pruned, pruned_sc, fwd_kept)
    del pruned, pruned_sc, fwd_kept
    _tick("backlink gather")
    n0_chunks, nk_chunks = [], []
    pb = _prune_batch(cand_ids.shape[1] + bl_ids.shape[1])
    for s in range(0, N, pb):
        n0_c, nk_c = _union_reprune_chunk(vectors, cand_ids[s:s + pb], cand_scores[s:s + pb],
                                          bl_ids[s:s + pb], bl_sc[s:s + pb], m0, alpha)
        n0_chunks.append(n0_c)
        nk_chunks.append(nk_c)
    del cand_ids, cand_scores, bl_ids, bl_sc
    nbr0 = torch.cat(n0_chunks).cpu().numpy()              # (N, m0) int32
    union_kept = torch.cat(nk_chunks).cpu().numpy()        # heuristic survivors per node
    _tick("reverse-union re-prune")

    # geometric levels + an exact kNN graph among each level's members
    rng = np.random.default_rng(seed)
    level_mult = 1.0 / np.log(m)
    levels = np.minimum(
        (-np.log(rng.uniform(size=N, low=1e-12, high=1.0)) * level_mult).astype(int),
        max_levels - 1,
    )
    nbru = np.full((max_levels - 1, N, m), -1, np.int32)
    for lvl in range(1, max_levels):
        members = np.where(levels >= lvl)[0]
        if len(members) <= 1:
            break
        mv = vectors[torch.from_numpy(members).to(dev)]
        k_lvl = min(m + 1, len(members))
        _, sub_ids = exact_topk(mv, mv, k_lvl, matmul_dtype=torch.bfloat16)
        sub_ids = sub_ids.cpu().numpy()
        B = len(members)
        self_mask = sub_ids == np.arange(B)[:, None]
        keep = np.ones_like(sub_ids, bool)
        first_self = np.argmax(self_mask, axis=1)
        has_self = self_mask[np.arange(B), first_self]
        keep[np.arange(B)[has_self], first_self[has_self]] = False
        keep[~has_self, -1] = False
        local = sub_ids[keep].reshape(B, k_lvl - 1)[:, :m]
        glob = members[local]
        out = np.full((B, m), -1, np.int32)
        out[:, : glob.shape[1]] = glob
        nbru[lvl - 1][members] = out

    top_level = int(levels.max())
    entry = int(np.argmax(levels))

    # Splice the hierarchy edges into the level-0 table (:359-403). The
    # one-shot kNN build has no insert-order long-range links, so a tight
    # cluster can be a disconnected component at level 0; the upper-level
    # kNN graphs span clusters. On each hub node tail slots are replaced by
    # its hierarchy edges: backfill slots first, cutting into heuristic
    # survivors only down to m0/8 hierarchy links and never more than m0/2.
    # Rows are deduped (an id twice in a row would enter the beam twice).
    hier = np.concatenate([nbru[lvl] for lvl in range(max_levels - 1)], 1)
    comb = np.concatenate([nbr0, hier], 1)  # locals first: dedup keeps them
    _dedup_np_rows(comb)
    W = comb.shape[1]
    cols = np.arange(W)[None, :]
    valid = comb >= 0
    vl = valid & (cols < m0)
    vh = valid & (cols >= m0)
    n_h = vh.sum(1)
    n_backfill = np.maximum(m0 - union_kept, 0)
    n_evict = np.minimum(np.minimum(n_h, m0 // 2), np.maximum(n_backfill, m0 // 8))
    n_keep_local = m0 - n_evict
    keep_l = vl & ((np.cumsum(vl, 1) - 1) < n_keep_local[:, None])
    kept_l = keep_l.sum(1)
    keep_h = vh & ((np.cumsum(vh, 1) - 1) < (m0 - kept_l)[:, None])
    keep = keep_l | keep_h
    key = np.where(keep, cols, W)
    comp = np.take_along_axis(comb, np.argsort(key, axis=1, kind="stable"), 1)[:, :m0]
    nbr0 = np.ascontiguousarray(np.where(np.arange(m0)[None, :] < keep.sum(1)[:, None], comp, -1))
    _tick("levels")
    return nbr0, nbru, levels.astype(np.int32), entry, top_level


def _gather_backlinks_dev(pruned, pruned_sc, fwd_kept):
    """Per-node reverse-edge lists ``(ids, ip scores)``, -1/-inf padded
    ``(N, m0)`` (:408-455).

    A reverse edge ``dst <- src`` exists for every heuristic-survivor edge
    ``src -> dst`` (backfill slots are not edges); its score is read off the
    source's pruned row. Each node keeps its nearest ``m0`` backlinks: the
    edges are ordered by destination, then by descending score, then by
    source (the JAX two-key stable ``lax.sort``; here a stable sort by score,
    then a stable sort by destination)."""
    N, m0 = pruned.shape
    dev = pruned.device
    rank_ok = torch.arange(m0, device=dev)[None, :] < fwd_kept[:, None]
    node = torch.arange(N, device=dev)
    ok = (pruned >= 0) & (pruned != node[:, None]) & rank_ok

    src = node[:, None].expand(N, m0).reshape(-1)
    dst = torch.where(ok, pruned.long(), N).reshape(-1)    # invalid edges sort last
    negsc = torch.where(ok, -pruned_sc, INF).reshape(-1)

    by_score = torch.argsort(negsc, stable=True)
    perm = by_score[torch.argsort(dst[by_score], stable=True)]
    dst_s, negsc_s, src_s = dst[perm], negsc[perm], src[perm]
    # position of each edge within its destination's group
    starts = torch.searchsorted(dst_s, node)
    pos = torch.arange(N * m0, device=dev) - starts[dst_s.clamp(0, N - 1)]
    keep = (dst_s < N) & (pos < m0)

    # scatter only the kept edges: an out-of-range row is dropped, never wrapped
    bl_ids = torch.full((N, m0), -1, dtype=torch.int32, device=dev)
    bl_ids[dst_s[keep], pos[keep]] = src_s[keep].to(torch.int32)
    bl_sc = torch.full((N, m0), -INF, dtype=torch.float32, device=dev)
    bl_sc[dst_s[keep], pos[keep]] = -negsc_s[keep]
    return bl_ids, bl_sc


def _dedup_np_rows(ids):
    """In place: later duplicates of an id in a row become -1, the earliest
    column is kept (:458-470)."""
    B, W = ids.shape
    order = np.argsort(ids, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(ids, order, 1)
    dup_sorted = np.zeros((B, W), bool)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = np.zeros((B, W), bool)
    np.put_along_axis(dup, order, dup_sorted, 1)
    ids[dup] = -1


def _dedup_rows(ids, sc):
    """In place: mark duplicate ids within each row invalid (id -1, score
    -inf), keeping the earliest column (:473-486)."""
    B, W = ids.shape
    order = np.argsort(ids, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(ids, order, 1)
    dup_sorted = np.zeros((B, W), bool)
    dup_sorted[:, 1:] = (sorted_ids[:, 1:] == sorted_ids[:, :-1]) & (sorted_ids[:, 1:] >= 0)
    dup = np.zeros((B, W), bool)
    np.put_along_axis(dup, order, dup_sorted, 1)
    ids[dup] = -1
    sc[dup] = -np.inf


def build_hnsw_device(
    vecs,
    m: int = 16,
    m0: Optional[int] = None,
    k_candidates: int = 96,
    seed: int = 42,
    normalize: bool = True,
    batch: int = 8192,
    alpha: float = 1.2,
    verbose: bool = False,
    device="cuda",
    mesh=None,
):
    """Build an ``HNSWIndex`` on ``device`` with the device graph builder.
    Port of ``build_hnsw_tpu`` (:489-557). ``mesh`` (a ``parallel.data_mesh``
    on ``device``'s type; N must divide it) shards the kNN candidate pass.

    Vectors are stored bf16 (half the bytes of a scan; bf16 distances only
    reorder near-ties). A numpy source stays on the host and is uploaded,
    normalized and cast in 65,536-row chunks into one bf16 buffer, so no
    full-size f32 copy exists on the device."""
    from .hnsw import HNSWIndex

    dev = resolve_device(device)
    if mesh is not None:
        from ..parallel.mesh import full_rows, mesh_size

        mesh_size(mesh)                                  # TypeError for a non-mesh
        if mesh.device_type != dev.type:
            raise ValueError(f"build_hnsw_device(device={str(dev)!r}) with a "
                             f"{mesh.device_type!r} mesh")
        vecs = full_rows(vecs)
    host_src = not torch.is_tensor(vecs)
    N, D = vecs.shape
    chunk = 65536
    if normalize and N > chunk:
        v = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
        for s in range(0, N, chunk):
            v[s:s + chunk] = _normalize_bf16_chunk(torch.as_tensor(vecs[s:s + chunk]).to(dev))
    elif normalize:
        v = normalize_rows(torch.as_tensor(vecs).to(dev).float()).to(torch.bfloat16)
    elif host_src:
        v = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
        for s in range(0, N, chunk):
            v[s:s + chunk] = torch.as_tensor(vecs[s:s + chunk]).to(dev)
    else:
        v = vecs.to(dev)
    if v.dtype != torch.bfloat16:
        v = v.to(torch.bfloat16)
    nbr0, nbru, levels, entry, _ = build_hnsw_graph_device(
        v, m=m, m0=m0, k_candidates=k_candidates, seed=seed, batch=batch, alpha=alpha,
        verbose=verbose, mesh=mesh,
    )
    coarse = np.where(levels >= 1)[0].astype(np.int32)
    return HNSWIndex(
        vectors=v,
        nbr0=torch.from_numpy(nbr0).to(dev),
        nbru=torch.from_numpy(nbru).to(dev),
        entry=entry,
        ef_default=100,
        coarse_ids=torch.from_numpy(coarse).to(dev) if len(coarse) else None,
    )
