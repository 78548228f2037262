"""HNSW upper-level greedy descent, in plain PyTorch.

Port of ``hnsw_descend_entries`` and its greedy descent in
``image_search_engine_for_historical_research_tpu/ops/graph_search.py``
(:37-61, :410-438). It gives the level-0 entry point of each query when an
index has no coarse level to seed from. The JAX package's lockstep level-0
traversal ``hnsw_search_batch`` is not ported yet; level 0 runs in the beam
search kernel (``ops.beam_search``).
"""

from __future__ import annotations

import torch

INF = float("inf")


def hnsw_descend_entries(
    vectors: torch.Tensor,   # (N, D)
    nbru: torch.Tensor,      # (L, N, m) int32, -1 padded
    entry: int,
    queries: torch.Tensor,   # (Q, D)
) -> torch.Tensor:
    """Greedy best-neighbour descent from ``entry`` through levels L-1..0 of
    ``nbru``; returns the (Q,) int32 level-0 entry points.

    Batched over queries: each query moves to its best neighbour while that is
    strictly closer (squared L2), exactly as the per-query JAX while-loop; a
    query that stops improving keeps its point, so running the batch until no
    query improves gives the same points."""
    q = queries.float()
    Q = q.shape[0]

    def dist_to(ids: torch.Tensor) -> torch.Tensor:   # ids (Q, m)
        v = vectors[ids.clamp(min=0).long()].float()   # (Q, m, D)
        d = ((v - q[:, None, :]) ** 2).sum(-1)
        return torch.where(ids >= 0, d, torch.full_like(d, INF))

    point = torch.full((Q,), int(entry), dtype=torch.long, device=q.device)
    pd = dist_to(point[:, None])[:, 0]
    for level in range(nbru.shape[0] - 1, -1, -1):
        nbrs = nbru[level]
        while True:
            cand = nbrs[point].long()                   # (Q, m)
            d = dist_to(cand)
            bd, best = d.min(dim=1)
            take = bd < pd
            if not bool(take.any()):
                break
            point = torch.where(take, cand.gather(1, best[:, None])[:, 0], point)
            pd = torch.where(take, bd, pd)
    return point.to(torch.int32)
