"""Database-sharded exact top-k: a top-k over each rank's shard, then an
all-gather merge.

Port of ``image_search_engine_for_historical_research_tpu/parallel/topk.py``
(:20-87). Each rank scans its own row block with ``ops.topk.exact_topk``
(``min(k, shard_rows)`` candidates, ids offset by ``rank * shard_rows``),
``dist.all_gather`` collects every rank's scores and ids, and one
``ops.topk._top_exact`` over the shard-major concatenation merges them: the
wire carries ``world * k`` candidates a query, never the scores. As with
``lax.top_k`` in the JAX merge, among tied scores the lowest global id wins.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.topk import _top_exact, exact_topk
from .mesh import full_rows, gather_rows, local_rows


def sharded_exact_topk(
    queries: torch.Tensor,
    db,
    k: int,
    mesh,
    *,
    metric: str = "ip",
    chunk: int = 262144,
    matmul_dtype: Optional[torch.dtype] = None,
    axis: str = "data",
    approximate: bool = False,
):
    """Top-``k`` ``(scores (Q, k) f32, ids (Q, k) int64)`` of ``queries``
    (replicated: a plain tensor or a ``replicate`` result) against ``db
    (N, D)`` row-sharded over ``axis`` (a full tensor or a ``shard_batch``
    result; ``ValueError`` when N does not divide the mesh). Every rank
    returns the same result. ``approximate`` is exact, as in
    ``exact_topk``."""
    shard, N = local_rows(db, mesh, axis)
    shard_rows = shard.shape[0]
    s, i = exact_topk(full_rows(queries), shard, min(k, shard_rows), metric=metric,
                      chunk=chunk, matmul_dtype=matmul_dtype, approximate=approximate)
    i = i + mesh.get_local_rank(axis) * shard_rows
    s_cat = gather_rows(s, mesh, axis, dim=1)       # (Q, world * k_local), shard-major
    i_cat = gather_rows(i, mesh, axis, dim=1)
    top_s, sel = _top_exact(s_cat, min(k, N))
    return top_s, i_cat.gather(1, sel)
