"""Dense query-gallery scores.

Port of ``exact_scores`` in
``image_search_engine_for_historical_research_tpu/ops/topk.py`` (:193-210), for
the inner-product metric the re-rankers use: a plain matrix product, left to
cuBLAS on the card as the JAX package left it to XLA. ``exact_topk`` and the
rest of that module are not ported yet.
"""

from __future__ import annotations

import torch


def exact_scores(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Full ``(Q, N)`` inner-product score matrix, f32."""
    return torch.matmul(queries, db.T).float()
