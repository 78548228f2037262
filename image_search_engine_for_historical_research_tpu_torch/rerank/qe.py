"""Query-expansion re-ranking: alphaQE feature enhancement and serving qge1.

Port of ``feature_enhancement``, ``qge1`` and ``_qge1_topk`` in
``image_search_engine_for_historical_research_tpu/rerank/qe.py`` (:25-71).
Row-major ``qvecs (Q, D)``, ``vecs (N, D)``, ``ranks (Q, >=k)``. AQE and DBA
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.normalization import l2n
from ..ops.topk import exact_scores


def _rank_weights(k: int, w: float, device) -> torch.Tensor:
    """``((k - r) / k)^w`` for r = 0..k-1, shaped (1, k, 1)."""
    r = torch.arange(k, 0, -1, device=device, dtype=torch.float32)
    return ((r / k) ** w)[None, :, None]


def _enhance(ranks: torch.Tensor, vecs: torch.Tensor, k: int, w: float) -> torch.Tensor:
    top = vecs[ranks[:, :k].long()]                       # (Q, k, D)
    return l2n((top * _rank_weights(k, w, vecs.device)).sum(dim=1))


def feature_enhancement(
    qvecs: torch.Tensor,
    vecs: torch.Tensor,
    ranks: torch.Tensor,
    k: int = 10,
    w: float = 4.0,
    iterations: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """alphaQE-style enhancement: each iteration replaces the queries by the
    weighted, normalized sum of their top-``k`` gallery vectors and re-ranks
    the whole gallery. Returns (enhanced queries, full ranks (Q, N))."""
    q, r = qvecs, ranks
    for _ in range(iterations):
        q = _enhance(r, vecs, k, w)
        r = torch.argsort(-exact_scores(q, vecs), dim=1, stable=True)
    return q, r


def qge1(ranks, qvecs, vecs, k: int = 3, w: float = 4.0, out_k: Optional[int] = None):
    """One enhancement iteration (the serving path). ``out_k`` returns only
    the top-``out_k`` re-ranked ids instead of the full permutation."""
    if out_k is None:
        _, r = feature_enhancement(qvecs, vecs, ranks, k=k, w=w, iterations=1)
        return r
    return _qge1_topk(ranks, qvecs, vecs, k, w, out_k)


def _qge1_topk(ranks, qvecs, vecs, k: int, w: float, out_k: int) -> torch.Tensor:
    scores = exact_scores(_enhance(ranks, vecs, k, w), vecs)
    return torch.topk(scores, out_k, dim=1).indices
