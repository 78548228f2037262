"""Query-expansion re-ranking: alphaQE feature enhancement, serving qge1,
AQE and DBA.

Port of ``image_search_engine_for_historical_research_tpu/rerank/qe.py``
(all of it): ``feature_enhancement``, ``qge1`` and ``_qge1_topk``,
``average_query_expansion`` and ``database_augmentation``. Row-major
``qvecs (Q, D)``, ``vecs (N, D)``, ``ranks (Q, >=k)``. Top-k selections put
the lower id first among equal scores, as ``lax.top_k`` (``ops.topk._top``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.normalization import l2n
from ..ops.topk import _matmul_f32, _top, exact_scores, exact_topk
from ..utils import tracing


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
    the top-``out_k`` re-ranked ids instead of the full permutation. The
    device span ``rerank.qge1``."""
    with tracing.span("rerank.qge1", device=vecs.device):
        if out_k is None:
            _, r = feature_enhancement(qvecs, vecs, ranks, k=k, w=w, iterations=1)
            return r
        return _qge1_topk(ranks, qvecs, vecs, k, w, out_k)


def _qge1_topk(ranks, qvecs, vecs, k: int, w: float, out_k: int) -> torch.Tensor:
    """The expanded queries' top-``out_k`` by ``exact_topk``, which scans an
    f32 gallery on the card with the ``scan_topk`` kernel."""
    return exact_topk(_enhance(ranks, vecs, k, w), vecs, out_k, metric="ip")[1]


def _centered_normalized(a: torch.Tensor, b: torch.Tensor):
    """Shared centering of queries and gallery, then row L2 norm (no eps)."""
    center = torch.cat([a, b]).mean(dim=0)
    return l2n(a - center, eps=0.0), l2n(b - center, eps=0.0)


def average_query_expansion(qvecs: torch.Tensor, vecs: torch.Tensor, top_k: int = 3):
    """Classic AQE: queries and gallery centered and normalized, each vector
    concatenated with the mean of its top-``top_k`` gallery vectors (a
    gallery row skips itself). Returns the augmented (qvecs', vecs'), to be
    searched with the flat index."""
    qc, vc = _centered_normalized(qvecs, vecs)
    top_q = _top(_matmul_f32(qc, vc), top_k)[1]
    q_aug = torch.cat([qc, vc[top_q].mean(dim=1)], dim=1)
    top_g = _top(_matmul_f32(vc, vc), top_k + 1)[1][:, 1:]       # skip self
    v_aug = torch.cat([vc, vc[top_g].mean(dim=1)], dim=1)
    return q_aug, v_aug


def database_augmentation(qvecs: torch.Tensor, vecs: torch.Tensor, top_k: int = 3):
    """Weighted DBA: ``logspace(0, -2, top_k + 1)`` weights over [self, the
    top-``top_k`` gallery neighbours] on both sides. Returns (qvecs', vecs')."""
    weights = torch.logspace(0, -2.0, top_k + 1, device=vecs.device)
    qc, vc = _centered_normalized(qvecs, vecs)
    top_q = _top(_matmul_f32(qc, vc), top_k)[1]
    stack_q = torch.cat([qc[:, None, :], vc[top_q]], dim=1)       # (Q, k+1, D)
    q_new = torch.tensordot(weights, stack_q, dims=([0], [1]))
    top_g = _top(_matmul_f32(vc, vc), top_k + 1)[1]              # (N, k+1) with self
    v_new = torch.tensordot(weights, vc[top_g], dims=([0], [1]))
    return q_new, v_new
