"""Metric-learning losses over retrieval tuples.

Port of ``image_search_engine_for_historical_research_tpu/ops/losses.py``:
contrastive, triplet and second-order similarity (SOS), the reference's
``layers/functional.py:140-186``.

A batch holds ``nq`` tuples of ``S`` images each, laid out contiguously as
``[query, positive, neg_1 .. neg_{S-2}]``: descriptors ``x`` are row-major
``(nq * S, D)`` and labels ``(nq * S,)`` are ``-1`` (query), ``1``
(positive) or ``0`` (negative). The losses reshape to ``(nq, S, D)`` and
index nothing by value. The sums and divisions are the reference's: the
contrastive loss is summed, not averaged, and its ``eps`` sits inside the
difference.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _split_tuples(x: torch.Tensor, label: torch.Tensor, S=None):
    """``(nq * S, D)`` -> ``(nq, S, D)`` and labels ``(nq, S)``. Without
    ``S`` it is read from the labels (the number of queries)."""
    if S is None:
        nq = int((label == -1).sum())
        S = x.shape[0] // nq
    nq = x.shape[0] // S
    return x.reshape(nq, S, x.shape[-1]), label.reshape(nq, S), nq, S


def contrastive_loss(x: torch.Tensor, label: torch.Tensor, margin: float = 0.7,
                     eps: float = EPS, S=None) -> torch.Tensor:
    """``sum 0.5 y d^2 + 0.5 (1 - y) max(margin - d, 0)^2`` over every
    (query, other) pair, ``d = ||q - o + eps||``."""
    xt, lt, nq, S = _split_tuples(x, label, S)
    q = xt[:, :1, :]
    others = xt[:, 1:, :]
    lbl = lt[:, 1:].to(x.dtype)
    d = torch.sqrt(torch.sum((q - others + eps) ** 2, dim=-1))      # (nq, S-1)
    y = 0.5 * lbl * d ** 2 + 0.5 * (1.0 - lbl) * torch.clamp(margin - d, min=0.0) ** 2
    return torch.sum(y)


def triplet_loss(x: torch.Tensor, label: torch.Tensor, margin: float = 0.1,
                 S=None) -> torch.Tensor:
    """``sum max(d(a, p)^2 - d(a, n)^2 + margin, 0) / nq`` over each tuple's
    negatives."""
    xt, lt, nq, S = _split_tuples(x, label, S)
    xa, xp, xn = xt[:, :1, :], xt[:, 1:2, :], xt[:, 2:, :]
    dist_pos = torch.sum((xa - xp) ** 2, dim=-1)                     # (nq, 1)
    dist_neg = torch.sum((xa - xn) ** 2, dim=-1)                     # (nq, S-2)
    return torch.sum(torch.clamp(dist_pos - dist_neg + margin, min=0.0)) / nq


def sos_loss(x: torch.Tensor, label: torch.Tensor, S=None) -> torch.Tensor:
    """``sqrt(sum_n (d(a, n)^2 - d(p, n)^2)^2) / nq`` over all negatives of
    all tuples."""
    xt, lt, nq, S = _split_tuples(x, label, S)
    xa, xp, xn = xt[:, :1, :], xt[:, 1:2, :], xt[:, 2:, :]
    dist_an = torch.sum((xa - xn) ** 2, dim=-1)
    dist_pn = torch.sum((xp - xn) ** 2, dim=-1)
    return torch.sqrt(torch.sum((dist_an - dist_pn) ** 2)) / nq
