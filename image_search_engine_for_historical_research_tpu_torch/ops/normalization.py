"""Descriptor normalization.

Port of ``image_search_engine_for_historical_research_tpu/ops/normalization.py``
(``l2n``, :17-24). Operates on the last axis, like the JAX version.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def l2n(x: torch.Tensor, eps: float = EPS, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim``: ``x / (||x|| + eps)``; ``eps=0`` divides by
    the exact norm (the multi-scale descriptor's final step)."""
    return x / (torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True) + eps)
