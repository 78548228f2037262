"""Soft product quantization: differentiable codebooks for deep-PQ training,
and the flat codeword layout of the reference's PQ matchers.

Port of ``image_search_engine_for_historical_research_tpu/ops/softpq.py``:
per-subspace softmax assignment over learnable codewords with an inverse
temperature ``tau`` (``soft_quantize``), whose hard path is ``ops.pq``'s
nearest codeword; the distortion + usage-entropy loss (``softpq_loss``); and
``codewords_flat`` / ``codewords_from_flat``, the ``(Ks, M * ds)`` layout
that ``matching_PQ_Net`` and ``matching_PQ_Net_bucket`` take and its inverse,
the ``(M, Ks, ds)`` codebook.

``init_softpq`` draws its normal codewords on the host through the seam
``_normal_draw(shape, seed)`` (JAX draws from a ``PRNGKey``, which the port
cannot reproduce); tests route the seam through JAX's draw.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SoftPQState(NamedTuple):
    codewords: torch.Tensor  # (M, Ks, ds), learnable


def _normal_draw(shape, seed: int) -> np.ndarray:
    """Standard normal f32 draws for ``init_softpq`` (the seam)."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def init_softpq(dim: int, M: int = 16, Ks: int = 256, seed: int = 0,
                device="cpu") -> SoftPQState:
    """Codewords ``N(0, 1) / sqrt(ds)``, ``ds = dim // M``, as a leaf tensor
    that requires grad."""
    ds = dim // M
    cw = torch.as_tensor(_normal_draw((M, Ks, ds), seed), device=device) * ds ** -0.5
    return SoftPQState(codewords=cw.requires_grad_(True))


def soft_quantize(state: SoftPQState, x: torch.Tensor,
                  tau: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable quantization of ``x`` (N, D): the quantized ``(N, D)``,
    the soft assignment ``(N, M, Ks)`` (softmax of ``-tau`` times the squared
    distances) and the hard codes ``(N, M)``."""
    N, D = x.shape
    M, Ks, ds = state.codewords.shape
    xs = x.reshape(N, M, ds)
    dots = torch.einsum("nmd,mkd->nmk", xs, state.codewords)
    c2 = torch.sum(state.codewords ** 2, dim=2)
    x2 = torch.sum(xs ** 2, dim=2)
    d2 = x2[:, :, None] - 2.0 * dots + c2[None, :, :]               # (N, M, Ks)
    soft = torch.softmax(-tau * d2, dim=-1)
    q = torch.einsum("nmk,mkd->nmd", soft, state.codewords).reshape(N, D)
    hard = torch.argmin(d2, dim=-1)
    return q, soft, hard


def softpq_loss(state: SoftPQState, x: torch.Tensor, tau: float = 5.0) -> torch.Tensor:
    """Quantization distortion minus 1e-3 times the mean codeword-usage
    entropy."""
    q, soft, _ = soft_quantize(state, x, tau)
    distortion = torch.mean(torch.sum((x - q) ** 2, dim=1))
    usage = torch.mean(soft, dim=0)                                  # (M, Ks)
    entropy = -torch.sum(usage * torch.log(usage + 1e-12), dim=-1).mean()
    return distortion - 1e-3 * entropy


def codewords_flat(codewords: torch.Tensor) -> torch.Tensor:
    """``(M, Ks, ds)`` codewords (or a state holding them as ``.codewords``)
    -> the ``(Ks, M * ds)`` flat layout."""
    cw = getattr(codewords, "codewords", codewords)
    M, Ks, ds = cw.shape
    return cw.permute(1, 0, 2).reshape(Ks, M * ds)


def codewords_from_flat(flat: torch.Tensor, M: int) -> torch.Tensor:
    """Inverse of ``codewords_flat``: ``(Ks, M * ds)`` -> ``(M, Ks, ds)``."""
    Ks, D = flat.shape
    return flat.reshape(Ks, M, D // M).permute(1, 0, 2).contiguous()
