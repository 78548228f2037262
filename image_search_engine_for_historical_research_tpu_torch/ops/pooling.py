"""Global-descriptor pooling over CNN feature maps: MAC, SPoC, GeM.

Port of ``image_search_engine_for_historical_research_tpu/ops/pooling.py``
(:31-79). Feature maps are NHWC ``(B, H, W, C)`` and the optional validity mask
is ``(B, H, W)`` bool, as in the JAX package; every function returns ``(B, C)``.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, 1) float mask in x.dtype."""
    return mask.to(x.dtype)[..., None]


def mac(x: torch.Tensor, mask=None) -> torch.Tensor:
    """Maximum activation of convolutions; ``mask`` restricts the max to valid
    positions."""
    if mask is None:
        return x.amax(dim=(1, 2))
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    return torch.where(mask[..., None], x, neg).amax(dim=(1, 2))


def spoc(x: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean pooling (sum-pooling of convolutions) over valid positions."""
    if mask is None:
        return x.mean(dim=(1, 2))
    m = _expand_mask(mask, x)
    return (x * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)


def gem(x: torch.Tensor, p=3.0, eps: float = EPS, mask=None) -> torch.Tensor:
    """Generalized-mean pooling ``avg(clamp(x, eps)^p)^(1/p)``.

    ``p`` is a scalar (GeM) or a ``(C,)`` tensor (per-channel GeMmp). With a
    ``mask`` the average runs over valid positions only, and a fully-masked
    row is floored at ``eps^p`` so it gives ``eps``, like an unmasked all-zero
    channel."""
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    powered = x.clamp(min=eps).pow(p)
    if mask is None:
        pooled = powered.mean(dim=(1, 2))
    else:
        m = _expand_mask(mask, x)
        pooled = (powered * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)
        floor = torch.as_tensor(eps, dtype=x.dtype, device=x.device).pow(p)
        pooled = torch.maximum(pooled, floor)
    return pooled.pow(1.0 / p)
