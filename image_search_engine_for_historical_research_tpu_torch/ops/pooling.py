"""Global-descriptor pooling over CNN feature maps: MAC, SPoC, GeM, R-MAC and
regional pooling.

Port of ``image_search_engine_for_historical_research_tpu/ops/pooling.py``
(:31-157). Feature maps are NHWC ``(B, H, W, C)`` and the optional validity mask
is ``(B, H, W)`` bool, as in the JAX package; every pooler returns ``(B, C)``,
``roipool`` ``(B, R, C)``. The R-MAC region grid (``_rmac_grid``) is host
arithmetic on the map's static height and width, and assumes full-extent
(unmasked) maps.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from .normalization import l2n

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


def _rmac_grid(H: int, W: int, L: int) -> List[Tuple[int, int, int]]:
    """The R-MAC region grid: ``(row, col, side)`` squares of side
    ``floor(2 min(H, W) / (l + 1))`` for levels ``l = 1..L``, spread with
    about 40% overlap; the long side gets ``idx + 1`` extra regions, ``idx``
    picking the region count in 2..7 whose overlap is closest to 0.4."""
    ovr = 0.4
    steps = [2, 3, 4, 5, 6, 7]
    w = min(W, H)
    idx = min(range(len(steps)),
              key=lambda i: abs((w ** 2 - w * ((max(H, W) - w) / (steps[i] - 1))) / w ** 2
                                - ovr))
    Wd = idx + 1 if H < W else 0
    Hd = idx + 1 if H > W else 0

    regions: List[Tuple[int, int, int]] = []
    for l in range(1, L + 1):
        wl = math.floor(2 * w / (l + 1))
        if wl == 0:
            continue
        wl2 = math.floor(wl / 2 - 1)
        b = 0 if l + Wd == 1 else (W - wl) / (l + Wd - 1)
        cen_w = [math.floor(wl2 + i * b) - wl2 for i in range(l - 1 + Wd + 1)]
        b = 0 if l + Hd == 1 else (H - wl) / (l + Hd - 1)
        cen_h = [math.floor(wl2 + i * b) - wl2 for i in range(l - 1 + Hd + 1)]
        for i_ in cen_h:
            for j_ in cen_w:
                regions.append((int(i_), int(j_), wl))
    return regions


def rmac(x: torch.Tensor, L: int = 3, eps: float = EPS) -> torch.Tensor:
    """Regional MAC: the full map's L2-normalized MAC plus the sum of every
    grid region's. Returns ``(B, C)``."""
    v = l2n(mac(x), eps)
    for i, j, wl in _rmac_grid(x.shape[1], x.shape[2], L):
        v = v + l2n(mac(x[:, i:i + wl, j:j + wl, :]), eps)
    return v


def roipool(x: torch.Tensor, rpool: Callable[[torch.Tensor], torch.Tensor], L: int = 3,
            eps: float = EPS) -> torch.Tensor:
    """``rpool`` over the whole map and every grid region, stacked: ``(B, R,
    C)`` with region 0 the full map (the input of the regional head)."""
    vecs = [rpool(x)]
    for i, j, wl in _rmac_grid(x.shape[1], x.shape[2], L):
        vecs.append(rpool(x[:, i:i + wl, j:j + wl, :]))
    return torch.stack(vecs, dim=1)
