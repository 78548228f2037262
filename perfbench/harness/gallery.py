"""Seeded galleries and queries: unit rows near a low-dimensional
subspace, made on the device (the recipe of the JAX package's
``scripts/synth_data.py``, as the port's ``chip_smoke.py`` copies it).

Centres lie on the ``d_eff``-sphere, each row is a centre plus ``spread``
noise, embedded by one random ``(d_eff, d)`` map and normalized: isotropic
noise in 2048 dimensions would make every row nearly orthogonal to every
other, and a top-k over it would rank noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .seeds import generator


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-30)


@dataclass
class Basis:
    centers: torch.Tensor     # (n_centers, d_eff) unit rows
    embed: torch.Tensor       # (d_eff, d)


def basis(seed: int, n_centers: int, d_eff: int, d: int, device) -> Basis:
    g = generator(seed, "gallery.basis", device)
    centers = _unit(torch.randn(n_centers, d_eff, generator=g, device=device))
    embed = torch.randn(d_eff, d, generator=g, device=device) / d ** 0.5
    return Basis(centers, embed)


def rows(seed: int, tag: str, n: int, b: Basis, spread: float, device,
         chunk: int = 131072) -> torch.Tensor:
    """``(n, d)`` f32 unit rows: random centres of ``b`` plus ``spread``
    noise, embedded and normalized, drawn in ``chunk``-row calls."""
    g = generator(seed, tag, device)
    n_centers, d_eff = b.centers.shape
    out = torch.empty((n, b.embed.shape[1]), dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        a = torch.randint(0, n_centers, (c,), generator=g, device=device)
        z = b.centers[a] + spread * torch.randn(c, d_eff, generator=g, device=device)
        out[s:s + c] = _unit(z @ b.embed)
    return out


def make_gallery(seed: int, gcfg: dict, device) -> torch.Tensor:
    """The configuration's gallery: ``gcfg`` holds ``rows``, ``dim``,
    ``n_centers``, ``d_eff`` and ``spread``."""
    b = basis(seed, gcfg["n_centers"], gcfg["d_eff"], gcfg["dim"], device)
    return rows(seed, "gallery.rows", gcfg["rows"], b, gcfg["spread"], device)


def make_queries(seed: int, gcfg: dict, n: int, spread: float, device) -> torch.Tensor:
    """``n`` query rows near the gallery's clusters (the same basis)."""
    b = basis(seed, gcfg["n_centers"], gcfg["d_eff"], gcfg["dim"], device)
    return rows(seed, "gallery.queries", n, b, spread, device)
