"""Seeded weights in a module's own checkpoint layout, drawn on the device
in one call: one normal draw for the whole state dict, cut into its
entries, each shaped by a rule of its model family."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from .seeds import generator


def template(module_factory: Callable[[], torch.nn.Module]) -> Dict[str, torch.Size]:
    """Entry names and shapes of the module's ``state_dict``, built on the
    meta device (no memory, no draws)."""
    with torch.device("meta"):
        m = module_factory()
    return {k: v.shape for k, v in m.state_dict().items()}


def seeded_state_dict(shapes: Dict[str, torch.Size], rule, seed: int, tag: str,
                      device) -> Dict[str, torch.Tensor]:
    """``rule(name, z)`` turns a standard-normal block ``z`` of the entry's
    shape into the entry."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=generator(seed, tag, device), device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = rule(name, z[off:off + n].view(shape)).contiguous()
        off += n
    return out


def he(z: torch.Tensor, gain: float = 2.0) -> torch.Tensor:
    """N(0, gain / fan_in) for a conv or linear weight."""
    return z * math.sqrt(gain / z[0].numel())
