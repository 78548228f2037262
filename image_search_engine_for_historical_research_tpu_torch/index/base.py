"""Index registry and the pickle-free artifact store.

Port of ``image_search_engine_for_historical_research_tpu/index/base.py``
(:24-75): every index is a dataclass of plain arrays, saved as
``manifest.json`` + ``arrays.npz`` in the same format, so both packages load
each other's artifacts. ``load_index`` places the arrays on ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Type

import numpy as np
import torch

from ..device import resolve_device

_REGISTRY: Dict[str, Type] = {}

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
FORMAT_VERSION = 1


def register(kind: str):
    """Class decorator: register an index type for load-by-manifest."""

    def deco(cls):
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls

    return deco


def save_index(index, path: str) -> None:
    """Write manifest + arrays. ``index`` must expose ``to_arrays() -> (meta, arrays)``."""
    os.makedirs(path, exist_ok=True)
    meta, arrays = index.to_arrays()
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": index.kind,
        "meta": meta,
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    np.savez(os.path.join(path, ARRAYS), **{k: np.asarray(v) for k, v in arrays.items()})


def load_index(path: str, device="cuda"):
    """Load any registered index type from its artifact directory onto ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"artifact from a newer format: {manifest}")
    kind = manifest["kind"]
    if kind not in _REGISTRY:
        raise ValueError(
            f"index kind {kind!r} is not ported yet (have {sorted(_REGISTRY)})"
        )
    with np.load(os.path.join(path, ARRAYS)) as z:
        arrays = dict(z)
    return _REGISTRY[kind].from_arrays(manifest["meta"], arrays, device=dev)


def normalize_rows(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Row L2 normalization (``x / ||x||``, or ``x / (||x|| + eps)``)."""
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / (n + eps) if eps else x / n.clamp(min=1e-30)
