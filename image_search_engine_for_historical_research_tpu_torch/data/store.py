"""Feature store: the offline -> online descriptor handoff.

The port's own copy of part of
``image_search_engine_for_historical_research_tpu/data/store.py`` (:22-70):
``<root>/features/<dataset>_path_feature.npz`` holding ``paths`` and
row-major f32 ``features``, so both packages read each other's stores. The
reference's legacy pickle stores and the sharded store are not ported.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def _safe_name(dataset: str) -> str:
    return dataset.replace("/", "_")


def feature_path(root: str, dataset: str) -> str:
    return os.path.join(root, "features", f"{_safe_name(dataset)}_path_feature.npz")


def save_path_feature(
    dataset: str,
    vecs: np.ndarray,
    img_r_path: Sequence[str],
    root: str = "outputs",
) -> str:
    """Persist (paths, row-major features). Returns the file path."""
    vecs = np.asarray(vecs)
    if vecs.ndim != 2:
        raise ValueError("features must be 2-D (num_images, dim)")
    os.makedirs(os.path.join(root, "features"), exist_ok=True)
    path = feature_path(root, dataset)
    np.savez(
        path,
        paths=np.asarray(list(img_r_path), dtype=np.str_),
        features=vecs.astype(np.float32),
    )
    return path


def load_path_features(dataset: str, root: str = "outputs") -> Tuple[np.ndarray, List[str]]:
    """Load ``(features (N, D), paths)``."""
    path = feature_path(root, dataset)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no feature store for {dataset!r} under {root}")
    z = np.load(path, allow_pickle=False)
    return z["features"], [str(p) for p in z["paths"]]
