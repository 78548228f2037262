"""Feature store: the offline -> online descriptor handoff.

The port's own copy of
``image_search_engine_for_historical_research_tpu/data/store.py`` (:22-70,
:82-190): ``<root>/features/<dataset>_path_feature.npz`` holding ``paths`` and
row-major f32 ``features``, and the sharded store
``<root>/features/<dataset>_shards/shard_<start:012d>_<count:08d>.npz`` with
the same keys, so both packages read each other's stores. Where only the
reference's pickle store ``<dataset>_path_feature.pkl`` (``path`` and a D x N
``feature`` array) exists, ``load_path_features`` reads that instead.
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
from typing import Callable, List, Sequence, Tuple

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
    """Load ``(features (N, D), paths)``. Falls back to the reference's
    pickle store when only that file exists, transposing its D x N layout
    (told by the path count) and returning f32."""
    path = feature_path(root, dataset)
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        return z["features"], [str(p) for p in z["paths"]]
    legacy = os.path.join(root, "features", f"{_safe_name(dataset)}_path_feature.pkl")
    if os.path.exists(legacy):
        with open(legacy, "rb") as f:
            d = pickle.load(f)
        vecs = np.asarray(d["feature"])
        paths = list(d["path"])
        if vecs.ndim == 2 and vecs.shape[0] != len(paths) and vecs.shape[1] == len(paths):
            vecs = vecs.T
        return vecs.astype(np.float32), paths
    raise FileNotFoundError(f"no feature store for {dataset!r} under {root}")


# ---------------------------------------------------------------------------
# Sharded store: the handoff beyond host RAM. Each shard holds a contiguous
# block of rows, written atomically, so extraction resumes past the last
# complete shard (``cli.extract_1m --shard-size``) and the streaming index
# builders (``index.build_pq`` / ``build_ivfpq`` / ``build_hnsw_pq`` with a
# callable and ``n=``) read one shard at a time.
# ---------------------------------------------------------------------------

_SHARD_RE = re.compile(r"shard_(\d{12})_(\d{8})\.npz$")


def shards_dir(root: str, dataset: str) -> str:
    return os.path.join(root, "features", f"{_safe_name(dataset)}_shards")


def save_feature_shard(
    dataset: str,
    start: int,
    vecs: np.ndarray,
    img_r_path: Sequence[str],
    root: str = "outputs",
) -> str:
    """Persist rows ``[start, start + len(vecs))`` as one shard file. The
    write goes to a temporary name and is renamed, so a crash never leaves a
    truncated shard that resume would count as complete."""
    vecs = np.asarray(vecs, np.float32)
    if vecs.ndim != 2:
        raise ValueError("features must be 2-D (num_images, dim)")
    if len(img_r_path) != vecs.shape[0]:
        raise ValueError("one path per feature row required")
    d = shards_dir(root, dataset)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"shard_{start:012d}_{vecs.shape[0]:08d}.npz")
    tmp = path + ".tmp"
    np.savez(tmp, paths=np.asarray(list(img_r_path), dtype=np.str_), features=vecs)
    # np.savez appends .npz to a name without it
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)
    return path


def _list_shards(dataset: str, root: str) -> List[Tuple[int, int, str]]:
    """The contiguous-from-0 prefix of ``(start, count, path)``, by start."""
    d = shards_dir(root, dataset)
    if not os.path.isdir(d):
        return []
    found = []
    for f in sorted(os.listdir(d)):
        m = _SHARD_RE.match(f)
        if m:
            found.append((int(m.group(1)), int(m.group(2)), os.path.join(d, f)))
    out, expect = [], 0
    for start, count, p in found:
        if start < expect:
            # a leftover of an older --shard-size grid whose rows the prefix
            # already covers: skip it (stopping here would pin the resume
            # point on it for ever)
            warnings.warn(
                f"ignoring stale overlapping feature shard {p} "
                f"(covers rows {start}..{start + count}, prefix already "
                f"at {expect}); delete it to silence this warning"
            )
            continue
        if start > expect:
            break                       # a hole: nothing after it is usable
        out.append((start, count, p))
        expect = start + count
    return out


def shard_resume_point(dataset: str, root: str = "outputs") -> int:
    """The first row not covered by the contiguous prefix of complete shards."""
    shards = _list_shards(dataset, root)
    return shards[-1][0] + shards[-1][1] if shards else 0


def chunked_feature_source(dataset: str, root: str = "outputs") -> Tuple[Callable, int]:
    """``(chunks_fn, n)`` for the streaming index builders: ``chunks_fn()``
    yields each shard's ``(c, D)`` f32 block, one shard in memory at a time,
    and may be called again for every pass::

        chunks_fn, n = chunked_feature_source("revisitop1m")
        ix = index.build_hnsw_pq(chunks_fn, n=n, opq="refine")
    """
    shards = _list_shards(dataset, root)
    if not shards:
        raise FileNotFoundError(
            f"no feature shards for {dataset!r} under {root} "
            f"(expected {shards_dir(root, dataset)}/shard_*.npz)"
        )
    n = shards[-1][0] + shards[-1][1]

    def chunks_fn():
        for _, _, p in shards:
            yield np.load(p, allow_pickle=False)["features"]

    return chunks_fn, n


def chunked_feature_relpaths(dataset: str, root: str = "outputs") -> List[str]:
    """Every image's relative path across the shard prefix, in row order."""
    out: List[str] = []
    for _, _, p in _list_shards(dataset, root):
        out.extend(str(s) for s in np.load(p, allow_pickle=False)["paths"])
    return out
