"""The ``matching_*`` matcher family behind the CLIs.

Port of part of ``image_search_engine_for_historical_research_tpu/index/matchers.py``
(:35-60, :119-124, :178-189, :242-255): the same inputs and outputs,
``(idx (num_test, K) int64, seconds per query)``, and the same
``ifgenerate`` build-or-load artifact contract. Input features are
row-L2-normalized inside each matcher. The clock covers the search only,
never the build, and ends once the ids are on the host; ``warmup=True`` runs
one query first so that a first call's set-up is not timed.

Ported: ``L2`` (exact, ``FlatIndex``) and ``HNSW`` (native host build, search
in the kernel). Every other method in ``MATCHERS`` exits naming the ROADMAP
item that ports it (``NOT_PORTED``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..device import resolve_device
from .base import load_index, normalize_rows, save_index
from .flat import build_flat
from .hnsw import build_hnsw

# matching method -> the ROADMAP item that ports it
NOT_PORTED = {
    "L2_int8": "the remaining matchers",
    "fractional": "the remaining matchers",
    "LSH": "the remaining matchers",
    "ANNOY": "the remaining matchers",
    "Greedyhash": "the remaining matchers",
    "PQ": "the PQ family",
    "Nano_PQ": "the PQ family",
    "PQ_HNSW": "the PQ family",
    "HNSW_NanoPQ": "the PQ family",
    "IVFPQ": "the PQ family",
    "PQ_Net": "the PQ family",
}


def _as_rows(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def _timed_search(index, qvecs, K, warmup=True):
    if warmup:
        index.search(qvecs[:1], min(K, index.n))
    t1 = time.perf_counter()
    _, idx = index.search(qvecs, K)
    idx = idx.cpu().numpy().astype(np.int64)
    t2 = time.perf_counter()
    return idx, (t2 - t1) / qvecs.shape[0]


def _artifact(dataset: str, name: str, outputs: str = "outputs") -> str:
    d = os.path.join(outputs, dataset)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def _build_or_load(path, ifgenerate, builder, device):
    if ifgenerate or not os.path.exists(os.path.join(path, "manifest.json")):
        index = builder()
        save_index(index, path)
        return index
    return load_index(path, device=device)


def matching_L2(K, train, test, warmup=True, device="cuda"):
    """Exact search over a ``FlatIndex`` of ``train``."""
    db = normalize_rows(_as_rows(train, device))
    q = normalize_rows(_as_rows(test, device))
    index = build_flat(db, metric="cosine", device=device)
    return _timed_search(index, q, min(K, index.n), warmup)


def matching_HNSW(K, train, test, dataset, m=16, ef=100, ifgenerate=True, outputs="outputs",
                  warmup=True, device="cuda"):
    """HNSW matcher (``<outputs>/<dataset>/hnsw``; the reference's offline
    parameters m=16, ef=100)."""
    q = normalize_rows(_as_rows(test, device))
    path = _artifact(dataset, "hnsw", outputs)
    index = _build_or_load(
        path, ifgenerate,
        lambda: build_hnsw(np.asarray(train, np.float32), m=m, ef_construction=ef,
                           device=device),
        device,
    )
    return _timed_search(index, q, min(K, index.n), warmup)


def _not_ported(method: str) -> Callable:
    def matcher(*args, **kwargs):
        raise SystemExit(not_ported_message(method))

    return matcher


def not_ported_message(method: str) -> str:
    return (f"--matching-method {method} is not ported yet: see ROADMAP, "
            f"{NOT_PORTED[method]}. The port has --matching-method L2 and HNSW.")


# method-name dispatch used by the CLIs
MATCHERS: Dict[str, Callable] = {
    "L2": matching_L2,
    "HNSW": matching_HNSW,
    **{method: _not_ported(method) for method in NOT_PORTED},
}
