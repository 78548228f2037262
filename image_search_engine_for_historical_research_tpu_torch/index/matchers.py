"""The ``matching_*`` matcher family behind the CLIs.

Port of part of ``image_search_engine_for_historical_research_tpu/index/matchers.py``
(:35-60, :119-238, :242-255): the same inputs and outputs,
``(idx (num_test, K) int64, seconds per query)``, and the same
``ifgenerate`` build-or-load artifact contract. Input features are
row-L2-normalized inside each matcher. The clock covers the search only,
never the build, and ends once the ids are on the host; ``warmup=True`` runs
one query first so that a first call's set-up is not timed.

Ported: ``L2`` (exact, ``FlatIndex``), ``HNSW`` (native host build, search
in the kernel) and the PQ family: ``PQ`` / ``Nano_PQ`` (``build_pq``),
``PQ_HNSW`` / ``HNSW_NanoPQ`` (``build_hnsw_pq``) and ``IVFPQ``
(``build_ivfpq``), with the defaults of the reference's scripts. Every other method
in ``MATCHERS`` exits naming the ROADMAP item that ports it (``NOT_PORTED``).

One departure from the JAX package: its ``cli.offline`` passes
``refine_M=`` to ``matching_HNSW_NanoPQ``, whose signature has no such
parameter, so ``--matching-method HNSW_NanoPQ --refine-m N`` raises a
``TypeError`` there. Here the matcher takes ``refine_M`` (``None``: the
builder's default of 32), as the flag's help text promises.
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
from .hnsw import build_hnsw, build_hnsw_pq
from .ivfpq import build_ivfpq
from .pq import build_pq

# matching method -> the ROADMAP item that ports it
NOT_PORTED = {
    "L2_int8": "the remaining matchers",
    "fractional": "the remaining matchers",
    "LSH": "the remaining matchers",
    "ANNOY": "the remaining matchers",
    "Greedyhash": "the remaining matchers",
    "PQ_Net": "the remaining matchers",
}

# the methods that take --opq and --refine-m
PQ_METHODS = ("PQ", "Nano_PQ", "PQ_HNSW", "HNSW_NanoPQ", "IVFPQ")


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


def _clamp_ks(Ks, n_rows):
    """Largest power-of-two codebook the training set can populate (the
    reference's scripts hardwire Ks=2^13; small galleries halve it down)."""
    while Ks > max(1, n_rows):
        Ks //= 2
    return Ks


def matching_Nano_PQ(K, train, test, dataset, N_books=16, n_bits_perbook=13, ifgenerate=True,
                     outputs="outputs", warmup=True, opq=False, refine_M=0, device="cuda"):
    """PQ + asymmetric-distance scan (``<outputs>/<dataset>/pq``; the
    reference script's N_books=16, n_bits_perbook=13). ``refine_M > 0`` adds
    residual codes and the search re-ranks with them (``adc+refine``)."""
    q = normalize_rows(_as_rows(test, device))
    rows = np.asarray(train, np.float32)
    path = _artifact(dataset, "pq", outputs)
    index = _build_or_load(
        path, ifgenerate,
        lambda: build_pq(rows, M=N_books, Ks=_clamp_ks(2 ** n_bits_perbook, rows.shape[0]),
                         opq=opq, refine_M=refine_M, device=device),
        device,
    )
    return _timed_search(index, q, min(K, index.n), warmup)


def matching_HNSW_NanoPQ(K, train, test, dataset, N_books=16, N_words=2 ** 13, m=16, ef=100,
                         ifgenerate=True, outputs="outputs", warmup=True, opq=False,
                         refine_M=None, device="cuda"):
    """PQ-encode + dedupe + HNSW over the unique codes
    (``<outputs>/<dataset>/hnsw_pq``; the reference script's N_books=16,
    N_words=2^13, m=16, ef=100). ``refine_M=None`` keeps
    ``build_hnsw_pq``'s default (32)."""
    q = normalize_rows(_as_rows(test, device))
    rows = np.asarray(train, np.float32)
    path = _artifact(dataset, "hnsw_pq", outputs)
    kw = {} if refine_M is None else {"refine_M": refine_M}
    index = _build_or_load(
        path, ifgenerate,
        lambda: build_hnsw_pq(rows, M=N_books, Ks=_clamp_ks(N_words, rows.shape[0]), m=m,
                              ef_construction=ef, opq=opq, device=device, **kw),
        device,
    )
    return _timed_search(index, q, min(K, index.n), warmup)


def matching_IVFPQ(K, train, test, dataset, nlist=316, M=16, nbits=8, nprobe=64,
                   ifgenerate=True, outputs="outputs", warmup=True, opq=False, refine_M=0,
                   device="cuda"):
    """IVF-PQ (``<outputs>/<dataset>/ivfpq``; FAISS's nlist=316, M=16,
    nbits=8, nprobe=64). ``opq`` rotates the residuals; ``refine_M > 0``
    adds refinement codes and the search re-ranks with them."""
    q = normalize_rows(_as_rows(test, device))
    path = _artifact(dataset, "ivfpq", outputs)
    index = _build_or_load(
        path, ifgenerate,
        lambda: build_ivfpq(np.asarray(train, np.float32), nlist=nlist, M=M, Ks=2 ** nbits,
                            nprobe=nprobe, opq=opq, refine_M=refine_M, device=device),
        device,
    )
    return _timed_search(index, q, min(K, index.n), warmup)


def _not_ported(method: str) -> Callable:
    def matcher(*args, **kwargs):
        raise SystemExit(not_ported_message(method))

    return matcher


def not_ported_message(method: str) -> str:
    return (f"--matching-method {method} is not ported yet: see ROADMAP, "
            f"{NOT_PORTED[method]}. The port has --matching-method L2, HNSW, "
            f"{', '.join(PQ_METHODS)}.")


# method-name dispatch used by the CLIs
MATCHERS: Dict[str, Callable] = {
    "L2": matching_L2,
    "HNSW": matching_HNSW,
    "PQ": matching_Nano_PQ,
    "Nano_PQ": matching_Nano_PQ,
    "PQ_HNSW": matching_HNSW_NanoPQ,
    "HNSW_NanoPQ": matching_HNSW_NanoPQ,
    "IVFPQ": matching_IVFPQ,
    **{method: _not_ported(method) for method in NOT_PORTED},
}
