"""The ``matching_*`` matcher family behind the CLIs.

Port of ``image_search_engine_for_historical_research_tpu/index/matchers.py``
(:35-342): the same inputs and outputs, ``(idx (num_test, K) int64, seconds
per query)``, and the same ``ifgenerate`` build-or-load artifact contract.
Input features are row-L2-normalized inside each matcher (the PQ_Net
matchers take codewords and codes as given). The clock covers the search
only, never the build, and ends once the ids are on the host; ``warmup=True``
runs one query first so that a first call's set-up is not timed.

Every method of ``MATCHERS`` is ported: ``L2`` (``FlatIndex``), ``L2_int8``
(``Int8FlatIndex``), ``fractional``, ``LSH`` and ``Greedyhash``
(``ops.hashing``), ``ANNOY`` (``RPForestIndex``), ``HNSW`` (native host
build, search in the kernel), the PQ family (``PQ`` / ``Nano_PQ``,
``PQ_HNSW`` / ``HNSW_NanoPQ``, ``IVFPQ``), and ``PQ_Net`` with its bucketed
form ``matching_PQ_Net_bucket``, with the defaults of the reference's
scripts.

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
from ..ops import hashing, kmeans
from ..ops.pq import PQCodebook, adc, codes_long, pq_dist_table, pq_search
from ..ops.softpq import codewords_from_flat
from ..ops.topk import _top_exact
from .base import load_index, normalize_rows, save_index
from .flat import build_flat, build_flat_i8
from .hnsw import build_hnsw, build_hnsw_pq
from .ivfpq import build_ivfpq
from .pq import build_pq
from .rpforest import build_rpforest

# the methods that take --opq and --refine-m
PQ_METHODS = ("PQ", "Nano_PQ", "PQ_HNSW", "HNSW_NanoPQ", "IVFPQ")


def _as_rows(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def _timed_scan(scan, q, warmup=True):
    """``scan(queries) -> (scores, ids)`` over ``q``: ``(ids int64 on the
    host, seconds per query)``, the clock around the search and the copy."""
    if warmup:
        scan(q[:1])
    t1 = time.perf_counter()
    _, idx = scan(q)
    idx = idx.cpu().numpy().astype(np.int64)
    t2 = time.perf_counter()
    return idx, (t2 - t1) / q.shape[0]


def _timed_search(index, qvecs, K, warmup=True):
    return _timed_scan(lambda x: index.search(x, K), qvecs, warmup)


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


def matching_L2_int8(K, train, test, rerank="bfloat16", shortlist=512, warmup=True,
                     device="cuda"):
    """Exact search over an int8 gallery (``Int8FlatIndex``; with
    ``rerank="bfloat16"`` a bf16 copy re-ranks the int8 shortlist)."""
    db = _as_rows(train, device)
    q = normalize_rows(_as_rows(test, device))
    index = build_flat_i8(db, rerank=rerank, shortlist=shortlist, device=device)
    return _timed_search(index, q, min(K, index.n), warmup)


def matching_fractional_dis(K, train, test, p=0.5, warmup=True, device="cuda"):
    """Fractional-distance matcher (the reference's ``p = 0.5``)."""
    db = normalize_rows(_as_rows(train, device))
    q = normalize_rows(_as_rows(test, device))
    k = min(K, db.shape[0])
    return _timed_scan(lambda x: hashing.fractional_topk(db, x, k, p), q, warmup)


def matching_LSH(K, train, test, n_bits=512, seed=42, warmup=True, device="cuda"):
    """Random-hyperplane LSH codes and a Hamming scan."""
    db = normalize_rows(_as_rows(train, device))
    q = normalize_rows(_as_rows(test, device))
    planes = hashing.lsh_hyperplanes(db.shape[1], n_bits, seed, device=device)
    db_codes = hashing.lsh_encode(planes, db)
    q_codes = hashing.lsh_encode(planes, q)
    k = min(K, db.shape[0])
    return _timed_scan(lambda x: hashing.hamming_topk(db_codes, x, k), q_codes, warmup)


def matching_Greedyhash(K, hash_train, hash_test, warmup=True, device="cuda"):
    """Hamming matcher over external binary codes (their signs, packed)."""
    dev = resolve_device(device)
    db = hashing.pack_bits(torch.as_tensor(np.asarray(hash_train) > 0, device=dev))
    q = hashing.pack_bits(torch.as_tensor(np.asarray(hash_test) > 0, device=dev))
    k = min(K, db.shape[0])
    return _timed_scan(lambda x: hashing.hamming_topk(db, x, k), q, warmup)


def matching_ANNOY(K, train, test, metric="euclidean", dataset="default", n_trees=100,
                   leaf_size=512, ifgenerate=True, outputs="outputs", warmup=True,
                   device="cuda"):
    """RP-forest, the ANNOY-class matcher (``<outputs>/<dataset>/rpforest``;
    the reference script's 100 trees, leaf 512)."""
    q = normalize_rows(_as_rows(test, device))
    path = _artifact(dataset, "rpforest", outputs)
    index = _build_or_load(
        path, ifgenerate,
        lambda: build_rpforest(np.asarray(train, np.float32), n_trees=n_trees,
                               leaf_size=leaf_size, device=device),
        device,
    )
    return _timed_search(index, q, min(K, index.n), warmup)


# method-name dispatch used by the CLIs
MATCHERS: Dict[str, Callable] = {
    "L2": matching_L2,
    "L2_int8": matching_L2_int8,
    "fractional": matching_fractional_dis,
    "LSH": matching_LSH,
    "PQ": matching_Nano_PQ,
    "Nano_PQ": matching_Nano_PQ,
    "ANNOY": matching_ANNOY,
    "HNSW": matching_HNSW,
    "PQ_HNSW": matching_HNSW_NanoPQ,
    "HNSW_NanoPQ": matching_HNSW_NanoPQ,
    "IVFPQ": matching_IVFPQ,
    "Greedyhash": matching_Greedyhash,
}


def matching_PQ_Net(K, Codewords, Query, N_books, CW_idx, warmup=True, device="cuda"):
    """ADC over externally trained codewords: ``Codewords`` in the flat
    ``(N_words, N_books * L_word)`` layout, ``CW_idx (N, N_books)`` codes."""
    dev = resolve_device(device)
    cw = codewords_from_flat(_as_rows(Codewords, dev), N_books)
    codes = torch.as_tensor(np.asarray(CW_idx, np.int32), device=dev)
    q = _as_rows(Query, dev)
    k = min(K, codes.shape[0])
    return _timed_scan(lambda x: pq_search(PQCodebook(cw), codes, x, k), q, warmup)


def matching_PQ_Net_bucket(K, Codewords, Query, N_books, CW_idx, Gallery_features,
                           n_buckets=10, warmup=True, device="cuda"):
    """Coarse-bucketed ADC: k-means buckets over the raw gallery features
    (``ops.kmeans.kmeans_fit``'s default seed, its draws from the
    ``_init_centers`` seam) pick each query's bucket, and ADC ranks that
    bucket only; a bucket of fewer than ``K`` rows pads with -1, as the
    reference does. ``warmup`` is accepted for the JAX signature (it times
    no warm-up either)."""
    dev = resolve_device(device)
    centers, labels = kmeans.kmeans_fit(_as_rows(Gallery_features, dev), n_buckets, iters=20)
    return pq_net_bucket_search(K, Codewords, _as_rows(Query, dev), N_books, CW_idx, centers,
                                labels.cpu().numpy())


def pq_net_bucket_search(K, Codewords, q, N_books, CW_idx, centers, labels):
    """The search half of ``matching_PQ_Net_bucket`` over given buckets
    (``centers`` on the queries' device, host ``labels``): codes are laid
    out bucket-major, so each query scans one contiguous window of the
    longest bucket's length. Returns ``(idx (Q, K) int64, seconds per
    query)``, the clock around the scan."""
    dev = q.device
    n_buckets = centers.shape[0]
    qbucket = kmeans._assign(q, centers).cpu().numpy()
    cw = codewords_from_flat(_as_rows(Codewords, dev), N_books)
    codes = np.asarray(CW_idx, np.int32)
    dt = pq_dist_table(PQCodebook(cw), q)                      # (Q, M, Ks)

    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_buckets)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    maxlen = int(counts.max())
    sorted_codes = np.zeros((starts[-1] + counts[-1] + maxlen, N_books), np.int32)
    sorted_codes[: codes.shape[0]] = codes[order]
    k_eff = min(K, maxlen)

    t1 = time.perf_counter()
    slots = torch.arange(maxlen, device=dev)
    win = torch.as_tensor(starts[qbucket], device=dev)[:, None] + slots[None, :]
    cand = codes_long(torch.as_tensor(sorted_codes, device=dev))[win]   # (Q, maxlen, M)
    length = torch.as_tensor(counts[qbucket], device=dev)
    s = torch.where(slots[None, :] < length[:, None], -adc(dt, cand), float("-inf"))
    top_s, sel = _top_exact(s, k_eff)
    top_s, pos = top_s.cpu().numpy(), win.gather(1, sel).cpu().numpy()
    idx = np.full((q.shape[0], K), -1, np.int64)
    idx[:, :k_eff] = np.where(np.isfinite(top_s), order[np.minimum(pos, len(order) - 1)], -1)
    t2 = time.perf_counter()
    return idx, (t2 - t1) / q.shape[0]


MATCHERS["PQ_Net"] = matching_PQ_Net
