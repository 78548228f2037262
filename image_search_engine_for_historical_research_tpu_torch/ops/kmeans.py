"""Lloyd k-means on the device, memory-bounded at million-row scale.

Port of ``image_search_engine_for_historical_research_tpu/ops/kmeans.py``
(:24-163, :266-281): ``_chunked``, ``_assign_chunk``, ``_kmeanspp_init``,
``_init_centers``, ``kmeans_fit`` (the ``ASSIGN_BUDGET`` chunk rule, empty
clusters keep their centre), ``kmeans_fit_batched`` and ``_assign``. The
sharded fit (``kmeans_fit_sharded``) is not ported yet.

Two things differ from the JAX package by design:

- **Random draws.** JAX's threefry draws cannot be reproduced in torch. Every
  draw here comes from a host ``torch.Generator`` seeded by ``seed``, so a
  CPU fit and a card fit start from the same rows and the same noise. The
  draws live in one function, ``_init_centers``: k-means++ draws the Gumbel
  noise for all ``k - 1`` steps at once on the host and takes
  ``argmax(log d^2 + g)`` on the device (categorical sampling with no host
  round trip a step); ``"points"`` draws distinct rows.
- **Centroid sums are order-fixed.** ``jax.ops.segment_sum`` becomes
  ``segment_sum_rows``: on the card ``index_put_(accumulate=True)``, which
  sorts by index and adds each cluster's rows in row order (no float
  atomics); on the CPU ``index_add_``, which adds them serially in row order
  (the CPU's ``index_put_`` accumulates in parallel). So two fits from one
  seed give identical centres and a streamed build equals the in-memory
  one. Counts are an integer ``bincount``.

Assignments are ``argmin(||c||^2 - 2 x.c)`` with the first centre winning a
tie (``jnp.argmin`` and ``torch.argmin`` agree); ``matmul_dtype=bfloat16``
multiplies bf16 operands into f32 products (``ops.topk._matmul_f32``), while
the centroid sums stay f32.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import _matmul_f32

INIT_SAMPLE = 65536  # kmeans++ init subsample size
ASSIGN_BUDGET = 1 << 27  # elements: cap on the transient (chunk, k) distance block


def _chunked(x: torch.Tensor, chunk: int):
    """Row chunks of ``x`` as views (the last one shorter instead of padded)
    and the row count."""
    N = x.shape[0]
    return [x[s:s + chunk] for s in range(0, N, chunk)], N


def _assign_chunk(xc, centers, c2, matmul_dtype=None):
    """Nearest-centre ids (int64) for one chunk ``(c, d)``."""
    if matmul_dtype is not None:
        xc, centers = xc.to(matmul_dtype), centers.to(matmul_dtype)
    dots = _matmul_f32(xc, centers)
    return torch.argmin(dots.mul_(-2.0).add_(c2[None, :]), dim=1)


def _host_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def _kmeanspp_init(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ on a subsample: D^2-weighted greedy centre sampling.

    The subsample, the first centre and the Gumbel noise of every later step
    come from ``gen`` on the host; each step is ``argmax(log d^2 + g)``."""
    N = x.shape[0]
    dev = x.device
    if N > INIT_SAMPLE:
        idx = torch.randperm(N, generator=gen)[:INIT_SAMPLE]
        x = x[idx.to(dev)]
        N = INIT_SAMPLE
    x32 = x.float()
    first = int(torch.randint(0, N, (), generator=gen))
    gumbel = torch.empty((max(k - 1, 0), N)).exponential_(generator=gen).log_().neg_()
    gumbel = gumbel.to(dev)
    centers = torch.empty((k, x32.shape[1]), dtype=torch.float32, device=dev)
    centers[0] = x32[first]
    min_d2 = ((x32 - x32[first][None, :]) ** 2).sum(1)
    for j in range(1, k):
        logits = torch.log(torch.clamp(min_d2, min=1e-30))
        idx = torch.argmax(logits + gumbel[j - 1])
        center = x32[idx]
        centers[j] = center
        min_d2 = torch.minimum(min_d2, ((x32 - center[None, :]) ** 2).sum(1))
    return centers


def _init_centers(x: torch.Tensor, k: int, seed: int, init: str) -> torch.Tensor:
    """Initial ``(k, d)`` f32 centres: every random draw of a fit is made
    here, from a host generator seeded by ``seed``."""
    gen = _host_generator(seed)
    N, d = x.shape
    if init == "points":
        idx = torch.randperm(N, generator=gen)[:min(k, N)]
        centers = x[idx.to(x.device)].float()
        if k > N:
            centers = torch.cat([centers, centers[:1].expand(k - N, d)], 0)
        return centers
    return _kmeanspp_init(x, k, gen)


def segment_sum_rows(out: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``out[idx[i]] += rows[i]`` in place, each segment summed in row order
    on every device (see the module docstring)."""
    if out.device.type == "cuda":
        out.index_put_((idx,), rows, accumulate=True)
    else:
        out.index_add_(0, idx, rows)


def _accumulate(sums, counts, xcb, assign):
    """Add one chunk's rows into the per-cluster sums and counts."""
    segment_sum_rows(sums, assign, xcb.float())
    counts += torch.bincount(assign, minlength=counts.shape[0])


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    iters: int = 20,
    seed: int = 42,
    chunk: int = 131072,
    matmul_dtype=None,
    init: str = "kmeans++",
):
    """Lloyd k-means: returns ``(centers (k, d) f32, assignments (N,) int64)``.

    Initialization from ``_init_centers(x, k, seed, init)``; empty clusters
    keep their previous centre;
    assignment streams over row chunks so the transient distance block stays
    under ``ASSIGN_BUDGET`` elements. ``init="points"``: distinct random rows
    instead of k-means++ (which is a sequential k-step loop)."""
    N, d = x.shape
    centers = _init_centers(x, k, seed, init)

    chunk = min(chunk, max(1024, ASSIGN_BUDGET // k))
    chunk = min(chunk, ((N + 127) // 128) * 128)
    xc, _ = _chunked(x, chunk)

    for _ in range(iters):
        c2 = (centers.float() ** 2).sum(1)
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((k,), dtype=torch.int64, device=x.device)
        for xcb in xc:
            _accumulate(sums, counts, xcb, _assign_chunk(xcb, centers, c2, matmul_dtype))
        cnt = counts.float()[:, None]
        centers = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), centers)

    c2 = (centers ** 2).sum(1)
    assign = torch.cat([_assign_chunk(xcb, centers, c2, matmul_dtype) for xcb in xc])
    return centers, assign


def subspace_seed(seed: int, m: int) -> int:
    """The host seed of fit ``m`` of a batch of fits seeded ``seed`` (JAX
    splits one key into one key a fit)."""
    return int(np.random.SeedSequence((int(seed), int(m))).generate_state(1, np.uint64)[0])


def kmeans_fit_batched(x: torch.Tensor, k: int, iters: int = 20, seed: int = 42):
    """One fit per leading index: ``x (M, N, d) -> (M, k, d), (M, N)``."""
    fits = [kmeans_fit(x[m], k, iters, seed=subspace_seed(seed, m)) for m in range(x.shape[0])]
    return torch.stack([c for c, _ in fits]), torch.stack([a for _, a in fits])


def _assign(x, centers):
    """Nearest-centre ids (small inputs; used by matchers)."""
    c2 = (centers.float() ** 2).sum(1)
    return _assign_chunk(x, centers, c2)
