"""Lloyd k-means on the device, memory-bounded at million-row scale.

Port of ``image_search_engine_for_historical_research_tpu/ops/kmeans.py``
(:24-163, :266-281): ``_assign_chunk``, ``_kmeanspp_init``,
``_init_centers``, ``kmeans_fit`` (the ``ASSIGN_BUDGET`` chunk rule, empty
clusters keep their centre), ``kmeans_fit_sharded`` (:165-263),
``kmeans_fit_batched`` and ``_assign``.

Three things differ from the JAX package by design:

- **Random draws.** JAX's threefry draws cannot be reproduced in torch. Every
  draw here comes from a host ``torch.Generator`` seeded by ``seed``, so a
  CPU fit and a card fit start from the same rows and the same noise. The
  draws live in ``_init_draws`` and ``_gumbel``: k-means++ draws the Gumbel
  noise on the host ``GUMBEL_STEPS`` steps at a time and takes
  ``argmax(log d^2 + g)`` on the device (categorical sampling with no host
  round trip a step); ``"points"`` draws distinct rows.
- **Fits run batched.** ``kmeans_fit_batched`` (and through it every PQ
  fit, ``ops.pq._subspace_fits``) runs the k-means++ steps and the Lloyd
  iterations of all its fits together on ``(M, N, d)`` tensors, each fit
  with its own host generator drawing what a single fit draws, in parallel
  host threads. ``kmeans_fit`` is the case ``M = 1``. Inside
  ``shared_draws()`` fits that would draw the same numbers (same seeds, row
  count, ``k`` and init, as OPQ's rounds do) draw them once. JAX fits PQ's
  subspaces one after another, each fit one jitted program; one at a time
  here, each k-means++ step would be a few small launches, ``M`` times over.
- **Centroid sums are order-fixed.** ``jax.ops.segment_sum`` becomes
  ``segment_sum_rows``: on the card ``index_put_(accumulate=True)``, which
  sorts by index and adds each cluster's rows in row order (no float
  atomics); on the CPU ``index_add_``, which adds them serially in row order
  (the CPU's ``index_put_`` accumulates in parallel). So two fits from one
  seed give identical centres and a streamed build equals the in-memory
  one. Counts are an integer ``bincount``.

**The sharded fit.** ``kmeans_fit_sharded`` (and ``ops.pq.pq_train(mesh=)``
through ``fit_sharded``) runs SPMD over a ``parallel.data_mesh``: every rank
draws the same initial centres from the full rows, assigns and sums its own
row block, and one ``all_reduce`` of the f32 sums and the int64 counts an
iteration (for all the batch's fits together) gives every rank the same
centres. In a world of one it does the unsharded fit's arithmetic in the
same order.

Assignments are ``argmin(||c||^2 - 2 x.c)`` with the first centre winning a
tie (``jnp.argmin`` and ``torch.argmin`` agree); ``matmul_dtype=bfloat16``
multiplies bf16 operands into f32 products (``ops.topk._bmm_f32``), while
the centroid sums stay f32.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from .topk import _bmm_f32

INIT_SAMPLE = 65536  # kmeans++ init subsample size
GUMBEL_STEPS = 32    # k-means++ steps whose noise is drawn and moved at once
ASSIGN_BUDGET = 1 << 27  # elements: cap on the transient (chunk, k) distance block


def _assign_chunk(xc, centers, c2, matmul_dtype=None):
    """Nearest-centre ids (int64) of ``M`` fits' chunks ``xc (M, c, d)``
    against ``centers (M, k, d)`` with squared norms ``c2 (M, k)``."""
    if matmul_dtype is not None:
        xc, centers = xc.to(matmul_dtype), centers.to(matmul_dtype)
    return torch.argmin(_bmm_f32(xc, centers).mul_(-2.0).add_(c2[:, None, :]), dim=2)


def _host_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def _map_generators(fn, gens):
    """``[fn(g) for g in gens]``, the generators drawn from in parallel host
    threads. Each draw uses only its own generator, so the results do not
    depend on the schedule."""
    if len(gens) == 1:
        return [fn(gens[0])]
    with ThreadPoolExecutor(max_workers=min(len(gens), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, gens))


_SHARED = threading.local()  # .draws: a dict while ``shared_draws()`` is open in this thread


@contextmanager
def shared_draws():
    """Inside the block (in this thread), batches of fits with the same
    seeds, row count, ``k`` and init take their draws (on their device) from
    one set: they would draw the same numbers. ``ops.pq.opq_train`` fits
    ``opq_iters + 1`` codebooks from one seed this way."""
    outer = getattr(_SHARED, "draws", None)
    _SHARED.draws = {} if outer is None else outer
    try:
        yield
    finally:
        _SHARED.draws = outer


def _draws(seeds, N: int, k: int, init: str, device):
    """``_init_draws`` from host generators seeded by ``seeds``, on
    ``device``: the row picks, and for k-means++ the subsample, the first
    rows and ``_gumbel_blocks`` of the later steps' noise; shared inside
    ``shared_draws()``, where the noise blocks are kept once drawn."""
    shared = getattr(_SHARED, "draws", None)
    key = (tuple(seeds), N, k, init, str(device))
    if shared is not None and key in shared:
        return shared[key]
    gens = [_host_generator(s) for s in seeds]
    draws = _init_draws(gens, N, k, init)
    if init == "points":
        out = torch.stack(draws).to(device)
    else:
        out = (None if draws[0][0] is None else torch.stack([d[0] for d in draws]).to(device),
               torch.tensor([d[1] for d in draws], device=device),
               _gumbel_blocks(gens, k, min(N, INIT_SAMPLE), device, keep=shared is not None))
    if shared is not None:
        shared[key] = out
    return out


def _init_draws(gens, N: int, k: int, init: str):
    """The row draws of a batch of fits, one host generator a fit, in the
    order a single fit draws: for ``"kmeans++"`` the subsample
    (``randperm`` above ``INIT_SAMPLE`` rows, else None) and the first centre
    (``randint``), after which each generator draws its Gumbel noise
    (``_gumbel_blocks``); for ``"points"`` the ``min(k, N)`` distinct rows
    (``randperm``)."""
    if init == "points":
        return _map_generators(lambda g: torch.randperm(N, generator=g)[:min(k, N)], gens)

    def kmeanspp(g):
        sub = torch.randperm(N, generator=g)[:INIT_SAMPLE] if N > INIT_SAMPLE else None
        return sub, int(torch.randint(0, min(N, INIT_SAMPLE), (), generator=g))

    return _map_generators(kmeanspp, gens)


def _gumbel(gens, steps: int, n: int) -> torch.Tensor:
    """The next ``steps`` k-means++ steps' Gumbel noise of each generator
    (``-log`` of exponential draws), as a host ``(steps, M, n)`` f32 tensor.
    A generator's blocks drawn one after another are its ``(k - 1, n)``
    draw of a single fit, row block by row block."""
    return torch.stack(_map_generators(
        lambda g: torch.empty((steps, n)).exponential_(generator=g).log_().neg_(), gens), 1)


def _gumbel_blocks(gens, k: int, n: int, device, keep: bool):
    """``block(i)``: steps ``1 + i * GUMBEL_STEPS`` onward of the k-means++
    noise, ``(<= GUMBEL_STEPS, M, n)`` on ``device``. Blocks are drawn on
    the host one at a time, in order, so the host holds one block; with
    ``keep`` (shared draws) each is kept on ``device`` once drawn, the whole
    ``(k - 1, M, n)`` noise at the end of the first fit."""
    blocks = []

    def block(i):
        if i < len(blocks):
            return blocks[i]
        out = _gumbel(gens, min(GUMBEL_STEPS, k - 1 - i * GUMBEL_STEPS), n).to(device)
        if keep:
            blocks.append(out)
        return out

    return block


def _kmeanspp_init(x: torch.Tensor, k: int, draws) -> torch.Tensor:
    """k-means++ of a batch of fits at once: ``x (M, N, d)`` -> ``(M, k, d)``
    f32 D^2-weighted greedy centres, on a subsample of ``INIT_SAMPLE`` rows
    above that (``draws`` as ``_draws`` returns them). Step ``j`` of every
    fit is one ``argmax(log d^2 + g)`` over ``(M, n)`` and one gather with a
    1-d index tensor, so the loop queues on the device with no host round
    trip."""
    sub, first, noise = draws
    M = x.shape[0]
    ar = torch.arange(M, device=x.device)
    if sub is not None:
        x = x[ar[:, None], sub]
    x32 = x.float().contiguous()

    def d2(center):
        return torch.sub(x32, center[:, None, :]).square_().sum(2)

    center = x32[ar, first]
    centers = torch.empty((M, k, x32.shape[2]), dtype=torch.float32, device=x.device)
    centers[:, 0] = center
    min_d2 = d2(center)
    for j0 in range(1, k, GUMBEL_STEPS):
        block = noise((j0 - 1) // GUMBEL_STEPS)                # (steps, M, n)
        for j in range(j0, min(k, j0 + GUMBEL_STEPS)):
            logits = torch.log(torch.clamp(min_d2, min=1e-30))
            center = x32[ar, torch.argmax(logits + block[j - j0], dim=1)]
            centers[:, j] = center
            min_d2 = torch.minimum(min_d2, d2(center))
    return centers


def _init_centers_batched(x: torch.Tensor, k: int, seeds, init: str) -> torch.Tensor:
    """Initial ``(M, k, d)`` f32 centres of ``M`` fits over ``x (M, N, d)``,
    fit ``m`` drawing from a host generator seeded by ``seeds[m]``."""
    M, N, d = x.shape
    draws = _draws(seeds, N, k, init, x.device)
    if init != "points":
        return _kmeanspp_init(x, k, draws)
    centers = x[torch.arange(M, device=x.device)[:, None], draws].float()
    if k > N:
        centers = torch.cat([centers, centers[:, :1].expand(M, k - N, d)], 1)
    return centers


def _init_centers(x: torch.Tensor, k: int, seed: int, init: str) -> torch.Tensor:
    """Initial ``(k, d)`` f32 centres of one fit: every random draw of a fit
    is made here, from a host generator seeded by ``seed``."""
    return _init_centers_batched(x[None], k, [seed], init)[0]


def segment_sum_rows(out: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``out[idx[i]] += rows[i]`` in place, each segment summed in row order
    on every device (see the module docstring)."""
    if out.device.type == "cuda":
        out.index_put_((idx,), rows, accumulate=True)
    else:
        out.index_add_(0, idx, rows)


def _lloyd(x, centers, iters, chunk, matmul_dtype=None, group=None):
    """Lloyd iterations of ``M`` fits at once from ``centers (M, k, d)``
    over ``x (M, N, d)``: returns the centres and the ``(M, N)`` int64
    assignments. Each row chunk is one batched GEMM for the assignments and
    one ``segment_sum_rows`` over ``m * k + assign`` ids for the sums. With
    a process ``group``, ``x`` is this rank's row block and the sums and
    counts are all-reduced over the group once an iteration."""
    M, N, d = x.shape
    k = centers.shape[1]
    chunk = min(chunk, max(1024, ASSIGN_BUDGET // (M * k)))
    chunk = min(chunk, ((N + 127) // 128) * 128)
    off = torch.arange(M, device=x.device)[:, None] * k
    for _ in range(iters):
        c2 = (centers.float() ** 2).sum(2)
        sums = torch.zeros((M * k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((M * k,), dtype=torch.int64, device=x.device)
        for s in range(0, N, chunk):
            xcb = x[:, s:s + chunk]
            ids = (_assign_chunk(xcb, centers, c2, matmul_dtype) + off).reshape(-1)
            segment_sum_rows(sums, ids, xcb.float().reshape(-1, d))
            counts += torch.bincount(ids, minlength=M * k)
        if group is not None:
            dist.all_reduce(sums, group=group)
            dist.all_reduce(counts, group=group)
        cnt = counts.float().view(M, k, 1)
        centers = torch.where(cnt > 0, sums.view(M, k, d) / cnt.clamp(min=1.0), centers)

    c2 = (centers ** 2).sum(2)
    return centers, torch.cat([_assign_chunk(x[:, s:s + chunk], centers, c2, matmul_dtype)
                               for s in range(0, N, chunk)], 1)


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
    centers, assign = _lloyd(x[None], _init_centers(x, k, seed, init)[None], iters, chunk,
                             matmul_dtype)
    return centers[0], assign[0]


def fit_sharded(x, k: int, seeds, mesh, iters: int = 20, chunk: int = 131072,
                matmul_dtype=None, init: str = "kmeans++", axis: str = "data"):
    """``M`` fits over the full rows ``x (M, N, d)`` (a strided view will
    do) with their rows sharded over ``mesh``'s ``axis``: fit ``m`` starts
    from ``_init_centers_batched``'s centres for ``seeds[m]`` over the full
    rows, then Lloyd runs on this rank's row block with the sums
    all-reduced. Returns ``(centres (M, k, d), this rank's (M, N / world)
    assignments)``, the centres equal on every rank. Raises ``ValueError``
    when N does not divide the mesh."""
    from ..parallel.mesh import local_rows

    rows, _ = local_rows(x.transpose(0, 1), mesh, axis)      # (N / world, M, d)
    centers = _init_centers_batched(x, k, seeds, init)
    return _lloyd(rows.transpose(0, 1), centers, iters, chunk, matmul_dtype,
                  group=mesh.get_group(axis))


def kmeans_fit_sharded(
    x,
    k: int,
    mesh,
    iters: int = 20,
    seed: int = 42,
    chunk: int = 131072,
    matmul_dtype=None,
    init: str = "kmeans++",
    axis: str = "data",
):
    """Row-sharded Lloyd k-means over a ``parallel.data_mesh``: returns
    ``(centers (k, d) f32, assignments (N,) int64)``, both full and equal
    on every rank. ``x`` is the full ``(N, d)`` rows or a ``shard_batch``
    result. The initial centres are ``kmeans_fit``'s (drawn from the full
    rows with ``seed`` on every rank), so sharded and unsharded fits differ
    only by the order of the all-reduced sums. N must divide the mesh."""
    from ..parallel.mesh import full_rows, gather_rows

    centers, assign = fit_sharded(full_rows(x)[None], k, [seed], mesh, iters, chunk,
                                  matmul_dtype, init, axis)
    return centers[0], gather_rows(assign[0], mesh, axis)


def subspace_seed(seed: int, m: int) -> int:
    """The host seed of fit ``m`` of a batch of fits seeded ``seed`` (JAX
    splits one key into one key a fit)."""
    return int(np.random.SeedSequence((int(seed), int(m))).generate_state(1, np.uint64)[0])


def kmeans_fit_batched(
    x: torch.Tensor,
    k: int,
    iters: int = 20,
    seed: int = 42,
    chunk: int = 131072,
    matmul_dtype=None,
    init: str = "kmeans++",
):
    """One fit per leading index, all run together: ``x (M, N, d)`` (a
    strided view will do) -> ``(M, k, d), (M, N)``. Fit ``m`` draws from
    ``subspace_seed(seed, m)`` exactly as ``kmeans_fit`` would, so it
    starts from the same rows."""
    seeds = [subspace_seed(seed, m) for m in range(x.shape[0])]
    return _lloyd(x, _init_centers_batched(x, k, seeds, init), iters, chunk, matmul_dtype)


def _assign(x, centers):
    """Nearest-centre ids (small inputs; used by matchers)."""
    c2 = (centers.float() ** 2).sum(1)
    return _assign_chunk(x[None], centers[None], c2[None])[0]
