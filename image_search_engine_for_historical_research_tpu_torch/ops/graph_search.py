"""HNSW graph traversal in plain PyTorch: the upper-level greedy descent and
the lockstep level-0 beam search over raw vectors.

Port of ``_greedy_descent``, ``_beam_search_l0``, ``make_hnsw_search``,
``hnsw_search_batch``, ``_l2_coarse_seeds``, ``_l2_search_all`` and
``hnsw_descend_entries`` in
``image_search_engine_for_historical_research_tpu/ops/graph_search.py``
(:37-234, :410-438). The JAX package ``vmap``s a per-query ``while_loop``;
here the batch dimension is written out and the loop runs while any query has
work. A query whose loop has ended keeps its state, as the ``vmap`` masks it,
so every query follows exactly its own per-query trajectory. Sorts are stable
wherever the JAX package uses ``jnp.argsort`` (stable): the order of ids in
the beam, ``INF`` slots included, depends on it.

Distances are squared L2 in f32; scores are their negation. The at-scale
level-0 search over raw vectors is the CUDA kernel (``ops.beam_search``);
this traversal is the JAX package's default route,
``HNSWIndex.search(use_kernel=False)``.

The PQ walks (:31-35, :237-408: ``_adc``, ``hnsw_search_batch_pq`` and
``hnsw_search_batch_pq_centroid`` with their coarse seeds) run the same
traversal with an ADC distance factory: a node's distance is the sum of its
code's LUT entries, added over m = 0..M-1 in order (``_adc`` is
``ops.pq.adc``, the ADC of the flat scan and the IVF probe). Their coarse seeds are a
``_top_exact`` (the lowest ids among equal ADC distances, as ``lax.top_k``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .pq import PQCodebook, codes_long, pq_dist_table, pq_ip_table
from .pq import adc as _adc
from .topk import _top, _top_exact

INF = float("inf")


def _l2_dist_factory(vectors: torch.Tensor) -> Callable:
    """``queries (Q, D) -> dist_to``: ``dist_to(ids (Q, m)) -> (Q, m)``
    squared L2 in f32, ``INF`` where ``id < 0``."""

    def factory(queries):
        q = queries.float()

        def dist_to(ids):
            v = vectors[ids.clamp(min=0).long()].float()      # (Q, m, D)
            d = ((v - q[:, None, :]) ** 2).sum(-1)
            return torch.where(ids >= 0, d, INF)

        return dist_to

    return factory


def _greedy_descent(dist_to, nbrs, point, pd):
    """Greedy best-neighbour descent on one level, batched: each query moves
    to its best neighbour (first index among equals) while that is strictly
    closer. A query that stops improving keeps its point, so running until no
    query improves gives each query's own while-loop result."""
    while True:
        cand = nbrs[point]                                    # (Q, m)
        bd, best = dist_to(cand).min(dim=1)
        take = bd < pd
        if not bool(take.any()):
            return point, pd
        point = torch.where(take, cand.gather(1, best[:, None])[:, 0].long(), point)
        pd = torch.where(take, bd, pd)


def _descend(dist_to, nbru, entry, Q, dev):
    """``(point, distance)`` per query after the greedy descent from
    ``entry`` through levels L-1..0 of ``nbru``."""
    point = torch.full((Q,), int(entry), dtype=torch.long, device=dev)
    pd = dist_to(point[:, None])[:, 0]
    for level in range(nbru.shape[0] - 1, -1, -1):
        point, pd = _greedy_descent(dist_to, nbru[level], point, pd)
    return point, pd


def _beam_search_l0(dist_to, nbr0, entries, entry_ds, N, ef, max_steps):
    """ef-bounded best-first search on level 0 for a batch of queries.

    ``entries (Q, S)`` seed each beam with several entry points (-1 for a
    masked duplicate); ``entry_ds (Q, S)`` are their distances. Returns the
    beams ``(ids (Q, ef), distances (Q, ef))`` in ascending distance."""
    Q, S = entries.shape
    m0 = nbr0.shape[1]
    dev = entries.device
    rows = torch.arange(Q, device=dev)

    beam_ids = torch.full((Q, ef), -1, dtype=torch.long, device=dev)
    beam_ids[:, :S] = entries
    beam_d = torch.full((Q, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, :S] = entry_ds
    expanded = torch.zeros((Q, ef), dtype=torch.bool, device=dev)
    # a -1 entry redirects to the query's first entry, a real node
    safe_entries = torch.where(entries >= 0, entries, entries[:, :1])
    visited = torch.zeros((Q, N), dtype=torch.bool, device=dev)
    visited[rows[:, None].expand_as(safe_entries), safe_entries] = True
    steps = torch.zeros(Q, dtype=torch.long, device=dev)
    no_exp = torch.zeros((Q, m0), dtype=torch.bool, device=dev)

    while True:
        valid = beam_ids >= 0
        frontier = ~expanded & valid
        worst = torch.where(valid, beam_d, -INF).amax(dim=1, keepdim=True)
        active = (steps < max_steps) & (frontier & (beam_d <= worst)).any(dim=1)
        if not bool(active.any()):
            return beam_ids, beam_d

        i = torch.where(frontier, beam_d, INF).argmin(dim=1)
        exp_i = expanded.clone()
        exp_i[rows, i] = True
        node = beam_ids[rows, i].clamp(min=0)
        cand = nbr0[node].long()                              # (Q, m0)
        safe = cand.clamp(min=0)
        # fresh is read before this hop's marks: an id twice in the row is
        # fresh twice, as in the JAX gather-then-scatter
        fresh = (cand >= 0) & ~visited.gather(1, safe)
        mark = fresh & active[:, None]
        visited[rows[:, None].expand_as(safe)[mark], safe[mark]] = True
        d = torch.where(fresh, dist_to(cand), INF)

        all_ids = torch.cat([beam_ids, cand], 1)
        all_d = torch.cat([beam_d, d], 1)
        all_exp = torch.cat([exp_i, no_exp], 1)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :ef]
        keep = active[:, None]
        beam_ids = torch.where(keep, all_ids.gather(1, order), beam_ids)
        beam_d = torch.where(keep, all_d.gather(1, order), beam_d)
        expanded = torch.where(keep, all_exp.gather(1, order), expanded)
        steps = steps + active.long()


def make_hnsw_search(node_dist_factory: Callable):
    """A batched HNSW search given a distance factory:
    ``node_dist_factory(ctx) -> dist_to``, where ``ctx`` holds one row per
    query (the raw queries for L2, the LUTs for PQ, a tuple of LUTs for the
    centroid walk) and ``dist_to(ids (Q, m)) -> (Q, m)``."""

    def search_all(ctx, nbr0, nbru, entry, k, ef, max_steps, N, seeds=None):
        dist_to = node_dist_factory(ctx)
        dev = nbr0.device
        Q = (ctx[0] if isinstance(ctx, tuple) else ctx).shape[0]
        point, pd = _descend(dist_to, nbru, entry, Q, dev)

        if seeds is None:
            entries, entry_ds = point[:, None], pd[:, None]
        else:
            entries = torch.cat([point[:, None], seeds.long()], 1)
            # mask duplicate entries (the descent point is often a seed too):
            # an id twice would take two beam slots and come back twice
            S = entries.shape[1]
            earlier = torch.ones(S, S, dtype=torch.bool, device=dev).tril(-1)
            dup = ((entries[:, :, None] == entries[:, None, :]) & earlier).any(2)
            entries = torch.where(dup, -1, entries)
            entry_ds = torch.where(dup, INF, dist_to(entries))
        beam_ids, beam_d = _beam_search_l0(dist_to, nbr0, entries, entry_ds, N, ef, max_steps)
        return beam_ids[:, :k].to(torch.int32), -beam_d[:, :k]

    return search_all


def hnsw_search_batch(
    vectors: torch.Tensor,
    nbr0: torch.Tensor,
    nbru: torch.Tensor,
    entry: int,
    queries: torch.Tensor,
    k: int,
    ef: int,
    max_steps: int = 0,
    coarse_ids: Optional[torch.Tensor] = None,
    n_seeds: int = 4,
):
    """Raw-vector (squared-L2) batched HNSW search; returns
    ``(scores (Q, k), ids (Q, k) int32)``. With ``coarse_ids`` (the ids of
    upper-level members) the best ``n_seeds`` coarse nodes by L2 seed each
    beam beside the greedy-descent entry."""
    N = vectors.shape[0]
    ef = max(ef, k)
    max_steps = max_steps or 4 * ef
    seeds_all = None
    if coarse_ids is not None and coarse_ids.shape[0] > 0:
        n_seeds = min(n_seeds, coarse_ids.shape[0])
        seeds_all = _l2_coarse_seeds(queries, vectors, coarse_ids, n_seeds)
    ids, scores = _l2_search_all(queries, vectors, nbr0, nbru, seeds_all, entry=int(entry),
                                 k=k, ef=ef, max_steps=max_steps, N=N)
    return scores, ids


def _l2_coarse_seeds(queries, vectors, coarse_ids, n_seeds):
    """The ``n_seeds`` coarse nodes nearest each query by squared L2
    (``||c||^2 - 2 q.c``; inner-product ranking agrees only on normalized
    galleries)."""
    cvecs = vectors[coarse_ids.long()].float()
    d = (cvecs * cvecs).sum(-1)[None, :] - 2.0 * (queries.float() @ cvecs.T)
    _, top = _top(-d, n_seeds)
    return coarse_ids[top]


def _l2_search_all(queries, vectors, nbr0, nbru, seeds_all, *, entry, k, ef, max_steps, N):
    search_all = make_hnsw_search(_l2_dist_factory(vectors))
    return search_all(queries, nbr0, nbru, entry, k, ef, max_steps, N, seeds_all)


def hnsw_search_batch_pq(
    codes: torch.Tensor,       # (N, M) codes
    codewords: torch.Tensor,   # (M, Ks, ds)
    nbr0: torch.Tensor,
    nbru: torch.Tensor,
    entry: int,
    queries: torch.Tensor,
    k: int,
    ef: int,
    max_steps: int = 0,
    coarse_ids: Optional[torch.Tensor] = None,
    n_seeds: int = 4,
):
    """ADC-distance batched HNSW search over PQ codes; returns ``(scores
    (Q, k), ids (Q, k) int32)``. With ``coarse_ids`` one ADC scan over the
    coarse nodes seeds each beam with its best ``n_seeds``."""
    N = codes.shape[0]
    ef = max(ef, k)
    max_steps = max_steps or 4 * ef
    luts = pq_dist_table(PQCodebook(codewords), queries).contiguous()    # (Q, M, Ks)
    codes64 = codes_long(codes)
    seeds_all = None
    if coarse_ids is not None and coarse_ids.shape[0] > 0:
        ns = min(n_seeds, coarse_ids.shape[0])
        seeds_all = _pq_coarse_seeds(luts, codes64, coarse_ids, ns)
    ids, scores = _pq_search_all(luts, codes64, nbr0, nbru, seeds_all, entry=int(entry), k=k,
                                 ef=ef, max_steps=max_steps, N=N)
    return scores, ids


def _pq_coarse_seeds(luts, codes64, coarse_ids, n_seeds):
    dc = _adc(luts, codes64[coarse_ids.long()])                 # (Q, C)
    _, top = _top_exact(-dc, n_seeds)
    return coarse_ids[top]


def _pq_search_all(luts, codes64, nbr0, nbru, seeds_all, *, entry, k, ef, max_steps, N):
    def factory(lut):
        def dist_to(ids):
            return torch.where(ids >= 0, _adc(lut, codes64[ids.clamp(min=0).long()]), INF)

        return dist_to

    search_all = make_hnsw_search(factory)
    return search_all(luts, nbr0, nbru, entry, k, ef, max_steps, N, seeds_all)


def hnsw_search_batch_pq_centroid(
    codes: torch.Tensor,          # (N, M) coarse codes
    codewords: torch.Tensor,      # (M, Ks, ds)
    node_codes: torch.Tensor,     # (N, Mr) centroid refine codes
    node_codewords: torch.Tensor,  # (Mr, Ksr, dsr)
    node_norm2: torch.Tensor,     # (N,) ||centroid||^2
    nbr0: torch.Tensor,
    nbru: torch.Tensor,
    entry: int,
    queries: torch.Tensor,
    k: int,
    ef: int,
    max_steps: int = 0,
    coarse_ids: Optional[torch.Tensor] = None,
    n_seeds: int = 4,
    rotation: Optional[torch.Tensor] = None,
    node_rotation: Optional[torch.Tensor] = None,
):
    """Centroid-ADC beam search over a two-level code graph: a node's
    distance is the exact squared distance to its members' centroid
    ``x_u = decode(coarse_u) + decode(node_refine_u)`` up to ``||q||^2``,
    ``node_norm2[u] - 2 (q.c_u + q.r_u)``, from two inner-product LUTs and
    the stored norm."""
    N = codes.shape[0]
    ef = max(ef, k)
    max_steps = max_steps or 4 * ef
    lutc = pq_ip_table(PQCodebook(codewords, rotation), queries).contiguous()
    lutr = pq_ip_table(PQCodebook(node_codewords, node_rotation), queries).contiguous()
    codes64 = codes_long(codes)
    ncodes64 = codes_long(node_codes)
    norm2 = node_norm2.float()
    seeds_all = None
    if coarse_ids is not None and coarse_ids.shape[0] > 0:
        ns = min(n_seeds, coarse_ids.shape[0])
        seeds_all = _pq2_coarse_seeds(lutc, lutr, codes64, ncodes64, norm2, coarse_ids, ns)
    ids, scores = _pq2_search_all(lutc, lutr, codes64, ncodes64, norm2, nbr0, nbru, seeds_all,
                                  entry=int(entry), k=k, ef=ef, max_steps=max_steps, N=N)
    return scores, ids


def _pq2_dist(lc, lr, codes64, ncodes64, norm2, ids):
    safe = ids.clamp(min=0).long()
    return norm2[safe] - 2.0 * (_adc(lc, codes64[safe]) + _adc(lr, ncodes64[safe]))


def _pq2_coarse_seeds(lutc, lutr, codes64, ncodes64, norm2, coarse_ids, n_seeds):
    ids = coarse_ids.long()[None].expand(lutc.shape[0], -1)
    dc = _pq2_dist(lutc, lutr, codes64, ncodes64, norm2, ids)   # (Q, C)
    _, top = _top_exact(-dc, n_seeds)
    return coarse_ids[top]


def _pq2_search_all(lutc, lutr, codes64, ncodes64, norm2, nbr0, nbru, seeds_all, *, entry, k,
                    ef, max_steps, N):
    def factory(ctx):
        lc, lr = ctx

        def dist_to(ids):
            return torch.where(ids >= 0, _pq2_dist(lc, lr, codes64, ncodes64, norm2, ids), INF)

        return dist_to

    search_all = make_hnsw_search(factory)
    return search_all((lutc, lutr), nbr0, nbru, entry, k, ef, max_steps, N, seeds_all)


def hnsw_descend_entries(
    vectors: torch.Tensor,   # (N, D)
    nbru: torch.Tensor,      # (L, N, m) int32, -1 padded
    entry: int,
    queries: torch.Tensor,   # (Q, D)
) -> torch.Tensor:
    """Greedy best-neighbour descent from ``entry`` through levels L-1..0 of
    ``nbru``; returns the (Q,) int32 level-0 entry points (the kernel's
    starts when an index has no coarse level to seed from)."""
    dist_to = _l2_dist_factory(vectors)(queries)
    point, _ = _descend(dist_to, nbru, entry, queries.shape[0], queries.device)
    return point.to(torch.int32)
