"""Random-projection forest: the ANNOY-class index, built and searched on the card.

Port of ``image_search_engine_for_historical_research_tpu/index/rpforest.py``
(:36-356): ``_median_split_level``, ``_build_tree``,
``_descend``, ``RPForestIndex`` (kind ``rpforest``), ``_rerank_candidates``
and ``build_rpforest``. Every tree is a balanced tree of median splits, so
its structure is implicit (all leaves at one depth) and a level is a fixed
number of array passes:

- each segment picks a hyperplane, the difference of two random members (the
  first index that reaches its segment's largest random score), or a normal
  draw where the two coincide; its members' projections are split at the
  segment median (a stable sort by segment, then by projection);
- leaves are equal-size slices of a permutation: a dense ``(T, L, leaf_max)``
  int32 table, -1 padded;
- a search descends every tree (``depth`` gather + dot steps), gathers the
  union of the reached leaves and re-ranks it exactly, in query chunks that
  keep the gathered ``(chunk, T * leaf_max, D)`` block near 1 GB (never all
  queries at once: 34 GB for 70 queries at 1M x 2048 and 100 trees).

The random draws are host generators' behind one seam, ``_level_draws``
(per tree and level: two uniform member scores and a normal plane), which
the tests route through JAX's keys. Planes are stored in bf16 and persisted
as a uint16 bit-cast (``planes_bf16``); legacy f32 ``planes`` load too.
Every top-k is ``ops.topk._top_exact`` (``lax.top_k``'s ties).

``build_rpforest(mesh=)`` shards the trees over a ``parallel.data_mesh`` in
contiguous blocks (the count padded to a multiple of the world size with
copies of tree 0, as JAX pads its keys): each rank builds its own trees from
the same per-tree draws, so no collective runs until one all-gather of the
f32 planes, the thresholds and the leaf assignments, and every rank's forest
equals the unsharded one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import _top_exact
from .base import StageClock, normalize_rows, register
from .flat import _bf16_to_bits, _bits_to_bf16

PROJ_CHUNK = 131072   # rows a level projects at once (a (chunk, D) f32 gather)
GATHER_BYTES = 1 << 28  # the candidate block a query chunk gathers, f32 elements


def _level_draws(seed: int, n_trees: int, tree: int, level: int, N: int, n_segs: int,
                 D: int):
    """The random draws of one tree level, from a host generator seeded by
    ``(seed, tree, level)``: ``(r_a (N,), r_b (N,), noise (n_segs, D))``,
    f32 on the CPU (JAX ``rpforest.py:42-60``: two member scores and the
    plane that replaces a degenerate one). ``n_trees`` is unused here (a
    forest is a prefix of a larger one); JAX's keys depend on it."""
    del n_trees
    state = np.random.SeedSequence([seed, tree, level]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state))
    r_a = torch.rand(N, generator=g)
    r_b = torch.rand(N, generator=g)
    return r_a, r_b, torch.randn(n_segs, D, generator=g)


def _median_split_level(x: torch.Tensor, seg_id: torch.Tensor, n_segs: int, draws):
    """One level: per-segment hyperplane and median split (JAX :36-95).
    Returns ``(planes (n_segs, D), thresholds (n_segs,), new seg_id)``."""
    N, D = x.shape
    dev = x.device
    r_a, r_b, noise = (d.to(dev) for d in draws)
    iota = torch.arange(N, device=dev)

    def seg_pick(r):
        # the first index reaching its segment's max score (empty segments: N)
        seg_max = torch.full((n_segs,), float("-inf"), device=dev)
        seg_max = seg_max.scatter_reduce(0, seg_id, r, "amax")
        idx = torch.where(r >= seg_max[seg_id] - 1e-12, iota, N)
        return torch.full((n_segs,), N, device=dev).scatter_reduce(0, seg_id, idx, "amin")

    a = seg_pick(r_a).clamp(0, N - 1)
    b = seg_pick(r_b).clamp(0, N - 1)
    planes = x[a] - x[b]
    degenerate = (planes == 0).all(dim=1, keepdim=True)
    planes = torch.where(degenerate, noise, planes)

    # chunked projection: planes[seg_id] whole is an (N, D) gather; the last
    # chunk's start is clamped to N - chunk, as in JAX
    chunk = min(PROJ_CHUNK, N)
    proj = torch.zeros(N, device=dev)
    for i in range(-(-N // chunk)):
        s = min(i * chunk, N - chunk)
        proj[s:s + chunk] = (x[s:s + chunk] * planes[seg_id[s:s + chunk]]).sum(dim=1)

    # rank within segment: a stable sort by (segment, projection)
    by_proj = torch.argsort(proj, stable=True)
    order = by_proj[torch.argsort(seg_id[by_proj], stable=True)]
    seg_sizes = torch.bincount(seg_id, minlength=n_segs)
    seg_starts = torch.cumsum(seg_sizes, 0) - seg_sizes
    ranks = torch.empty(N, dtype=torch.long, device=dev)
    ranks[order] = iota - seg_starts[seg_id[order]]
    go_right = ranks >= (seg_sizes[seg_id] + 1) // 2

    # threshold: the projection of the segment's first right-going item
    big = torch.where(go_right, proj, float("inf"))
    thresholds = torch.full((n_segs,), float("inf"), device=dev)
    thresholds = thresholds.scatter_reduce(0, seg_id, big, "amin")
    thresholds = torch.where(torch.isfinite(thresholds), thresholds, 0.0)
    return planes, thresholds, seg_id * 2 + go_right.long()


def _build_tree(x: torch.Tensor, depth: int, seed: int, n_trees: int, tree: int):
    """One balanced tree (JAX :98-116): ``(planes (2^depth - 1, D),
    thresholds (2^depth - 1,), leaf id per row (N,))``, levels in
    complete-tree order."""
    N, D = x.shape
    seg_id = torch.zeros(N, dtype=torch.long, device=x.device)
    planes_all, thr_all = [], []
    for d in range(depth):
        draws = _level_draws(seed, n_trees, tree, d, N, 1 << d, D)
        planes, thr, seg_id = _median_split_level(x, seg_id, 1 << d, draws)
        planes_all.append(planes)
        thr_all.append(thr)
    return torch.cat(planes_all), torch.cat(thr_all), seg_id


def _descend(planes: torch.Tensor, thresholds: torch.Tensor, queries: torch.Tensor,
             depth: int) -> torch.Tensor:
    """Root-to-leaf descent (JAX :119-130): ``(T, nodes, D)`` planes and
    ``(Q, D)`` queries -> leaf ids ``(Q, T)``."""
    T = planes.shape[0]
    Q = queries.shape[0]
    trees = torch.arange(T, device=queries.device)
    node = torch.zeros((Q, T), dtype=torch.long, device=queries.device)
    for d in range(depth):
        flat = (1 << d) - 1 + node                               # (Q, T) node slots
        p = planes[trees[None, :], flat].float()                # (Q, T, D)
        t = thresholds[trees[None, :], flat]
        proj = torch.bmm(p, queries[:, :, None])[..., 0]
        node = node * 2 + (proj > t).long()
    return node


def _rerank_candidates(vectors, leaf_items, leaf, queries, k: int):
    """Gather each query's ``T`` leaves and score the union exactly (JAX
    :219-254): invalid (-1) and repeated candidates (all but the first
    occurrence) score -inf; a union shorter than ``k`` is padded with the
    best id at -inf."""
    Q, T = leaf.shape
    trees = torch.arange(T, device=leaf.device)
    cand = leaf_items[trees[None, :], leaf].reshape(Q, -1).long()   # (Q, C)
    valid = cand >= 0
    s = torch.bmm(vectors[cand.clamp(min=0)], queries[:, :, None])[..., 0]
    order = torch.argsort(cand, dim=1, stable=True)
    sorted_c = cand.gather(1, order)
    dup_sorted = torch.zeros_like(valid)
    dup_sorted[:, 1:] = sorted_c[:, 1:] == sorted_c[:, :-1]
    dup = torch.zeros_like(valid).scatter(1, order, dup_sorted)
    s = torch.where(valid & ~dup, s, float("-inf"))
    kk = min(k, s.shape[1])
    top_s, sel = _top_exact(s, kk)
    top_i = cand.gather(1, sel)
    if kk < k:
        top_s = torch.cat([top_s, top_s.new_full((Q, k - kk), float("-inf"))], 1)
        top_i = torch.cat([top_i, top_i[:, :1].expand(Q, k - kk)], 1)
    return top_s, top_i


@register("rpforest")
@dataclass
class RPForestIndex:
    vectors: torch.Tensor     # (N, D) f32, normalized
    planes: torch.Tensor      # (T, 2^depth - 1, D) bf16
    thresholds: torch.Tensor  # (T, 2^depth - 1) f32
    leaf_items: torch.Tensor  # (T, 2^depth, leaf_max) int32, -1 padded
    depth: int

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def search(self, queries, k: int,
               query_chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Descend all trees, union the leaves, re-rank the union exactly.
        Queries go in chunks of ``max(8, 2^28 // (T * leaf_max * D))``, so
        the gathered candidate block stays near 1 GB in f32. JAX pads the
        last chunk with the first query (one compiled shape); here it is
        shorter instead, which gives the same ids without the padding's
        work (one query would otherwise gather eight queries' leaves)."""
        q = normalize_rows(torch.as_tensor(queries, dtype=torch.float32, device=self.device))
        Q = q.shape[0]
        if Q == 0:
            return (torch.zeros((0, k), device=self.device),
                    torch.zeros((0, k), dtype=torch.long, device=self.device))
        cand = self.leaf_items.shape[0] * self.leaf_items.shape[2]
        if query_chunk is None:
            query_chunk = max(8, GATHER_BYTES // max(cand * self.vectors.shape[1], 1))
        out_s, out_i = [], []
        for s in range(0, Q, query_chunk):
            qc = q[s:s + query_chunk]
            leaf = _descend(self.planes, self.thresholds, qc, self.depth)
            sc, ix = _rerank_candidates(self.vectors, self.leaf_items, leaf, qc, k)
            out_s.append(sc)
            out_i.append(ix)
        return torch.cat(out_s), torch.cat(out_i)

    def to_arrays(self):
        # planes persist as a uint16 bit-cast of their bf16 storage
        return (
            {"depth": self.depth},
            {
                "vectors": self.vectors.float().cpu().numpy(),
                "planes_bf16": _bf16_to_bits(self.planes),
                "thresholds": self.thresholds.float().cpu().numpy(),
                "leaf_items": self.leaf_items.cpu().numpy().astype(np.int32),
            },
        )

    @classmethod
    def from_arrays(cls, meta, arrays, device="cuda"):
        dev = resolve_device(device)
        if "planes_bf16" in arrays:
            planes = _bits_to_bf16(arrays["planes_bf16"])
        else:  # legacy f32 saves
            planes = torch.as_tensor(np.asarray(arrays["planes"], np.float32)).to(torch.bfloat16)
        return cls(
            vectors=torch.as_tensor(np.asarray(arrays["vectors"], np.float32), device=dev),
            planes=planes.to(dev),
            thresholds=torch.as_tensor(np.asarray(arrays["thresholds"], np.float32), device=dev),
            leaf_items=torch.as_tensor(np.asarray(arrays["leaf_items"], np.int32), device=dev),
            depth=int(meta["depth"]),
        )


def _build_trees(v, depth: int, seed: int, n_trees: int, trees, plane_dtype):
    """``_build_tree`` of each tree index in ``trees``: lists of planes (in
    ``plane_dtype``), thresholds and leaf ids."""
    planes_l, thr_l, assign_l = [], [], []
    for t in trees:
        planes, thr, leaf_assign = _build_tree(v, depth, seed, n_trees, t)
        planes_l.append(planes.to(plane_dtype))
        thr_l.append(thr)
        assign_l.append(leaf_assign)
    return planes_l, thr_l, assign_l


def _build_trees_sharded(v, depth: int, seed: int, n_trees: int, mesh):
    """``_build_trees`` of every tree, built in contiguous blocks over
    ``mesh``'s ranks and all-gathered with f32 planes, the padding trees
    (copies of tree 0) dropped; the planes cast to bf16 after the gather."""
    from ..parallel.mesh import gather_rows, mesh_size

    per = -(-n_trees // mesh_size(mesh))
    start = mesh.get_local_rank("data") * per
    mine = [t if t < n_trees else 0 for t in range(start, start + per)]
    planes, thr, assign = (gather_rows(torch.stack(a), mesh)[:n_trees]
                           for a in _build_trees(v, depth, seed, n_trees, mine, torch.float32))
    return list(planes.to(torch.bfloat16)), list(thr), list(assign)


def build_rpforest(vecs, n_trees: int = 100, leaf_size: int = 512, seed: int = 42,
                   normalize: bool = True, device="cuda",
                   stats: Optional[dict] = None, mesh=None) -> RPForestIndex:
    """Build the forest on ``device`` (JAX :257-356; the reference's 100
    trees, and leaf 512, the JAX package's measured recall-vs-memory point).
    Rows are kept in f32, as JAX keeps them; planes are stored in bf16.
    ``stats``, when given, receives the stage seconds (``trees``, ``leaves``).
    ``mesh`` (a ``parallel.data_mesh``) shards the trees over its ranks."""
    dev = resolve_device(device)
    clock = StageClock(stats, dev)
    if mesh is not None:
        from ..parallel.mesh import full_rows

        vecs = full_rows(vecs)
    v = torch.as_tensor(vecs, device=dev).float()
    if normalize:
        v = normalize_rows(v)
    N = v.shape[0]
    depth = max(1, int(math.ceil(math.log2(max(N / leaf_size, 2)))))
    n_leaves = 1 << depth

    # bf16 plane storage: a split compares a projection with a threshold,
    # and bf16 rounding moves only points already on the boundary
    if mesh is None:
        planes_l, thr_l, assign_l = _build_trees(v, depth, seed, n_trees, range(n_trees),
                                                 torch.bfloat16)
    else:
        planes_l, thr_l, assign_l = _build_trees_sharded(v, depth, seed, n_trees, mesh)
    clock.tick("trees")

    # leaf tables: rows of each leaf in row order, width = the largest leaf
    counts = torch.stack([torch.bincount(a, minlength=n_leaves) for a in assign_l])
    leaf_max = int(counts.max())
    leaf_items = torch.full((n_trees, n_leaves, leaf_max), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(N, device=dev)
    for t, a in enumerate(assign_l):
        order = torch.argsort(a, stable=True)
        leaf = a[order]
        starts = torch.cumsum(counts[t], 0) - counts[t]
        leaf_items[t, leaf, iota - starts[leaf]] = order.to(torch.int32)
    clock.tick("leaves")
    return RPForestIndex(vectors=v, planes=torch.stack(planes_l),
                         thresholds=torch.stack(thr_l), leaf_items=leaf_items, depth=depth)
