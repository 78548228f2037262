"""kNN-graph diffusion (random walk) re-ranking.

Port of ``image_search_engine_for_historical_research_tpu/rerank/diffusion.py``
(:33-520):

offline -- a kNN graph over the gallery, the mutual-kNN affinity
``relu(sims)^3``, the symmetric-normalized Laplacian ``I - alpha D^-1/2 A
D^-1/2`` with alpha=0.99, then for every gallery row a truncated conjugate
gradient solve ``L|_trunc x = e1`` (at most 20 iterations) over its support
(its ``T`` nearest rows). The solves of a batch of rows run together as one
batched CG; each system stops on its own, as under JAX's ``vmap`` of a
``while_loop`` (a converged row's state is frozen while the others go on).

online -- the query's ``k_query`` nearest gallery rows, their offline score
rows weighted by ``sims^3``, summed into a dense ``(Q, N)`` score matrix and
ranked.

Artifacts: ``DiffusionOffline`` is two dense arrays, ``trunc_ids`` int32 and
``scores`` f32 or f16, saved as the same ``npz`` the JAX package writes; a
file written by either package loads in the other.

Supports and kNN graphs are exact top-k on every device: the JAX package asks
for ``approximate=True`` (the TPU's ``approx_max_k``) on its large paths; on
the CPU that is the exact top-k in JAX too, and on the card the port's
``exact_topk`` is exact (unlike a TPU). Products of bf16 rows are scored in
f32 (``ops.topk._matmul_f32`` / ``_bmm_f32``), as JAX's
``preferred_element_type=float32``.

``mesh=`` (a ``parallel.data_mesh``) shards the build over the ranks, each of
which returns the same artifact: the self-kNN of the Laplacian and each
batch's support kNN run as ``parallel.sharded_exact_topk`` over the gallery's
rows when N divides the mesh, and each rank solves its slice of a batch's CG
systems when the batch's rows divide it (an all-gather joins the slices;
otherwise every rank solves the whole batch). The default solver stays
``"tables"`` above the regime when a mesh is given, as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import _bmm_f32, _top_exact, exact_topk
from ..parallel.mesh import full_rows, gather_rows, local_rows, mesh_size
from ..parallel.topk import sharded_exact_topk

GAMMA = 3          # affinity exponent
ALPHA = 0.99       # Laplacian alpha
CG_MAXITER = 20
CG_TOL = 1e-6

# the reference runs diffusion only below this gallery size (alphaQE alone
# above it); a larger artifact (~N*T*(4+2) bytes) must be asked for
DIFFUSION_REGIME_MAX = 120_000

# above this many gallery bytes the self-kNN loops query-row slices against
# one bf16 copy of the gallery instead of one call
KNN_GRAPH_ONECALL_BYTES = 3 << 30
KNN_GRAPH_QROWS = 8192

# the artifact's score dtypes (``score_dtype`` is a numpy dtype, as in JAX)
_TORCH_SCORE_DTYPE = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class DiffusionOffline:
    """Per-gallery-row truncated diffusion scores over their kNN supports.

    The arrays are torch tensors on a device, or numpy arrays on the host
    (``host_out=True``: the online pass then gathers only the query
    neighbours' rows on the host)."""

    trunc_ids: "np.ndarray | torch.Tensor"  # (N, T) int32
    scores: "np.ndarray | torch.Tensor"     # (N, T) float32 or float16

    @property
    def n(self) -> int:
        return self.trunc_ids.shape[0]

    @property
    def on_host(self) -> bool:
        return isinstance(self.trunc_ids, np.ndarray)

    def save(self, path: str, chunk_rows: int = 65536) -> None:
        """Write ``trunc_ids`` (int32) and ``scores`` to an ``npz``; device
        arrays come to the host in ``chunk_rows``-row slices."""

        def pull(a, dtype=None):
            if isinstance(a, np.ndarray):
                return a.astype(dtype) if dtype is not None else a
            out = None
            for s in range(0, a.shape[0], chunk_rows):
                piece = a[s:s + chunk_rows].cpu().numpy()
                if out is None:
                    out = np.empty(tuple(a.shape), dtype or piece.dtype)
                out[s:s + chunk_rows] = piece
            return out

        np.savez(path, trunc_ids=pull(self.trunc_ids, np.int32), scores=pull(self.scores))

    @classmethod
    def load(cls, path: str, to_device: bool = True, device="cuda") -> "DiffusionOffline":
        """Read an artifact; ``to_device`` puts it on ``device``, else it
        stays on the host as numpy arrays."""
        z = np.load(path)
        if to_device:
            dev = resolve_device(device)
            return cls(torch.as_tensor(z["trunc_ids"], device=dev),
                       torch.as_tensor(z["scores"], device=dev))
        return cls(z["trunc_ids"], z["scores"])


def _knn_graph(vecs: torch.Tensor, k: int):
    """(sims, ids) of the gallery against itself, self included at rank 0."""
    N, D = vecs.shape
    if N * D * vecs.element_size() <= KNN_GRAPH_ONECALL_BYTES:
        return exact_topk(vecs, vecs, k, metric="ip")
    db = vecs if vecs.dtype == torch.bfloat16 else vecs.to(torch.bfloat16)
    sims, ids = [], []
    for s in range(0, N, KNN_GRAPH_QROWS):
        sb, ib = exact_topk(db[s:s + KNN_GRAPH_QROWS], db, k, metric="ip",
                            approximate=True)
        sims.append(sb)
        ids.append(ib)
    return torch.cat(sims), torch.cat(ids)


def _mutual_mask(ids: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """``ismutual[i, m]``: i appears in ``ids[ids[i, m]]``; the self column
    0 is forced off. Chunked to bound the (chunk, kd, kd) gather."""
    N, kd = ids.shape
    out = torch.empty((N, kd), dtype=torch.bool, device=ids.device)
    for s in range(0, N, chunk):
        r = ids[s:s + chunk]
        me = torch.arange(s, s + r.shape[0], device=ids.device)[:, None, None]
        out[s:s + chunk] = (ids[r] == me).any(-1)
    out[:, 0] = False
    return out


def _laplacian_rows(vecs: torch.Tensor, kd: int, mesh=None):
    """Padded-row normalized Laplacian: (nbr (N, kd), val (N, kd)).

    Row i of L is ``1`` at i plus ``val[i, m]`` at column ``nbr[i, m]``
    (masked entries have val 0). ``mesh`` shards the self-kNN pass when
    the rows divide it."""
    if mesh is not None and vecs.shape[0] % mesh_size(mesh) == 0:
        return _laplacian_from_knn(*sharded_exact_topk(vecs, vecs, kd, mesh, metric="ip"))
    return _laplacian_from_knn(*_knn_graph(vecs, kd))


def _laplacian_from_knn(sims: torch.Tensor, ids: torch.Tensor):
    """``_laplacian_rows`` from a kNN graph already computed."""
    w = sims.clamp(min=0.0) ** GAMMA
    w = torch.where(_mutual_mask(ids), w, 0.0)   # directed entries i -> ids[i]
    # the affinity is symmetric in support and value, so degrees are row sums
    dinv = 1.0 / torch.sqrt(w.sum(1) + 1e-12)
    val = -ALPHA * w * dinv[:, None] * dinv[ids]
    return ids, val


def _threshold_laplacian_stats(sims: torch.Tensor, ids: torch.Tensor):
    """(thresh, dinv) for the recompute solver: ``u in knn(i)`` iff
    ``sim(i, u) >= thresh_i`` (the kd-th neighbour's sim), so the mutual test
    is one (N, kd) gather."""
    thresh = sims[:, -1]
    mutual = sims >= thresh[ids]
    mutual[:, 0] = False
    w = torch.where(mutual, sims.clamp(min=0.0) ** GAMMA, 0.0)
    return thresh, 1.0 / torch.sqrt(w.sum(1) + 1e-12)


def _batched_cg(matvec, b: torch.Tensor, tol: float = CG_TOL,
                maxiter: int = CG_MAXITER) -> torch.Tensor:
    """Conjugate gradient on a batch of systems ``A x = b`` (rows of ``b``),
    step for step as JAX's ``_cg_solve`` from ``x0 = 0``: each row runs while
    ``r.r > max(tol^2 b.b, 0)`` and fewer than ``maxiter`` steps were taken;
    a finished row's state is frozen (no further step can divide 0 by 0)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    gamma = (r * r).sum(1)
    atol2 = torch.clamp(tol * tol * (b * b).sum(1), min=0.0)
    active = gamma > atol2
    for _ in range(maxiter):
        if not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = gamma / (p * Ap).sum(1)
        x_ = x + alpha[:, None] * p
        r_ = r - alpha[:, None] * Ap
        gamma_ = (r_ * r_).sum(1)
        p_ = r_ + (gamma_ / gamma)[:, None] * p
        m = active[:, None]
        x = torch.where(m, x_, x)
        r = torch.where(m, r_, r)
        p = torch.where(m, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        active = active & (gamma > atol2)
    return x


def _knn_and_solve_vec(rows, vecs, thresh, dinv, k):
    """Support kNN of a batch of rows, then the truncated CG with each
    row's operator rebuilt from its support vectors (``G = V V^T``, mutual
    kNN by the kd-th-sim thresholds)."""
    _, tids = exact_topk(rows, vecs, k, metric="ip", approximate=True)
    B, T = tids.shape
    V = vecs[tids]                                           # (B, T, D)
    G = _bmm_f32(V, V)                                       # (B, T, T) f32
    del V
    tau = thresh[tids]
    mutual = (G >= tau[:, :, None]) & (G >= tau[:, None, :])
    mutual &= ~torch.eye(T, dtype=torch.bool, device=G.device)
    w = torch.where(mutual, G.clamp(min=0.0) ** GAMMA, 0.0)
    del G, mutual
    di = dinv[tids]
    S = (-ALPHA) * w * di[:, :, None] * di[:, None, :]
    del w
    # support[:, 0] is the row itself (the exact top-1), so b = e0
    b = torch.zeros((B, T), dtype=torch.float32, device=S.device)
    b[:, 0] = 1.0
    x = _batched_cg(lambda v: v + torch.bmm(S, v[:, :, None])[:, :, 0], b)
    return tids, x


def _batched_trunc_cg(lap_nbr, lap_val, trunc_ids):
    """Solve ``L|_s x = e1`` for every support row s of ``trunc_ids`` over
    the Laplacian's adjacency tables."""
    trunc_ids = trunc_ids.long()
    B, T = trunc_ids.shape
    kd = lap_nbr.shape[1]
    ss, order = torch.sort(trunc_ids, dim=1)             # sorted support (B, T)
    nbrs = lap_nbr[ss].reshape(B, T * kd)
    vals = lap_val[ss]                                   # (B, T, kd)
    pos = torch.searchsorted(ss, nbrs).clamp(0, T - 1)
    hit = ss.gather(1, pos) == nbrs
    loc = torch.where(hit, pos, T)                       # T = out of the support
    del nbrs, pos, hit
    zero = vals.new_zeros((B, 1))

    def matvec(v):
        vpad = torch.cat([v, zero], 1)
        return v + (vals * vpad.gather(1, loc).reshape(B, T, kd)).sum(2)

    b = torch.zeros((B, T), dtype=torch.float32, device=vals.device)
    b.scatter_(1, torch.searchsorted(ss, trunc_ids[:, :1].contiguous()), 1.0)
    x = _batched_cg(matvec, b)
    return torch.zeros_like(x).scatter_(1, order, x)     # back to trunc_ids order


def _knn_and_solve(rows, vecs, lap_nbr, lap_val, k, approx=False):
    """Support kNN of a batch of rows + the truncated CG over the tables."""
    _, tids = exact_topk(rows, vecs, k, metric="ip", approximate=approx)
    return tids, _batched_trunc_cg(lap_nbr, lap_val, tids)


def _sharded_cg(lap_nbr, lap_val, trunc_ids, mesh):
    """``_batched_trunc_cg`` with the batch's rows split over ``mesh``:
    each rank solves its slice (independent systems), an all-gather joins
    them."""
    local, _ = local_rows(trunc_ids, mesh)
    return gather_rows(_batched_trunc_cg(lap_nbr, lap_val, local), mesh)


def _knn_and_solve_sharded(rows, vecs, lap_nbr, lap_val, k, mesh):
    """``_knn_and_solve`` over a mesh: the support kNN by
    ``sharded_exact_topk`` over the gallery's rows, the CG systems split
    over the ranks when the batch's rows divide the mesh (else every rank
    solves them all)."""
    _, tids = sharded_exact_topk(rows, vecs, k, mesh, metric="ip")
    if rows.shape[0] % mesh_size(mesh) == 0:
        return tids, _sharded_cg(lap_nbr, lap_val, tids, mesh)
    return tids, _batched_trunc_cg(lap_nbr, lap_val, tids)


def budget_trunc_size(n: int, n_trunc: int, memory_budget_bytes: int, score_bytes: int = 2) -> int:
    """Largest support size T (multiple of 128, >= 128) whose (N, T)
    ids+scores artifact fits ``memory_budget_bytes`` (ids are int32)."""
    per_row = 4 + score_bytes
    t = memory_budget_bytes // (n * per_row)
    t = max(128, (t // 128) * 128)
    return min(n_trunc, t)


def build_diffusion_offline(
    vecs,
    n_trunc: int = 2000,
    kd: int = 50,
    batch: int = 256,
    host_out: Optional[bool] = None,
    score_dtype=None,
    memory_budget_bytes: Optional[int] = None,
    allow_large: bool = False,
    approx_support: Optional[bool] = None,
    progress_every: int = 0,
    solver: Optional[str] = None,
    mesh=None,
    stats: Optional[dict] = None,
) -> DiffusionOffline:
    """Gallery-side diffusion: the artifact for every gallery row.

    ``n_trunc`` is the truncated support size (reference: 2000), ``kd`` the
    affinity graph degree. The support kNN and the CG solves run per
    ``batch`` of gallery rows, so peak memory is the graph plus one batch.
    Above ``DIFFUSION_REGIME_MAX`` rows the build needs ``allow_large=True``
    (and should get a ``memory_budget_bytes``, which shrinks T); the artifact
    then goes to the host in float16 by default (``host_out``).

    ``solver``: ``"recompute"`` (the default above the regime) rebuilds each
    row's truncated operator from its support vectors with one batched
    product; ``"tables"`` (the default below it) walks the Laplacian's
    adjacency lists. ``approx_support`` is accepted for the JAX signature
    (supports are exact here).

    ``vecs`` is an (N, D) tensor; the work runs on its device. ``stats``,
    when a dict, receives the
    seconds of the kNN graph pass (``knn_s``) and of the batch sweep
    (``sweep_s``), each after a device synchronize, and with the recompute
    solver the graph itself (``knn``: sims and ids).

    ``mesh`` (a ``parallel.data_mesh``; ``TypeError`` for anything else)
    shards the kNN passes and the CG solves over its ranks, each of which
    gets the whole artifact (see the module docstring).
    """
    world = None
    if mesh is not None:
        world = mesh_size(mesh)
        vecs = full_rows(vecs)
    N = vecs.shape[0]
    if N > DIFFUSION_REGIME_MAX and not allow_large:
        raise ValueError(
            f"gallery of {N} rows exceeds the reference's diffusion regime "
            f"(<{DIFFUSION_REGIME_MAX}, Reranking.py:212 runs alphaQE only "
            "there). Pass allow_large=True plus memory_budget_bytes to build "
            "a truncated large-scale artifact anyway."
        )
    dev = vecs.device
    if host_out is None:
        host_out = N > DIFFUSION_REGIME_MAX
    if score_dtype is None:
        score_dtype = np.float16 if host_out else np.float32
    del approx_support  # exact supports on every device, see the module docstring
    if solver is None:
        solver = "recompute" if N > DIFFUSION_REGIME_MAX and mesh is None else "tables"
    if solver not in ("tables", "recompute"):
        raise ValueError(f"unknown solver: {solver!r}")

    T = min(n_trunc, N)
    if memory_budget_bytes is not None:
        T = budget_trunc_size(N, T, memory_budget_bytes, np.dtype(score_dtype).itemsize)
    kd = min(kd, N)

    t0 = time.perf_counter()
    if solver == "recompute":
        sims, ids = _knn_graph(vecs, kd)
        thresh, dinv = _threshold_laplacian_stats(sims, ids)
        if stats is not None:
            stats["knn"] = (sims, ids)
        del sims, ids
    else:
        lap_nbr, lap_val = _laplacian_rows(vecs, kd, mesh=mesh)
    _sync(dev)
    t1 = time.perf_counter()

    ids_out, sc_out = [], []
    tdtype = _TORCH_SCORE_DTYPE[np.dtype(score_dtype)]
    for start in range(0, N, batch):
        rows = vecs[start:start + batch]
        if solver == "recompute":
            tids, sc = _knn_and_solve_vec(rows, vecs, thresh, dinv, T)
        elif world is not None and N % world == 0:
            tids, sc = _knn_and_solve_sharded(rows, vecs, lap_nbr, lap_val, T, mesh)
        else:
            tids, sc = _knn_and_solve(rows, vecs, lap_nbr, lap_val, T)
        if host_out:
            ids_out.append(tids.cpu().numpy().astype(np.int32))
            sc_out.append(sc.cpu().numpy().astype(score_dtype))
        else:
            ids_out.append(tids.to(torch.int32))
            sc_out.append(sc.to(tdtype))
        if progress_every and (start // batch) % progress_every == 0:
            _sync(dev)
            print(f">> diffusion offline rows {min(start + batch, N)}/{N}", flush=True)
    cat = np.concatenate if host_out else torch.cat
    out = DiffusionOffline(trunc_ids=cat(ids_out, 0), scores=cat(sc_out, 0))
    _sync(dev)
    if stats is not None:
        stats.update(knn_s=t1 - t0, sweep_s=time.perf_counter() - t1, T=T, solver=solver)
    return out


def _scatter_rows(ids, vals, wq, n):
    """(Q, k, T) gathered offline rows -> dense (Q, n) weighted sum (f32)."""
    Q = ids.shape[0]
    dense = torch.zeros((Q, n), dtype=torch.float32, device=wq.device)
    contrib = vals.float() * wq[:, :, None]
    return dense.scatter_add_(1, ids.reshape(Q, -1).long(), contrib.reshape(Q, -1))


def diffusion_online_scores(offline_ids, offline_scores, vecs, qvecs, k_query: int = 3):
    """Dense (Q, N) diffusion scores for queries against a device artifact."""
    qsims, qids = exact_topk(qvecs, vecs, k_query, metric="ip")
    wq = qsims.clamp(min=0.0) ** GAMMA
    return _scatter_rows(offline_ids[qids], offline_scores[qids], wq, vecs.shape[0])


def diffusion_online_scores_hosted(offline: DiffusionOffline, vecs, qvecs, k_query: int = 3):
    """Online diffusion against a host artifact: only the Q * k_query
    neighbour rows go to the device."""
    qsims, qids = exact_topk(qvecs, vecs, k_query, metric="ip")
    wq = qsims.clamp(min=0.0) ** GAMMA
    qids_h = qids.cpu().numpy()
    ids = torch.as_tensor(np.asarray(offline.trunc_ids[qids_h], np.int32), device=vecs.device)
    vals = torch.as_tensor(np.asarray(offline.scores[qids_h]), device=vecs.device)
    return _scatter_rows(ids, vals, wq, vecs.shape[0])


def diffusion_rerank(
    vecs,
    qvecs,
    offline: Optional[DiffusionOffline] = None,
    n_trunc: int = 2000,
    kd: int = 50,
    k_query: int = 3,
    truncation: Optional[int] = None,
    **build_kwargs,
):
    """The whole random-walk pass: returns (ranks (Q, R), offline) with R =
    ``truncation`` (default ``n_trunc``) ids ranked by diffusion score. Extra
    keywords go to ``build_diffusion_offline``."""
    N = vecs.shape[0]
    if offline is None:
        offline = build_diffusion_offline(vecs, n_trunc=n_trunc, kd=kd, **build_kwargs)
    if offline.on_host:
        scores = diffusion_online_scores_hosted(offline, vecs, qvecs, k_query=k_query)
    else:
        scores = diffusion_online_scores(offline.trunc_ids, offline.scores, vecs, qvecs,
                                         k_query=k_query)
    R = min(truncation or n_trunc, N)
    return _top_exact(scores, R)[1], offline
