"""Product quantization: codebook training, encoding, asymmetric-distance scan.

Port of ``image_search_engine_for_historical_research_tpu/ops/pq.py``:
``PQCodebook``, ``train_indices``, ``pq_train``, ``opq_train``,
``pq_encode``, ``pq_decode``, ``pq_dist_table``,
``pq_ip_table``, ``pq_refine_rerank``, ``pq_pack4`` / ``pq_unpack4`` and
``pq_search``. Train M sub-codebooks with k-means, encode rows to ``(N, M)``
codes, and at query time build a ``(Q, M, Ks)`` LUT and accumulate each
row's entries, streamed in chunks with a running top-k.

- **Codes.** Stored in the JAX package's dtype (uint8 up to Ks=256, uint16 up
  to 65,536, int32 above), so artifacts are the same arrays both ways. Torch's
  uint16 supports few ops, so uint16 codes are written, gathered, copied and
  widened through an int16 view (``codes_long``, ``take_code_rows``,
  ``cat_codes``, ``codes_to_numpy``, ``codes_from_numpy``) and used as int64.
- **Fits.** The M subspaces of a fit go through ``_subspace_fits``, the one
  place where a PQ fit draws its randomness: one batched fit
  (``ops.kmeans.kmeans_fit_batched``), subspace ``m`` drawing from its own
  host generator seeded by ``ops.kmeans.subspace_seed(seed, m)``. JAX fits
  the subspaces one after another; the port runs their k-means++ steps and
  Lloyd iterations together. ``train_indices`` is the JAX package's numpy
  rule, copied exactly.
- **Sharded fits.** With ``mesh=`` (a ``parallel.data_mesh``), ``pq_train``
  runs the batched fit with its rows sharded (``ops.kmeans.fit_sharded``)
  when the fit rows divide the mesh, and on each rank alone otherwise,
  without a word, as JAX does; ``opq_train`` rounds its two samples down to
  a multiple of the world size (never below it), so ``mesh=`` changes the
  sample in both packages.
- **The ADC scan.** ``method="gather"`` gathers each subspace's LUT entries
  by code (``adc``, which the PQ graph walks and the IVF probe use too);
  ``"onehot"`` is the JAX package's one-hot matmul (exact: the same numbers)
  and ``"auto"`` takes the gather, the natural form on the card. The sum over
  subspaces runs m = 0..M-1, as the JAX loop does.
- **Refine re-rank.** Every codes-only re-rank scores its reconstructions
  through ``rerank_reconstructed``.
- **Ties.** Rows that share a code score exactly equal. Every top-k here is
  ``ops.topk._top_exact``: ``lax.top_k``'s choice (the lowest ids) at the k-th
  place, lower id first in the output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .kmeans import fit_sharded, kmeans_fit_batched, shared_draws, subspace_seed
from .topk import _bmm_f32, _top_exact


class PQCodebook(NamedTuple):
    """Codewords ``(M, Ks, ds)`` for M subspaces of width ds = D // M.

    ``rotation`` (optional, (D, D) orthogonal) makes this an OPQ codebook:
    vectors are rotated before sub-quantization; encode, decode and the LUTs
    apply and undo it, so every consumer works unchanged."""

    codewords: torch.Tensor
    rotation: Optional[torch.Tensor] = None

    @property
    def M(self):
        return self.codewords.shape[0]

    @property
    def Ks(self):
        return self.codewords.shape[1]

    @property
    def ds(self):
        return self.codewords.shape[2]

    @classmethod
    def from_numpy(cls, codewords, rotation=None, device="cpu"):
        """A codebook from numpy arrays (an artifact's, or the JAX package's)."""
        cw = torch.as_tensor(np.asarray(codewords, np.float32), device=device)
        rot = (torch.as_tensor(np.asarray(rotation, np.float32), device=device)
               if rotation is not None else None)
        return cls(cw, rot)


LARGE_KS = 2048  # above this, default to bf16 assignment matmuls + subsampled fit


def code_dtype(Ks: int) -> torch.dtype:
    """The code dtype for a codebook of ``Ks`` words (the JAX package's)."""
    return torch.uint8 if Ks <= 256 else torch.uint16 if Ks <= 65536 else torch.int32


def codes_long(codes: torch.Tensor) -> torch.Tensor:
    """Codes of any storage dtype as int64."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).long() & 0xFFFF
    return codes.long()


def take_code_rows(codes: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``codes[rows]`` as int64 (uint16 rows are gathered as int16)."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16)[rows.long()].long() & 0xFFFF
    return codes[rows.long()].long()


def cat_codes(parts) -> torch.Tensor:
    """Concatenate code pieces along rows (uint16 through an int16 view)."""
    if len(parts) == 1:
        return parts[0]
    if parts[0].dtype == torch.uint16:
        return torch.cat([p.view(torch.int16) for p in parts]).view(torch.uint16)
    return torch.cat(parts)


def codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """Codes as a host array in their own dtype (an artifact's)."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).cpu().numpy().view(np.uint16)
    return codes.cpu().numpy()


def codes_from_numpy(codes, device) -> torch.Tensor:
    """Host codes in their own dtype on ``device``."""
    a = np.ascontiguousarray(codes)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.uint16)
    return torch.as_tensor(a, device=device)


def train_indices(n_rows: int, n_sample: int, seed: int) -> np.ndarray:
    """The fit-row sampling rule of the JAX package: a sorted no-replacement
    choice from ``np.random.RandomState(seed)``. Shared by ``pq_train``,
    ``opq_train`` and the streaming builders, so a streamed fit sees the rows
    an in-memory fit sees."""
    return np.sort(np.random.RandomState(seed).choice(n_rows, n_sample, replace=False))


def _rows(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[torch.as_tensor(idx, device=x.device)]


def _subspace_fits(fit_vecs, Ks, iters, seed, M, matmul_dtype=None, init="kmeans++",
                   mesh=None):
    """The ``(M, Ks, ds)`` f32 centres of the M subspaces of ``fit_vecs
    (N, M * ds)``, fitted together (``kmeans_fit_batched`` over a strided
    ``(M, N, ds)`` view), subspace ``m`` seeded by ``subspace_seed(seed, m)``.
    With ``mesh``, the same fits with the rows sharded over it
    (``ops.kmeans.fit_sharded``: the same initial centres, the sums
    all-reduced)."""
    N, D = fit_vecs.shape
    sub = fit_vecs.reshape(N, M, D // M).transpose(0, 1)
    if mesh is not None:
        seeds = [subspace_seed(seed, m) for m in range(M)]
        return fit_sharded(sub, Ks, seeds, mesh, iters, matmul_dtype=matmul_dtype, init=init)[0]
    centers, _ = kmeans_fit_batched(sub, Ks, iters, seed=seed, matmul_dtype=matmul_dtype,
                                    init=init)
    return centers


def pq_train(
    vecs: torch.Tensor,
    M: int = 16,
    Ks: int = 256,
    iters: int = 20,
    seed: int = 42,
    train_sample: Optional[int] = None,
    matmul_dtype=None,
    mesh=None,
) -> PQCodebook:
    """Fit the M sub-codebooks, all subspaces together (``_subspace_fits``).
    Above ``LARGE_KS`` the fit defaults to bf16 assignment matmuls,
    a ``max(65536, 32 * Ks)``-row training subsample and the ``"points"``
    init; all three can be overridden. The full data is encoded exactly
    afterwards by ``pq_encode``. ``mesh`` shards the fit's rows when they
    divide it (``_subspace_fits``)."""
    N, D = vecs.shape
    if D % M:
        raise ValueError(f"dim {D} not divisible by M={M}")
    ds = D // M
    init = "kmeans++"
    if matmul_dtype is None and Ks > LARGE_KS:
        matmul_dtype = torch.bfloat16
    if Ks > LARGE_KS:
        if train_sample is None:
            train_sample = max(65536, 32 * Ks)
        init = "points"
    fit_vecs = vecs
    if train_sample is not None and train_sample < N:
        fit_vecs = _rows(vecs, train_indices(N, train_sample, seed))
    if mesh is not None:
        from ..parallel.mesh import mesh_size

        if fit_vecs.shape[0] % mesh_size(mesh):
            mesh = None                 # rows that do not divide: one fit a rank, as JAX
    return PQCodebook(codewords=_subspace_fits(fit_vecs, Ks, iters, seed, M, matmul_dtype, init,
                                               mesh=mesh))


def _procrustes(m: torch.Tensor) -> torch.Tensor:
    """``U V^T`` of the SVD of ``m``: the orthogonal Procrustes rotation. On
    the card through cuSOLVER's QR-based ``gesvd``: torch's default there,
    the Jacobi ``gesvdj``, is slower on OPQ's (D, D) matrices and returns a
    rotation further from orthogonal."""
    u, _, vt = torch.linalg.svd(m, full_matrices=False, driver="gesvd" if m.is_cuda else None)
    return u @ vt


def opq_train(
    vecs: torch.Tensor,
    M: int = 16,
    Ks: int = 256,
    iters: int = 20,
    opq_iters: int = 10,
    seed: int = 42,
    train_sample: Optional[int] = None,
    mesh=None,
) -> PQCodebook:
    """OPQ: alternate PQ fits with an orthogonal Procrustes rotation update
    (Ge et al., CVPR'13, the non-parametric solution).

    Each round fits sub-codebooks on the rotated training rows,
    reconstructs them, and sets ``R = U V^T`` from the SVD of ``X^T X_hat``.
    The rotation is learnt on ``min(N, max(16384, 8 * Ks))`` rows with short
    inner fits; the returned codebook is a full-``iters`` fit on
    ``min(N, max(16384, 16 * Ks))`` rows (its own sample, rotated a piece at
    a time into one buffer), unless ``train_sample`` fixes both. With
    ``mesh``, both samples are rounded down to a multiple of the world size
    (never below it) and every fit is sharded."""
    v = vecs.float()
    N, D = v.shape
    if D % M:
        raise ValueError(f"dim {D} not divisible by M={M}")
    world = 1
    if mesh is not None:
        from ..parallel.mesh import mesh_size

        world = mesh_size(mesh)
    ts = train_sample if train_sample is not None else min(N, max(16384, 8 * Ks))
    ts = max(world, ts // world * world)
    x = _rows(v, train_indices(N, ts, seed)) if ts < N else v
    R = torch.eye(D, dtype=torch.float32, device=v.device)
    inner = max(4, iters // 3)
    with shared_draws():                  # every fit below draws the same numbers
        for _ in range(opq_iters):
            xr = x @ R
            cb = pq_train(xr, M=M, Ks=Ks, iters=inner, seed=seed, mesh=mesh)
            xhat = pq_decode(cb, pq_encode(cb, xr))        # rotated space
            del xr
            R = _procrustes(x.T @ xhat)
            del xhat
        fs = train_sample if train_sample is not None else min(N, max(16384, 16 * Ks))
        fs = max(world, fs // world * world)
        if fs <= ts:
            xr = x @ R
            del x
        else:
            del x
            fidx = train_indices(N, fs, seed + 7)
            xr = torch.empty((fs, D), dtype=torch.float32, device=v.device)
            step = 65536
            for s in range(0, fs, step):
                xr[s:s + step] = _rows(v, fidx[s:s + step]) @ R
        cb = pq_train(xr, M=M, Ks=Ks, iters=iters, seed=seed, mesh=mesh)
    return PQCodebook(codewords=cb.codewords, rotation=R)


def pq_encode(
    codebook: PQCodebook,
    vecs: torch.Tensor,
    chunk: int = 131072,
    matmul_dtype=None,
) -> torch.Tensor:
    """Encode rows to ``(N, M)`` nearest-codeword ids (``code_dtype(Ks)``),
    streamed over row chunks that shrink with ``M * Ks`` so the
    ``(chunk, M, Ks)`` distance block stays bounded."""
    N, D = vecs.shape
    M, Ks, ds = codebook.codewords.shape
    if matmul_dtype is None and Ks > LARGE_KS:
        matmul_dtype = torch.bfloat16
    dtype = code_dtype(Ks)
    cw32 = codebook.codewords.float()
    c2 = (cw32 ** 2).sum(2)                                    # (M, Ks)
    cw = codebook.codewords.to(matmul_dtype) if matmul_dtype is not None else cw32

    chunk = min(chunk, max(128, (1 << 28) // (M * Ks)))
    chunk = min(chunk, ((N + 127) // 128) * 128)
    out = torch.empty((N, M), dtype=torch.int16 if dtype == torch.uint16 else dtype,
                      device=vecs.device)
    for s in range(0, N, chunk):
        xcb = vecs[s:s + chunk]
        if codebook.rotation is not None:
            xcb = xcb.float() @ codebook.rotation
        sub = xcb.reshape(-1, M, ds).transpose(0, 1)           # (M, c, ds)
        if matmul_dtype is not None:
            sub = sub.to(matmul_dtype)
        dots = _bmm_f32(sub, cw)                               # (M, c, Ks)
        ids = torch.argmin(dots.mul_(-2.0).add_(c2[:, None, :]), dim=2).T
        out[s:s + chunk] = ids.to(out.dtype)
    return out.view(torch.uint16) if dtype == torch.uint16 else out


def pq_decode(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct ``(N, D)`` f32 rows from codes; OPQ codebooks un-rotate,
    so the output is always in the original space."""
    M, Ks, ds = codebook.codewords.shape
    flat = codebook.codewords.float().reshape(M * Ks, ds)
    offs = torch.arange(M, device=codes.device) * Ks
    out = flat[codes_long(codes) + offs].reshape(codes.shape[0], M * ds)
    if codebook.rotation is not None:
        out = out @ codebook.rotation.T
    return out


def _rotated_subqueries(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """``(M, Q, ds)`` f32 query slices in the codebook's (rotated) space."""
    q = queries.float()
    if codebook.rotation is not None:
        q = q @ codebook.rotation
    M, _, ds = codebook.codewords.shape
    return q.reshape(q.shape[0], M, ds).transpose(0, 1)


def pq_dist_table(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Per-query asymmetric LUT: ``(Q, M, Ks)`` squared distances to the
    codewords."""
    qs = _rotated_subqueries(codebook, queries)                # (M, Q, ds)
    cw = codebook.codewords.float()
    dots = torch.bmm(qs, cw.transpose(1, 2))                   # (M, Q, Ks)
    c2 = (cw ** 2).sum(2)                                      # (M, Ks)
    q2 = (qs ** 2).sum(2)                                      # (M, Q)
    return (q2[:, :, None] - 2.0 * dots + c2[:, None, :]).transpose(0, 1)


def pq_ip_table(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product LUT: ``(Q, M, Ks)`` values of ``q_m . c``.
    Summing ``lut[m, code[m]]`` gives ``q . decode(code)``; tables of two
    codebooks (coarse and residual) add to the inner product with a
    two-level reconstruction."""
    qs = _rotated_subqueries(codebook, queries)
    return torch.bmm(qs, codebook.codewords.float().transpose(1, 2)).transpose(0, 1)


def pq_refine_rerank(
    cb: PQCodebook,
    coarse_codes: torch.Tensor,   # (Nc, M) rows indexed by cand_code_rows
    rcb: PQCodebook,
    refine_codes: torch.Tensor,   # (N, Mr) rows indexed by cand_ids
    q: torch.Tensor,              # (Q, D)
    cand_code_rows: torch.Tensor,  # (Q, E) rows into coarse_codes
    cand_ids: torch.Tensor,        # (Q, E) image ids (into refine_codes)
    valid: torch.Tensor,           # (Q, E) bool
    k: int,
):
    """Codes-only re-rank: reconstruct candidates as
    ``decode(coarse) + decode(residual)`` and order them by exact distance
    to ``q`` (Jegou et al., ICASSP'11). Scores are ``2 q.x - ||x||^2``
    (larger is better); returns ``(scores (Q, k), ids (Q, k))``."""
    Q, E = cand_ids.shape
    cc = take_code_rows(coarse_codes, cand_code_rows.reshape(-1))
    rc = take_code_rows(refine_codes, cand_ids.reshape(-1))
    recon = (pq_decode(cb, cc) + pq_decode(rcb, rc)).reshape(Q, E, -1)
    return rerank_reconstructed(q, recon, cand_ids, valid, k)


def rerank_reconstructed(q, recon, cand_ids, valid, k: int):
    """The best ``k`` of ``Q x E`` reconstructed candidates ``recon (Q, E,
    D)`` by ``2 q.x - ||x||^2`` (larger is better; invalid slots never
    win): ``(scores (Q, k), ids (Q, k))`` with ids from ``cand_ids``. The
    score of every codes-only re-rank (PQ, HNSW-PQ and IVF-PQ)."""
    s = 2.0 * torch.bmm(recon, q.float()[:, :, None])[:, :, 0] - (recon * recon).sum(-1)
    s = torch.where(valid, s, float("-inf"))
    top_s, top_j = _top_exact(s, k)
    return top_s, cand_ids.gather(1, top_j)


def pq_pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes (values < 16) two a byte: ``(N, M) -> (N, M/2)``
    uint8 (the Quick-ADC geometry at half the bytes)."""
    if codes.shape[1] % 2:
        raise ValueError("M must be even to pack 4-bit codes")
    lo = codes[:, 0::2].to(torch.uint8)
    hi = codes[:, 1::2].to(torch.uint8)
    return lo | (hi << 4)


def pq_unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pq_pack4``: ``(N, M/2)`` uint8 -> ``(N, M)`` uint8."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)


def adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC distances from ``lut (B, M, Ks)``: int64 ``codes (B, n, M)`` (a
    set per LUT row) or ``(n, M)`` (one set for every row) give ``(B, n)``,
    the sum over m = 0..M-1, in that order, of ``lut[b, m, code[m]]``. One
    gather from the flattened LUT, subspace-major so each term is a
    contiguous slice."""
    B, M, Ks = lut.shape
    idx = codes.transpose(-1, -2) + torch.arange(M, device=codes.device)[:, None] * Ks
    flat = lut.reshape(B, M * Ks)
    if codes.dim() == 2:
        g = flat.index_select(1, idx.reshape(-1)).reshape(B, M, -1)
    else:
        g = flat.gather(1, idx.reshape(B, -1)).reshape(B, M, -1)
    acc = g[:, 0]
    for m in range(1, M):
        acc = acc + g[:, m]
    return acc


def _adc_rows(lut: torch.Tensor, codes: torch.Tensor, method: str) -> torch.Tensor:
    """``(Q, c)`` ADC distances of code rows ``codes (c, M)`` (int64) from a
    ``(Q, M, Ks)`` LUT: ``adc``, or the JAX package's one-hot matmul (the
    same numbers: each product is an exact 0/1 pick)."""
    if method != "onehot":
        return adc(lut, codes)
    Ks = lut.shape[2]
    acc = None
    for m in range(lut.shape[1]):
        oh = torch.nn.functional.one_hot(codes[:, m], Ks).float()   # (c, Ks)
        t = lut[:, m] @ oh.T
        acc = t if acc is None else acc + t
    return acc


def pq_search(
    codebook: PQCodebook,
    codes: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    chunk: int = 65536,
    method: str = "auto",
    packed4: bool = False,
):
    """ADC top-k over the code matrix, streamed in chunks. Scores are negated
    squared distances (larger is better); ids are int64 row ids.

    ``method``: ``"gather"`` (a row gather from each subspace's LUT),
    ``"onehot"`` (the JAX package's one-hot matmul; the same numbers) or
    ``"auto"`` (the gather)."""
    N = codes.shape[0]
    M = codebook.codewords.shape[0]
    Ks = codebook.codewords.shape[1]
    if packed4:
        if Ks > 16:
            raise ValueError("packed4 requires Ks <= 16 (4-bit codes)")
        if codes.shape[1] != M // 2:
            raise ValueError(f"packed codes must be (N, {M // 2}), got {tuple(codes.shape)}")
    elif codes.shape[1] != M:
        raise ValueError(f"codes must be (N, {M}), got {tuple(codes.shape)}")
    if method not in ("auto", "gather", "onehot"):
        raise ValueError(f"unknown method {method!r}")
    k = min(k, N)
    if method == "auto":
        method = "gather"
    lut = pq_dist_table(codebook, queries).contiguous()       # (Q, M, Ks)

    chunk = max(128, min(chunk, ((N + 127) // 128) * 128))
    k_local = min(k, chunk)
    cand_s, cand_i = [], []
    for start in range(0, N, chunk):
        tile = codes[start:start + chunk]
        if packed4:
            tile = pq_unpack4(tile)
        s, sel = _top_exact(-_adc_rows(lut, codes_long(tile), method),
                          min(k_local, tile.shape[0]))
        cand_s.append(s)
        cand_i.append(sel + start)
    if len(cand_s) == 1:
        return cand_s[0][:, :k], cand_i[0][:, :k]
    # chunk-major candidates: among equal scores the earlier chunk (the
    # lower id) comes first, as in the JAX merge
    final_s, sel = _top_exact(torch.cat(cand_s, 1), k)
    return final_s, torch.cat(cand_i, 1).gather(1, sel)
