"""PCA and supervised descriptor whitening.

Port of ``image_search_engine_for_historical_research_tpu/ops/whiten.py``
(:24-94): ``whitenapply``, ``pcawhitenlearn``, ``_psd_cholesky`` with its
jitter ladder, and ``whitenlearn``. Row-major ``(N, D)`` throughout; each
``*learn`` returns ``(m (D,), P (D_out, D))``, and ``whitenapply(X, m, P)``
maps ``(N, D) -> (N, D_out)`` with a final L2 normalization.

``eigh`` fixes each eigenvector only up to its sign, so a projection's rows
may have the other sign than JAX's; the whitened vectors differ by the same
signs, and their inner products do not.
"""

from __future__ import annotations

import torch


def whitenapply(X: torch.Tensor, m: torch.Tensor, P: torch.Tensor, dimensions=None):
    """Project, truncate to ``dimensions`` and L2-normalize the rows."""
    if dimensions is None:
        dimensions = P.shape[0]
    Xw = (X - m[None, :]) @ P[:dimensions, :].T
    return Xw / (torch.linalg.vector_norm(Xw, dim=-1, keepdim=True) + 1e-6)


def pcawhitenlearn(X: torch.Tensor):
    """Unsupervised PCA whitening: ``P = diag(eigval^-1/2) eigvec.T`` over the
    symmetrized covariance's eigenpairs, by decreasing eigenvalue."""
    N = X.shape[0]
    m = X.mean(dim=0)
    Xc = X - m[None, :]
    cov = (Xc.T @ Xc) / N
    cov = (cov + cov.T) / 2.0
    eigval, eigvec = torch.linalg.eigh(cov)                # ascending
    eigval, eigvec = eigval.flip(0), eigvec.flip(1)
    return m, torch.diag(1.0 / torch.sqrt(eigval.clamp(min=1e-12))) @ eigvec.T


def _psd_cholesky(S: torch.Tensor) -> torch.Tensor:
    """Cholesky with escalating diagonal jitter: the first of ``S + a I``,
    ``a`` in 0, 1e-10, ..., 1e-2, that factors (JAX keeps the first finite
    factor over the same ladder)."""
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    for alpha in [0.0, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2]:
        L, info = torch.linalg.cholesky_ex(S + alpha * eye)
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            return L
    return torch.full_like(S, float("nan"))


def whitenlearn(X: torch.Tensor, qidxs, pidxs):
    """Supervised (linear discriminant) whitening from matched query /
    positive index pairs: the within-pair covariance is Cholesky-inverted,
    then the projected total covariance is rotated to its eigenbasis
    (decreasing eigenvalue)."""
    Xq = X[qidxs]
    Xp = X[pidxs]
    m = Xq.mean(dim=0)
    df = Xq - Xp
    S = (df.T @ df) / df.shape[0]
    P = torch.linalg.inv(_psd_cholesky(S))
    dfc = (X - m[None, :]) @ P.T
    D = dfc.T @ dfc
    D = (D + D.T) / 2.0
    _, eigvec = torch.linalg.eigh(D)
    return m, eigvec.flip(1).T @ P
