"""Exact nearest-neighbour search: score GEMM + top-k.

Port of ``image_search_engine_for_historical_research_tpu/ops/topk.py``
(:30-284): ``exact_topk`` with its one-shot, chunked and ``QBLOCK`` paths,
``exact_scores``, ``exact_ranks`` and ``streaming_exact_topk``. The JAX
package left the score GEMM and the top-k to XLA (neither is a Pallas kernel
there). The port leaves them to cuBLAS and ``torch.topk``, except on the one
shape family where cuBLAS wastes the card: the skinny f32 inner-product scan,
which the ``ops.scan_topk`` kernel does with the top-k in its epilogue.

- When the ``(Q, N)`` f32 score matrix fits ``ONESHOT_SCORE_BYTES``: one
  scan. With ``metric="ip"``, f32 ``q`` and gallery on the card, and what
  the kernel takes (``scan_topk.takes``: contiguous, 16-byte aligned, Q at
  most 72, k at most 128, D a multiple of 4) it is the kernel; otherwise one
  GEMM and one top-k. Otherwise the gallery is scanned in chunks (per-chunk top-k,
  then one merge), and more than ``QBLOCK`` queries go in query blocks. Both
  budgets are memory bounds, kept as the JAX package set them. A chunk is a
  view of the gallery: the last one is shorter instead of padded, so the scan
  never copies the gallery.
- ``matmul_dtype=torch.bfloat16`` multiplies bf16 operands into f32 scores,
  like the JAX package's ``preferred_element_type=float32``: on the card
  ``torch.mm(..., out_dtype=torch.float32)``; on the CPU the operands are
  upcast to f32 (a product of two bf16 values is exact in f32, so only the
  summation order differs).
- Ties: ``lax.top_k`` puts the lower index first among equal scores. The
  port orders the selected ids the same way, but which of several ids tied
  at the k-th score is selected may differ, except on the kernel, which
  selects the lowest as ``lax.top_k`` does; callers hold ids by score there.

Metrics: ``"ip"`` and ``"l2"`` via ``2 q.x - ||x||^2`` (the ``||q||^2``
constant cannot change the order). Scores are larger-is-better throughout.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from . import scan_topk

NEG_INF = float("-inf")

# score-matrix budget for the one-shot path (bytes of f32 scores)
ONESHOT_SCORE_BYTES = 2 << 30
# query-block rows for very large query batches (bounds the chunked-path
# merge buffers: nchunks * QBLOCK * k * 8 bytes)
QBLOCK = 8192


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` as f32 scores; bf16 operands accumulate in f32."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if dtype == torch.float32:
        return a @ b.T
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


@contextmanager
def _full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after: f32
    products and convolutions stay f32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b.transpose(1, 2)`` as f32, like ``_matmul_f32``."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype).transpose(1, 2)
    if dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _scores(q, x, metric, x2=None):
    s = _matmul_f32(q, x)
    if metric == "l2":
        if x2 is None:
            x2 = (x.float() ** 2).sum(-1)
        s = 2.0 * s - x2[None, :]
    elif metric != "ip":
        raise ValueError(f"unknown metric: {metric}")
    return s


def _top(s: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest per row, descending, lower index
    first among equal scores."""
    v, i = torch.topk(s, k, dim=1)
    i, perm = torch.sort(i, dim=1)
    v, perm = torch.sort(v.gather(1, perm), dim=1, descending=True, stable=True)
    return v, i.gather(1, perm)


def _top_exact(s: torch.Tensor, k: int):
    """``lax.top_k`` including which of several ids tied at the k-th score
    are selected (the lowest): the head of a stable descending sort. For
    score rows with many equal values, such as the zeros of a dense
    diffusion score row or the ADC scores of rows that share a PQ code."""
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def exact_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    k: int,
    *,
    metric: str = "ip",
    chunk: int = 262144,
    matmul_dtype: Optional[torch.dtype] = None,
    approximate: bool = False,
):
    """Top-``k`` of ``queries (Q, D)`` against ``db (N, D)``, on their device.

    Returns ``(scores (Q, k) f32 descending, ids (Q, k) int64)``. More than
    ``QBLOCK`` queries whose scores exceed the one-shot budget are processed
    in ``QBLOCK``-row blocks (the last one zero-padded, as the JAX package
    pads it).

    ``approximate=True`` is the TPU's matmul-fused ``approx_max_k`` in the
    JAX package; the port computes the exact top-k on every device (on the
    CPU, JAX's ``approx_max_k`` returns ``lax.top_k``'s result as well).
    """
    del approximate  # exact on every device, see the docstring
    Q, D = queries.shape
    N = db.shape[0]
    k = min(k, N)
    if Q > QBLOCK and Q * N * 4 > ONESHOT_SCORE_BYTES:
        pad = (-Q) % QBLOCK
        qp = torch.cat([queries, queries.new_zeros((pad, D))]) if pad else queries
        parts = [_exact_topk_impl(qp[s:s + QBLOCK], db, k, metric, chunk, matmul_dtype)
                 for s in range(0, qp.shape[0], QBLOCK)]
        return (torch.cat([p[0] for p in parts])[:Q],
                torch.cat([p[1] for p in parts])[:Q])
    return _exact_topk_impl(queries, db, k, metric, chunk, matmul_dtype)


def _exact_topk_impl(queries, db, k, metric, chunk, matmul_dtype):
    Q = queries.shape[0]
    N = db.shape[0]
    q = queries.to(matmul_dtype) if matmul_dtype is not None else queries

    if Q * N * 4 <= ONESHOT_SCORE_BYTES:
        x = db.to(matmul_dtype) if matmul_dtype is not None else db
        if metric == "ip" and scan_topk.takes(q, x, k):
            return scan_topk.scan_topk(q, x, k)
        return _top(_scores(q, x, metric), k)

    # chunked path: per-chunk top-k then merge; a (Q, chunk) f32 score tile
    # stays within a quarter of the one-shot budget
    per_chunk_budget = ONESHOT_SCORE_BYTES // 4
    chunk = min(chunk, max(per_chunk_budget // (Q * 4), 512))
    chunk = max(128, min((chunk // 128) * 128, ((N + 127) // 128) * 128))
    k_local = min(k, chunk)
    cand_s, cand_i = [], []
    for start in range(0, N, chunk):
        xc = db[start:start + chunk]
        # the JAX package takes ||x||^2 from the gallery's own dtype here
        x2 = (xc.float() ** 2).sum(-1) if metric == "l2" else None
        if matmul_dtype is not None:
            xc = xc.to(matmul_dtype)
        s, sel = _top(_scores(q, xc, metric, x2), min(k_local, xc.shape[0]))
        cand_s.append(s)
        cand_i.append(sel + start)
    # chunk-major candidates: among equal scores the earlier chunk, i.e. the
    # lower id, comes first, as in the JAX merge
    final_s, sel = _top(torch.cat(cand_s, 1), k)
    return final_s, torch.cat(cand_i, 1).gather(1, sel)


def exact_scores(
    queries: torch.Tensor,
    db: torch.Tensor,
    *,
    metric: str = "ip",
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Full ``(Q, N)`` f32 score matrix (for full-ranking mAP protocols and
    the re-rankers)."""
    q, x = queries, db
    if matmul_dtype is not None:
        q, x = q.to(matmul_dtype), x.to(matmul_dtype)
    return _scores(q, x, metric)


def exact_ranks(queries, db, *, metric="ip", matmul_dtype=None) -> torch.Tensor:
    """Full ranking ``(Q, N)`` by descending score (stable, as
    ``jnp.argsort``)."""
    s = exact_scores(queries, db, metric=metric, matmul_dtype=matmul_dtype)
    return torch.argsort(-s, dim=1, stable=True)


def streaming_exact_topk(
    queries: torch.Tensor,
    db_host,
    k: int,
    *,
    metric: str = "ip",
    device_chunk: int = 1 << 20,
    matmul_dtype: Optional[torch.dtype] = None,
):
    """Exact top-``k`` against a host-resident gallery larger than device
    memory: ``device_chunk``-row slices of ``db_host`` (anything
    ``np.asarray`` can slice, ``(N, D)``) go to ``queries``' device one at a
    time, each scanned by ``exact_topk``, with a running shortlist of ``k``.
    Returns ``(scores, ids)`` with global row ids, descending."""
    dev = queries.device
    Q = queries.shape[0]
    N = db_host.shape[0]
    k = min(k, N)
    best_s = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    for start in range(0, N, device_chunk):
        stop = min(start + device_chunk, N)
        block = torch.as_tensor(np.asarray(db_host[start:stop]), device=dev)
        if block.shape[0] < k:  # tail smaller than k: pad with -inf rows
            pad = k - block.shape[0]
            block = torch.cat([block, block.new_zeros((pad, block.shape[1]))])
            s, i = exact_topk(queries, block, k, metric=metric, matmul_dtype=matmul_dtype)
            s = torch.where(i < stop - start, s, NEG_INF)
        else:
            s, i = exact_topk(queries, block, k, metric=metric, matmul_dtype=matmul_dtype)
        best_s, best_i = _merge_chunk(best_s, best_i, s, i + start, k)
    return best_s, best_i


def _merge_chunk(best_s, best_i, s, i, k):
    """Port of ``_merge_chunk`` (:276-284): merge a block's top-``k`` into
    the running shortlist."""
    ts, t = _top(torch.cat([best_s, s], 1), k)
    return ts, torch.cat([best_i, i], 1).gather(1, t)
