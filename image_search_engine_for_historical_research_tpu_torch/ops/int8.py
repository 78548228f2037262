"""Int8-quantized exact search: a gallery at one byte a dimension.

Port of ``image_search_engine_for_historical_research_tpu/ops/int8.py``
(:41-255): per-row symmetric int8 quantization (``quantize_rows_int8``, in
``QUANT_CHUNK``-row blocks), the int8 scan + top-k (``int8_topk``: one shot
under ``ONESHOT_SCORE_BYTES``, else N-chunked, and ``QBLOCK`` query blocks)
and the shortlist re-rank against a bf16 copy (``int8_topk_rerank``).

With per-row scales ``x_j ~= s_j c_j`` and a quantized query
``q_i ~= t_i u_i``, a score is ``(u_i . c_j) * (t_i * s_j)``: an int8 x int8
-> int32 product (``torch._int_mm``, as JAX leaves its ``dot_general`` to
XLA; on the card it needs more than 16 query rows and gallery rows in
multiples of 8, so the query block and the gallery's last rows are
zero-padded and the padding dropped), then the scale product in JAX's order.
The int32 product is exact, so card and CPU agree on it bit for bit.

``approximate=True`` (the TPU's ``approx_max_k``) is exact here, as in
``ops.topk``; on the CPU JAX's ``approx_max_k`` is exact too. Every top-k is
``ops.topk._top_exact``: rows with equal codes and scales tie exactly, and
the lower id wins, as in ``lax.top_k``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .topk import _bmm_f32, _top_exact

# one-shot score budget: bytes of the int32 dot plane + f32 score plane
ONESHOT_SCORE_BYTES = 2 << 30
SCORE_BYTES_PER_ELT = 8
QBLOCK = 8192
QUANT_CHUNK = 131072


def _quantize_block(x: torch.Tensor):
    x = x.float()
    # XLA folds JAX's ``amax / 127.0`` into a product with the f32
    # reciprocal; the same product keeps the scales bit-equal
    scale = x.abs().amax(dim=1) * (1.0 / 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0), 0.0)
    codes = torch.round(x * inv[:, None]).clamp(-127, 127).to(torch.int8)
    return codes, scale


def _iter_blocks(x, chunk: int, device):
    """Yield ``(start, block)`` row blocks of ``x`` on ``device``: a host
    (numpy) array is uploaded one block at a time, a tensor is sliced, so
    no second full-size array is made."""
    for start in range(0, x.shape[0], chunk):
        blk = x[start:start + chunk]
        yield start, torch.as_tensor(np.asarray(blk) if isinstance(x, np.ndarray) else blk,
                                     device=device)


def quantize_rows_int8(x, chunk: int = QUANT_CHUNK, device="cuda"):
    """Per-row symmetric int8 quantization of ``x (N, D)``: ``(codes int8
    (N, D), scales f32 (N,))`` with ``x ~= scales[:, None] * codes``; an
    all-zero row gets scale 0. Works in ``chunk``-row blocks, on ``x``'s
    device (``device`` for host input)."""
    dev = x.device if torch.is_tensor(x) else resolve_device(device)
    N, D = x.shape
    codes = torch.empty((N, D), dtype=torch.int8, device=dev)
    scales = torch.empty((N,), dtype=torch.float32, device=dev)
    for start, blk in _iter_blocks(x, chunk, dev):
        codes[start:start + blk.shape[0]], scales[start:start + blk.shape[0]] = (
            _quantize_block(blk))
    return codes, scales


def _int_dot(qc: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``qc (Q, D) @ codes (n, D).T`` as exact int32. On the card
    ``torch._int_mm`` takes more than 16 rows and sizes in multiples of 8:
    the queries, the depth and the gallery's last rows are zero-padded."""
    if qc.device.type != "cuda":
        return torch._int_mm(qc, codes.T)
    Q, D = qc.shape
    n = codes.shape[0]
    pad_d = (-D) % 8
    if Q <= 16 or pad_d:
        qc = torch.nn.functional.pad(qc, (0, pad_d, 0, max(0, 17 - Q)))
    main = n - n % 8
    parts = []
    if main:
        c = codes[:main] if not pad_d else torch.nn.functional.pad(codes[:main], (0, pad_d))
        parts.append(torch._int_mm(qc, c.T))
    if n % 8:
        tail = torch.nn.functional.pad(codes[main:], (0, pad_d, 0, 8 - n % 8))
        parts.append(torch._int_mm(qc, tail.T)[:, :n % 8])
    d = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
    return d[:Q]


def _score_block(qc, qs, codes, scales):
    return _int_dot(qc, codes).float() * (qs[:, None] * scales[None, :])


def _int8_scan(qc, qs, codes, scales, k: int):
    """The int8 scan + top-``k`` over all of ``codes`` (JAX :101-173): one
    shot when the score planes fit ``ONESHOT_SCORE_BYTES``, else per-chunk
    top-k and one merge (chunk-major candidates: the lower id first among
    equal scores)."""
    Q = qc.shape[0]
    N = codes.shape[0]
    if Q * N * SCORE_BYTES_PER_ELT <= ONESHOT_SCORE_BYTES:
        return _top_exact(_score_block(qc, qs, codes, scales), min(k, N))
    per_chunk_budget = ONESHOT_SCORE_BYTES // 4
    chunk = max(per_chunk_budget // (Q * SCORE_BYTES_PER_ELT), 512)
    chunk = max(128, min((chunk // 128) * 128, ((N + 127) // 128) * 128))
    k_local = min(k, chunk)
    cand_s, cand_i = [], []
    for start in range(0, N, chunk):
        s = _score_block(qc, qs, codes[start:start + chunk], scales[start:start + chunk])
        ts, sel = _top_exact(s, min(k_local, s.shape[1]))
        cand_s.append(ts)
        cand_i.append(sel + start)
    final_s, sel = _top_exact(torch.cat(cand_s, 1), min(k, N))
    return final_s, torch.cat(cand_i, 1).gather(1, sel)


def _qblocked(fn, queries):
    """``fn`` over ``QBLOCK``-row query blocks, outputs concatenated."""
    parts = [fn(queries[s:s + QBLOCK]) for s in range(0, queries.shape[0], QBLOCK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def int8_topk(queries: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, k: int, *,
              approximate: bool = False, recall_target: float = 0.95):
    """Top-``k`` inner products of ``queries (Q, D)`` (quantized per row
    here) over an int8 gallery ``codes (N, D)``, ``scales (N,)``: ``(scores
    (Q, k) descending, ids)``. ``approximate`` and ``recall_target`` are
    accepted for the JAX signature; the top-k is exact."""
    del approximate, recall_target  # exact on every device, see the module docstring
    k = min(k, codes.shape[0])

    def run(qb):
        qc, qs = _quantize_block(qb)
        return _int8_scan(qc, qs, codes, scales, k)

    if queries.shape[0] > QBLOCK:
        return _qblocked(run, queries)
    return run(queries)


def _rerank_block(qb, codes, scales, rerank_vectors, k: int, shortlist: int):
    """Int8 shortlist, then exact scores against the gathered rows (JAX
    :211-220): the query in the rows' dtype, products summed in f32."""
    qc, qs = _quantize_block(qb)
    _, cand = _int8_scan(qc, qs, codes, scales, shortlist)
    g = rerank_vectors[cand]                                   # (q, shortlist, D)
    s = _bmm_f32(qb.to(g.dtype)[:, None, :], g)[:, 0]         # (q, shortlist)
    ts, sel = _top_exact(s, k)
    return ts, cand.gather(1, sel)


def int8_topk_rerank(queries: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                     rerank_vectors: torch.Tensor, k: int, *, shortlist: int = 512,
                     approximate: bool = True):
    """Int8 scan to a ``shortlist``-deep candidate set, then exact re-rank
    against ``rerank_vectors (N, D)`` (bf16 or f32), in ``QBLOCK`` query
    blocks. ``approximate`` is accepted for the JAX signature (exact)."""
    del approximate
    N = codes.shape[0]
    k = min(k, N)
    shortlist = min(max(shortlist, k), N)

    def run(qb):
        return _rerank_block(qb, codes, scales, rerank_vectors, k, shortlist)

    if queries.shape[0] > QBLOCK:
        return _qblocked(run, queries)
    return run(queries)
