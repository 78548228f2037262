"""Binary hashing: random-hyperplane LSH, Hamming top-k, and the fractional
distance matcher.

Port of ``image_search_engine_for_historical_research_tpu/ops/hashing.py``
(:18-81): ``lsh_hyperplanes``, ``lsh_encode``, ``pack_bits``, ``_popcount``,
``hamming_topk`` and ``fractional_topk``.

- Codes are bits packed little-endian into 32-bit words, returned as
  ``torch.uint32`` as JAX returns ``uint32``. Torch implements few
  operations on ``uint32`` on the card, so the words are built in int64
  and scanned as int32 views of the same bits (two's complement: XOR is
  the same, the popcount's masks clear the bits an arithmetic shift brings
  in, and its product wraps as uint32's does).
- ``lsh_hyperplanes`` is a host generator's normal draw (JAX's
  ``jax.random.normal`` cannot be reproduced); tests substitute JAX's planes
  for it.
- Hamming distances are integers, so ties are the rule: every top-k is
  ``ops.topk._top_exact`` on ``-d`` (the lower id first, as ``lax.top_k``).
- Both scans are chunked over the gallery (and the queries) to a byte budget
  of temporaries, where JAX maps one query at a time over the whole gallery:
  the fractional distance's ``(N, D)`` difference a query is 8 GB at 1M.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .topk import _top_exact

SCAN_BYTES = 512 << 20     # bytes of a chunk's elementwise temporaries
WORD = 1 << 32


def lsh_hyperplanes(dim: int, n_bits: int, seed: int = 42, device="cuda") -> torch.Tensor:
    """Random projection matrix ``(n_bits, dim)`` f32, a host generator's
    standard normal draw seeded by ``seed``, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n_bits, dim, generator=g).to(resolve_device(device))


def _words(codes: torch.Tensor) -> torch.Tensor:
    """uint32 words -> an int32 view of the same bits."""
    return codes.view(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(N, B)`` bool -> ``(N, ceil(B / 32))`` uint32, little-endian within
    words."""
    N, B = bits.shape
    pad = (-B) % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros((N, pad))], dim=1)
    shifts = torch.arange(32, device=bits.device)
    w = (bits.reshape(N, -1, 32).long() << shifts).sum(-1)        # values < 2^32
    return torch.where(w >= WORD // 2, w - WORD, w).to(torch.int32).view(torch.uint32)


def lsh_encode(planes: torch.Tensor, vecs: torch.Tensor, chunk: int = 131072) -> torch.Tensor:
    """Sign-bit codes of ``vecs @ planes.T``, packed: ``(N, ceil(n_bits/32))``
    uint32 (in ``chunk``-row blocks, f32 products)."""
    return torch.cat([pack_bits(vecs[s:s + chunk].float() @ planes.float().T > 0)
                      for s in range(0, vecs.shape[0], chunk)])


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bit population count of int32 words (SWAR, JAX's uint32 form on the
    same bits), in place on ``x``."""
    x -= (x >> 1) & 0x55555555
    x = (x & 0x33333333).add_((x >> 2) & 0x33333333)
    x = x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    return x.mul_(0x01010101).bitwise_right_shift_(24)


def _chunked_topk(score_fn, Q: int, N: int, k: int, row_bytes: int):
    """Top-``k`` of ``score_fn(q0, q1, n0, n1) -> (q1 - q0, n1 - n0)``
    scores over query and gallery chunks whose temporaries take about
    ``SCAN_BYTES`` (``row_bytes`` a query-gallery pair): per-chunk top-k,
    then one merge of chunk-major candidates (the lower id first among
    equal scores, as one ``lax.top_k`` over the row)."""
    q_chunk = max(1, min(Q, SCAN_BYTES // (1024 * row_bytes)))
    out_s, out_i = [], []
    for q0 in range(0, Q, q_chunk):
        q1 = min(Q, q0 + q_chunk)
        n_chunk = max(1, SCAN_BYTES // ((q1 - q0) * row_bytes))
        cand_s, cand_i = [], []
        for n0 in range(0, N, n_chunk):
            s, sel = _top_exact(score_fn(q0, q1, n0, min(N, n0 + n_chunk)), k)
            cand_s.append(s)
            cand_i.append(sel + n0)
        s, sel = _top_exact(torch.cat(cand_s, 1), k)
        out_s.append(s)
        out_i.append(torch.cat(cand_i, 1).gather(1, sel))
    return torch.cat(out_s), torch.cat(out_i)


def hamming_topk(db_codes: torch.Tensor, q_codes: torch.Tensor, k: int):
    """Top-``k`` by ascending Hamming distance over packed codes: ``db_codes
    (N, W)``, ``q_codes (Q, W)`` uint32. Returns ``(scores = -distance f32,
    ids)``, like every other searcher."""
    N, W = db_codes.shape
    k = min(k, N)
    db, q = _words(db_codes), _words(q_codes)

    def neg_distance(q0, q1, n0, n1):
        x = q[q0:q1, None, :] ^ db[None, n0:n1, :]
        return -_popcount(x).sum(-1, dtype=torch.int32)

    s, i = _chunked_topk(neg_distance, q.shape[0], N, k, 4 * W * 4)
    return s.float(), i


def fractional_topk(db: torch.Tensor, queries: torch.Tensor, k: int, p: float = 0.5):
    """Fractional-distance matcher ``d(x, y) = (sum |x - y|^p)^(1/p)``:
    O(Q N D) elementwise, kept for parity. Returns ``(-d, ids)``."""
    N, D = db.shape
    k = min(k, N)

    def neg_distance(q0, q1, n0, n1):
        diff = (db[None, n0:n1, :] - queries[q0:q1, None, :]).abs_()
        return -(diff.pow_(p).sum(-1) ** (1.0 / p))

    return _chunked_topk(neg_distance, queries.shape[0], N, k, 4 * D * 2)
