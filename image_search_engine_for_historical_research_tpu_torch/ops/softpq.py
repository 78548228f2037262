"""The flat codeword layout of the reference's PQ matchers.

Port of ``codewords_flat`` and ``codewords_from_flat`` in
``image_search_engine_for_historical_research_tpu/ops/softpq.py`` (:68-78):
the ``(Ks, M * ds)`` layout that ``matching_PQ_Net`` and
``matching_PQ_Net_bucket`` take (the reference's transpose + reshape of
per-book codewords) and its inverse, the ``(M, Ks, ds)`` codebook of
``ops.pq``. The training half of the module (``init_softpq``,
``soft_quantize``, ``softpq_loss``) is not ported yet.
"""

from __future__ import annotations

import torch


def codewords_flat(codewords: torch.Tensor) -> torch.Tensor:
    """``(M, Ks, ds)`` codewords (or a state holding them as ``.codewords``)
    -> the ``(Ks, M * ds)`` flat layout."""
    cw = getattr(codewords, "codewords", codewords)
    M, Ks, ds = cw.shape
    return cw.permute(1, 0, 2).reshape(Ks, M * ds)


def codewords_from_flat(flat: torch.Tensor, M: int) -> torch.Tensor:
    """Inverse of ``codewords_flat``: ``(Ks, M * ds)`` -> ``(M, Ks, ds)``."""
    Ks, D = flat.shape
    return flat.reshape(Ks, M, D // M).permute(1, 0, 2).contiguous()
