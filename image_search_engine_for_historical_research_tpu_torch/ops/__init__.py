"""Numeric ops: normalization, pooling, exact scores, HNSW search; k-means
and product quantization in ``ops.kmeans`` and ``ops.pq``, the int8 scan in
``ops.int8``, LSH and Hamming search in ``ops.hashing``, whitening in
``ops.whiten``, the tuple losses in ``ops.losses`` and soft PQ with the flat
codeword layout in ``ops.softpq``.

The beam-search kernel is reached as the module ``ops.beam_search``
(``beam_search.beam_search`` and its launch count ``beam_search.launches``).
"""

from . import beam_search
from .graph_search import hnsw_descend_entries
from .normalization import l2n, powerlaw
from .pooling import gem, mac, rmac, roipool, spoc
from .topk import exact_ranks, exact_scores, exact_topk, streaming_exact_topk

__all__ = [
    "beam_search", "hnsw_descend_entries", "l2n", "powerlaw", "gem", "mac", "spoc",
    "rmac", "roipool",
    "exact_ranks", "exact_scores", "exact_topk", "streaming_exact_topk",
]
