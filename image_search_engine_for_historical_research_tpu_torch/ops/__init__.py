"""Numeric ops: normalization, pooling, exact scores, HNSW search.

The beam-search kernel is reached as the module ``ops.beam_search``
(``beam_search.beam_search`` and its launch count ``beam_search.launches``).
"""

from . import beam_search
from .graph_search import hnsw_descend_entries
from .normalization import l2n
from .pooling import gem, mac, spoc
from .topk import exact_scores

__all__ = [
    "beam_search", "hnsw_descend_entries", "l2n", "gem", "mac", "spoc",
    "exact_scores",
]
