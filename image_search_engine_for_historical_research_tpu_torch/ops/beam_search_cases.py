"""Exact inputs for checking the beam-search kernel against its plain version.

On these inputs every distance and every tie is exact, so the kernel must
give the plain version's beams id for id, in order. ``chip_smoke.py`` and the
``cuda`` tests of ``tests/test_torch_port_beam_search.py`` both run
``EDGE_CASES``; the CPU tests use ``quarter_case`` against the JAX package.
"""

from __future__ import annotations

import numpy as np


def quarter_case(seed, n, d, m0, q, dup=0, all_neg_row=None, reach=0):
    """Beam-search inputs on values k/4, |k| <= 4: every sum either version
    takes is exact in f32 and bf16, so distances and ties are exact and the
    beams must agree id for id. ``dup`` > 0 draws the rows from that many
    distinct ones (duplicate rows: exact ties decided by the first-index
    rules). The neighbour table has -1 tails and a repeated id per row;
    ``all_neg_row`` is a node whose row is all -1 and the first query's
    start. ``reach`` > 0 maps every neighbour id and start into that many
    nodes spread over [0, n), so a search stays among them and ends early
    while the visited bitset still spans n. Returns ``(db, nbr0, queries,
    starts)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-4, 5, (dup or n, d)) / 4.0
    db = base[rng.integers(0, dup, n)] if dup else base
    nbr = rng.integers(0, n, (n, m0))
    tail = rng.integers(0, m0 // 4 + 1, n)
    nbr[np.arange(m0)[None, :] >= (m0 - tail)[:, None]] = -1
    nbr[:, min(9, m0 - 1)] = nbr[:, 2]
    queries = rng.integers(-4, 5, (q, d)) / 4.0
    starts = rng.integers(0, n, q)
    if all_neg_row is not None:
        nbr[all_neg_row] = -1
        starts[0] = all_neg_row
    if reach:
        pool = np.sort(rng.choice(n, reach, replace=False))
        nbr = np.where(nbr >= 0, pool[nbr % reach], -1)
        starts = pool[starts % reach]
    return (db.astype(np.float32), nbr.astype(np.int32), queries.astype(np.float32),
            starts.astype(np.int32))


# The cases the kernel's design touches: name -> (quarter_case positional
# arguments (seed, n, d, m0, q), its keyword arguments, ef, db dtype).
# "beam_2048_slots" takes the widest register beam (ef_pad 2048), whose
# neighbour-row cache does not fit in shared memory; "n_1_6m_no_cache" is an N
# that fits only without the cache; the "visited_in_device_memory" cases have
# an N whose visited bitset does not fit in shared memory, with the cache and
# (at ef_pad 2048) without it.
EDGE_CASES = {
    "duplicate_rows": ((0, 600, 2048, 32, 8), {"dup": 40}, 100, "float32"),
    "duplicate_rows_bf16": ((1, 600, 2048, 32, 8), {"dup": 40}, 100, "bfloat16"),
    "m0_16_ef_32": ((2, 3000, 256, 16, 8), {}, 32, "float32"),
    "m0_32_ef_100": ((3, 3000, 2048, 32, 8), {}, 100, "float32"),
    "m0_64_ef_200": ((4, 3000, 264, 64, 8), {}, 200, "float32"),
    "more_fresh_than_warps": ((5, 20000, 2048, 64, 4), {}, 100, "float32"),
    "bf16_m0_32": ((6, 3000, 2048, 32, 8), {}, 100, "bfloat16"),
    "n_11": ((7, 11, 2048, 32, 4), {}, 32, "float32"),
    "all_neg_row": ((8, 500, 2048, 32, 6), {"all_neg_row": 7}, 100, "float32"),
    "m0_128": ((9, 3000, 256, 128, 4), {}, 100, "float32"),
    "beam_2048_slots": ((10, 2400, 256, 32, 2), {}, 2000, "float32"),
    "n_1_6m_no_cache": ((11, 1_600_000, 8, 64, 4), {}, 100, "float32"),
    "visited_in_device_memory": ((12, 2_000_000, 8, 32, 4), {}, 100, "float32"),
    "visited_in_device_memory_2048_slots":
        ((13, 2_000_000, 8, 32, 2), {"reach": 2400}, 2000, "float32"),
}

# the cases whose launch leaves out the neighbour-row cache
NO_CACHE = ("beam_2048_slots", "n_1_6m_no_cache", "visited_in_device_memory_2048_slots")
# the cases whose visited bitset lives in device memory
DEVICE_VISITED = ("visited_in_device_memory", "visited_in_device_memory_2048_slots")
