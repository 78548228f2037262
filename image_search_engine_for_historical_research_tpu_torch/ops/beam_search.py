"""HNSW level-0 beam search: the CUDA kernel and its plain PyTorch version.

Port of the JAX package's only TPU kernel, ``_beam_kernel`` with its wrapper
``pallas_beam_search``
(``image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:55-367``).
The kernel is ``csrc/beam_search.cu``, compiled with ``nvcc`` for ``sm_90a``
into a shared library and launched through ``ctypes``.

What bounds it: a chain of dependent hops (one per expanded node), each
needing the popped node's neighbour row, then about 8 KB (D = 2048, f32) for
every fresh neighbour, then a serial insert and pop. The kernel's design
answers each link of that chain (details at the top of the source):

- the neighbour row of every fresh node is copied into shared memory
  (``cp.async``) while its vector is scored and kept beside the beam slot it
  enters, so a pop never waits on device memory for the next row (where this
  cache does not fit in shared memory, the wrapper launches without it and
  the pop reads the row from device memory);
- the visited bitset lives in shared memory, and where it does not fit there
  (N above about 1.79M at D = 2048), in a zeroed device-memory buffer of the
  wrapper's, one row a query, launched in query chunks of at most
  ``VISITED_BYTES``;
- each scoring warp issues all of a 2048-wide row's 16-byte loads before its
  first FMA, so a hop's rows cost one round trip per row a warp takes;
- warp 0 keeps the beam's distances as order-preserving uint32 keys in
  registers (up to 64 a lane, so ``ef`` pads to at most ``MAX_EF_PAD``) and
  finds the worst slot and the next pop with ``redux.sync`` reductions (first
  index on ties);
- warp 0 and the scoring warps meet at two named barriers a hop.

``beam_search`` runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel launches.
``beam_search_phase_clocks`` runs the measurement build (per-phase
``clock64()`` sums, ``CLOCK_SLOTS``); it is never on the served path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

INF = float(np.float32(3.4e38))  # the TPU kernel's sentinel, exact in f32
SMEM_LIMIT = 232448              # bytes of shared memory one block may use (H100)
MAX_EF_PAD = 2048                # the kernel keeps ef_pad / 32 beam slots a lane in registers
VISITED_BYTES = 1 << 30          # device-memory visited bitsets one launch may take

# per-block slots of ``beam_search_phase_clocks``: clock64() cycles of warp 0's
# neighbour-row and visited phase (A), of the row distances (B, the longest
# scoring warp's span on its own clock), of the inserts and the pop (C) and of
# warp 0's wait for B beyond B (barrier); then hops, hops whose pop took a
# slot filled in that hop, fresh rows, and the block's cycles from start to end
CLOCK_SLOTS = ("A", "B", "C", "barrier", "hops", "same_hop_pops", "fresh_rows", "total")

launches = 0                     # kernel launches since import (or last reset)
_count_lock = threading.Lock()
_libs = {}


def padded_ef(ef: int) -> int:
    """Beam slots: ``ef`` rounded up to a multiple of 128 (at least 128)."""
    return max(((ef + 127) // 128) * 128, 128)


def _sorted_output(out_d: torch.Tensor, out_ids: torch.Tensor, ef: int):
    """Sort the beam by ascending distance (stable, like ``jnp.argsort``), cut
    to ``ef`` and negate: ``(scores desc, ids)``."""
    d_sorted, order = torch.sort(out_d, dim=1, stable=True)
    ids = out_ids.gather(1, order)
    return -d_sorted[:, :ef], ids[:, :ef].to(torch.int32)


def beam_search(
    db: torch.Tensor,        # (N, D) f32 or bf16
    nbr0: torch.Tensor,      # (N, m0) int32, -1 padded
    queries: torch.Tensor,   # (Q, D) f32
    starts: torch.Tensor,    # (Q,) int32 entry points
    ef: int = 100,
    max_steps: int = 0,
):
    """Per-query beam search; returns ``(scores, ids)``, each ``(Q, ef)``:
    scores are ``-squared L2`` in descending order; unfilled slots come back
    as id -1 with score -3.4e38."""
    if db.device.type == "cpu":
        return beam_search_reference(db, nbr0, queries, starts, ef, max_steps)
    if db.device.type != "cuda":
        raise ValueError(f"beam_search: unsupported device {db.device}")
    return _beam_search_cuda(db, nbr0, queries, starts, ef, max_steps)


def check_ef(ef: int) -> int:
    """``ef``'s beam slots (``padded_ef``); raises where the kernel cannot
    hold them."""
    if ef < 1:
        raise ValueError(f"beam_search: ef must be >= 1, got {ef}")
    ef_pad = padded_ef(ef)
    if ef_pad > MAX_EF_PAD:
        raise ValueError(f"beam_search: ef={ef} pads to {ef_pad} beam slots; the kernel "
                         f"takes at most {MAX_EF_PAD} (ef <= {MAX_EF_PAD})")
    return ef_pad


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded beam-search library."""
    lib.beam_search_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.beam_search_smem_bytes.restype = ctypes.c_size_t
    head = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.beam_search_launch.argtypes = head + [ctypes.c_void_p] * 4
    lib.beam_search_launch.restype = ctypes.c_int
    if hasattr(lib, "beam_search_launch_clocks"):
        lib.beam_search_launch_clocks.argtypes = head + [ctypes.c_void_p] * 5
        lib.beam_search_launch_clocks.restype = ctypes.c_int
    lib.beam_search_error_string.argtypes = [ctypes.c_int]
    lib.beam_search_error_string.restype = ctypes.c_char_p
    return lib


def _library(name: str = "beam_search") -> ctypes.CDLL:
    if name not in _libs:
        from ..native import load

        _libs[name] = _bind(load(name))
    return _libs[name]


def beam_search_phase_clocks(db, nbr0, queries, starts, ef: int = 100, max_steps: int = 0):
    """The kernel's measurement build (``-DBEAM_SEARCH_PHASE_CLOCKS``) on CUDA
    tensors: ``(scores, ids, clocks)`` with ``clocks`` a ``(Q, 8)`` int64
    tensor of ``CLOCK_SLOTS``. Not counted in ``launches``."""
    if db.device.type != "cuda":
        raise ValueError("beam_search_phase_clocks: the clocks exist only on the card")
    return _beam_search_cuda(db, nbr0, queries, starts, ef, max_steps, with_clocks=True)


def shared_memory_plan(N: int, D: int, m0: int, ef_pad: int):
    """``(cache, smem_visited, bytes)`` of a launch, from the kernel's own
    ``beam_search_smem_bytes``: the visited bitset in shared memory with the
    neighbour-row cache, then without it, then the bitset in device memory
    with the cache, then without; raises where not even the query row and
    the beam fit. Needs the kernel's library (the card's toolkit)."""
    lib = _library()
    for smem_visited in (1, 0):
        for cache in (1, 0):
            smem = lib.beam_search_smem_bytes(N, D, m0, ef_pad, cache, smem_visited)
            if smem <= SMEM_LIMIT:
                return cache, smem_visited, smem
    raise ValueError(
        f"beam_search: D={D}, m0={m0}, ef_pad={ef_pad} need {smem} bytes of shared "
        f"memory for the query row, beam and candidates; a block has {SMEM_LIMIT}"
    )


def query_chunk(Q: int, N: int, smem_visited: int) -> int:
    """Queries one launch takes: all of them with the bitset in shared memory,
    else as many as ``VISITED_BYTES`` of device-memory bitsets hold."""
    if smem_visited:
        return max(Q, 1)
    return max(1, min(Q, VISITED_BYTES // (4 * ((N + 31) // 32))))


def _beam_search_cuda(db, nbr0, queries, starts, ef, max_steps, with_clocks=False):
    """Launch the served build (counted) or the phase-clock build."""
    global launches
    N, D = db.shape
    Q = queries.shape[0]
    m0 = nbr0.shape[1]
    dev = db.device
    for name, t, dtypes, shape in (
        ("db", db, (torch.float32, torch.bfloat16), (N, D)),
        ("nbr0", nbr0, (torch.int32,), (N, m0)),
        ("queries", queries, (torch.float32,), (Q, D)),
        ("starts", starts, (torch.int32,), (Q,)),
    ):
        if t.device != dev:
            raise ValueError(f"beam_search: {name} is on {t.device}, db on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"beam_search: {name} dtype {t.dtype}, want {dtypes}")
        if tuple(t.shape) != shape:
            raise ValueError(f"beam_search: {name} shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"beam_search: {name} must be contiguous")
    if D % 8 or db.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("beam_search: the kernel needs D % 8 == 0 and "
                         "16-byte aligned db and query rows")
    ef_pad = check_ef(ef)
    max_steps = max_steps or 4 * ef
    cache, smem_visited, _ = shared_memory_plan(N, D, m0, ef_pad)
    lib = _library("beam_search_clocks" if with_clocks else "beam_search")
    out_ids = torch.empty((Q, ef_pad), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, ef_pad), dtype=torch.float32, device=dev)
    clocks = (torch.zeros((Q, len(CLOCK_SLOTS)), dtype=torch.int64, device=dev)
              if with_clocks else None)
    chunk = query_chunk(Q, N, smem_visited)
    visited = (None if smem_visited else
               torch.empty((chunk, (N + 31) // 32), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for q0 in range(0, Q, chunk):
            qn = min(chunk, Q - q0)
            if visited is not None:
                visited.zero_()
            args = [db.data_ptr(), int(db.dtype == torch.bfloat16), nbr0.data_ptr(),
                    queries[q0:].data_ptr(), starts[q0:].data_ptr(), N, D, m0, qn,
                    ef_pad, max_steps, cache,
                    None if visited is None else visited.data_ptr(),
                    out_ids[q0:].data_ptr(), out_d[q0:].data_ptr()]
            if with_clocks:
                rc = lib.beam_search_launch_clocks(*args, clocks[q0:].data_ptr(), stream)
            else:
                rc = lib.beam_search_launch(*args, stream)
            if rc != 0:
                msg = lib.beam_search_error_string(rc).decode()
                raise RuntimeError(f"beam_search kernel launch failed: CUDA error {rc} ({msg})")
            if not with_clocks:
                with _count_lock:
                    launches += 1
    if with_clocks:
        return _sorted_output(out_d, out_ids, ef) + (clocks,)
    return _sorted_output(out_d, out_ids, ef)


def beam_search_reference(
    db: torch.Tensor,
    nbr0: torch.Tensor,
    queries: torch.Tensor,
    starts: torch.Tensor,
    ef: int = 100,
    max_steps: int = 0,
    stats: Optional[dict] = None,
):
    """Plain PyTorch version of the kernel's semantics, batched over queries
    with a ``(Q, N)`` bool visited tensor; same arguments and outputs as
    ``beam_search``.

    ``stats``, when given, receives the work this run's data needed:
    ``expansions`` (neighbour rows read), ``fresh_rows`` (database rows scored
    after the seeds) and ``seeds`` (one start row per query)."""
    N, D = db.shape
    Q = queries.shape[0]
    m0 = nbr0.shape[1]
    dev = db.device
    max_steps = max_steps or 4 * ef
    ef_pad = padded_ef(ef)

    q = queries.float()
    q2 = (q * q).sum(1)
    nbr = nbr0.long()
    rows = torch.arange(Q, device=dev)
    slots = torch.arange(ef_pad, device=dev)
    earlier = torch.ones(m0, m0, dtype=torch.bool, device=dev).tril(-1)  # [a, b]: b < a

    def dist(ids):  # (Q, m) valid ids -> (Q, m) squared L2 in f32
        v = db[ids].float()
        dot = (v * q[:, None, :]).sum(-1)
        return (v * v).sum(-1) - 2.0 * dot + q2[:, None]

    start = starts.long()
    beam_ids = torch.full((Q, ef_pad), -1, dtype=torch.long, device=dev)
    beam_d = torch.full((Q, ef_pad), INF, dtype=torch.float32, device=dev)
    expanded = torch.zeros((Q, ef_pad), dtype=torch.bool, device=dev)
    beam_ids[:, 0] = start
    beam_d[:, 0] = dist(start[:, None])[:, 0]
    expanded[:, 0] = True
    visited = torch.zeros((Q, N), dtype=torch.bool, device=dev)
    visited[rows, start] = True

    node = start
    active = torch.ones(Q, dtype=torch.bool, device=dev)
    n_expanded = torch.zeros((), dtype=torch.long, device=dev)
    n_fresh = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(max_steps):
        nb = nbr[node]                                         # (Q, m0)
        ok = (nb >= 0) & active[:, None]
        safe = nb.clamp(min=0)
        seen = visited.gather(1, safe)
        # an id repeated in the row is fresh only at its first valid position
        repeat = ((safe[:, :, None] == safe[:, None, :]) & earlier & ok[:, None, :]).any(2)
        fresh = ok & ~seen & ~repeat
        visited[rows[:, None].expand_as(safe)[fresh], safe[fresh]] = True
        d = torch.where(fresh, dist(safe), INF)
        n_expanded += active.sum()
        n_fresh += fresh.sum()
        for j in range(m0):                                    # serial inserts
            worst_d, worst = beam_d.max(dim=1)
            sel = (slots[None, :] == worst[:, None]) & (d[:, j] < worst_d)[:, None]
            beam_ids = torch.where(sel, nb[:, j : j + 1], beam_ids)
            beam_d = torch.where(sel, d[:, j : j + 1], beam_d)
            expanded = expanded & ~sel
        open_d = torch.where(expanded, INF, beam_d)
        md, i_star = open_d.min(dim=1)                          # pop
        cont = active & (md < INF)
        node = torch.where(cont, beam_ids[rows, i_star], node)
        expanded = expanded | ((slots[None, :] == i_star[:, None]) & cont[:, None])
        active = cont
        if not bool(active.any()):
            break
    if stats is not None:
        stats["expansions"] = int(n_expanded)
        stats["fresh_rows"] = int(n_fresh)
        stats["seeds"] = Q
    return _sorted_output(beam_d, beam_ids, ef)
