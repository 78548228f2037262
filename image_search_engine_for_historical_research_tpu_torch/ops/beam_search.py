"""HNSW level-0 beam search: the CUDA kernel and its plain PyTorch version.

Port of the JAX package's only TPU kernel, ``_beam_kernel`` with its wrapper
``pallas_beam_search``
(``image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:55-367``).
The kernel is ``csrc/beam_search.cu``, compiled with ``nvcc`` for ``sm_90a``
into a shared library and launched through ``ctypes``. What bounds it, and
how its design answers that, is written at the top of that source: a chain of
dependent hops, each reading one neighbour row and about 8 KB (D = 2048, f32)
for every fresh neighbour, so it is latency-bound.

``beam_search`` runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

INF = float(np.float32(3.4e38))  # the TPU kernel's sentinel, exact in f32
SMEM_LIMIT = 232448              # bytes of shared memory one block may use (H100)

launches = 0                     # kernel launches since import (or last reset)
_count_lock = threading.Lock()
_lib = None


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


def _library():
    global _lib
    if _lib is None:
        from ..native import load

        lib = load("beam_search")
        lib.beam_search_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.beam_search_smem_bytes.restype = ctypes.c_size_t
        lib.beam_search_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
        )
        lib.beam_search_launch.restype = ctypes.c_int
        lib.beam_search_error_string.argtypes = [ctypes.c_int]
        lib.beam_search_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _beam_search_cuda(db, nbr0, queries, starts, ef, max_steps):
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
    if ef < 1:
        raise ValueError(f"beam_search: ef must be >= 1, got {ef}")
    max_steps = max_steps or 4 * ef
    ef_pad = padded_ef(ef)
    lib = _library()
    smem = lib.beam_search_smem_bytes(N, D, m0, ef_pad)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"beam_search: N={N} needs {smem} bytes of shared memory for the "
            f"visited bitset, query row and beam; a block has {SMEM_LIMIT}. "
            "A visited set for larger N is an open ROADMAP item."
        )
    out_ids = torch.empty((Q, ef_pad), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, ef_pad), dtype=torch.float32, device=dev)
    if Q == 0:
        return _sorted_output(out_d, out_ids, ef)
    with torch.cuda.device(dev):
        rc = lib.beam_search_launch(
            db.data_ptr(), int(db.dtype == torch.bfloat16), nbr0.data_ptr(),
            queries.data_ptr(), starts.data_ptr(), N, D, m0, Q, ef_pad,
            max_steps, out_ids.data_ptr(), out_d.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.beam_search_error_string(rc).decode()
        raise RuntimeError(f"beam_search kernel launch failed: CUDA error {rc} ({msg})")
    with _count_lock:
        launches += 1
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
