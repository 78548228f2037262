"""Streaming build helpers: index a database that is never held whole.

Port of ``image_search_engine_for_historical_research_tpu/index/streaming.py``
(:24-111). The PQ builders accept a callable chunk source -- ``vecs()``
yields ``(c, D)`` row chunks, numpy arrays or tensors -- plus the total row
count ``n=``: training samples are gathered chunk by chunk here, and the
encode passes stream the source again. Rows end up on ``device``: each
pass uploads the source a grid piece at a time.

**The row grid.** A streamed build equals the in-memory build bit for bit
(given the same explicit ``train_sample``) on every device, whatever the
sizes of the source's chunks. A row-local operation such as a norm or a GEMM
can still round a row differently in batches of different shapes (a CUDA
reduction or a cuBLAS kernel is picked by shape). So every row-local pass of
a build runs over one grid of rows fixed by the global row index: ``GRID_ROWS``
pieces ``[0, GRID_ROWS), [GRID_ROWS, 2 GRID_ROWS), ...``, which the in-memory
builders cut from the whole matrix (``f32_rows``, ``row_pieces``) and the
streaming helpers re-cut from the source's chunks (``grid_pieces``).
Normalization runs on that grid, and the samples are gathered from the
normalized grid pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import normalize_rows

# rows of one piece of the build grid (1 GiB of f32 rows at D=2048)
GRID_ROWS = 131072


def f32_rows(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    """A matrix as f32 rows, L2-normalized on the build grid when
    ``normalize`` (the rows a streamed build normalizes)."""
    if not normalize:
        return x.float()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for s, piece in row_pieces(x):
        out[s:s + piece.shape[0]] = normalize_rows(piece.float())
    return out


def row_pieces(v: torch.Tensor, rows=None):
    """Yield ``(start_row, piece)``: views of ``v``'s ``rows``-row pieces
    (default: the build grid's), the in-memory side of
    ``stream_encode_pieces``."""
    rows = rows or GRID_ROWS
    for s in range(0, v.shape[0], rows):
        yield s, v[s:s + rows]


def _cut(chunks, rows):
    """Yield ``(start_row, parts)``: the rows of ``chunks`` (arrays or
    tensors) in the pieces ``[0, rows), [rows, 2 rows), ...``, each a list of
    slices of the chunks that cover it."""
    held, have, start = [], 0, 0
    for chunk in chunks:
        c, s = int(chunk.shape[0]), 0
        while s < c:
            take = min(rows - have, c - s)
            held.append(chunk[s:s + take])
            have, s = have + take, s + take
            if have == rows:
                yield start, held
                start, held, have = start + rows, [], 0
    if held:
        yield start, held


def _f32_on(part, device) -> torch.Tensor:
    if not torch.is_tensor(part):
        part = torch.from_numpy(np.asarray(part, np.float32))
    return part.to(device).float()


def _joined(parts, device) -> torch.Tensor:
    if len(parts) == 1:
        return _f32_on(parts[0], device)
    return torch.cat([_f32_on(p, device) for p in parts])


def grid_pieces(chunks_fn, n, normalize=False, device="cpu"):
    """Yield ``(start_row, piece)``: the source re-cut into the build grid,
    f32 on ``device`` and L2-normalized when ``normalize`` -- the rows of
    ``f32_rows`` over the whole matrix, piece by piece."""
    seen = 0
    for start, parts in _cut(chunks_fn(), GRID_ROWS):
        piece = _joined(parts, device)
        seen = start + piece.shape[0]
        yield start, normalize_rows(piece) if normalize else piece
    if seen != n:
        raise ValueError(f"chunk source yielded {seen} rows, n={n}")


def stream_gather_rows(chunks_fn, n, idx_sets, normalize=False, device="cpu"):
    """Gather the rows at global indices from a chunk source, in one pass.

    ``idx_sets``: one int index array, or a list of them (any order, no
    duplicates). Returns the gathered f32 rows of each set on ``device`` --
    one tensor or a list -- in the order of each index array (a sorted
    window per chunk, then a scatter back to the caller's order; the round
    trip is exact, so fits on the gathered rows equal fits on an in-memory
    gather). The rows are picked from the grid pieces on ``device``,
    normalized when ``normalize``: the rows an in-memory build samples."""
    single = not isinstance(idx_sets, (list, tuple))
    sets = [idx_sets] if single else list(idx_sets)
    orders, sorted_sets = [], []
    for idx in sets:
        idx_h = np.asarray(idx)
        order = np.argsort(idx_h, kind="stable")
        orders.append(order)
        sorted_sets.append(idx_h[order])

    rows = [[] for _ in sets]
    for off, piece in grid_pieces(chunks_fn, n, normalize=normalize, device=device):
        for si, sorted_idx in enumerate(sorted_sets):
            lo = np.searchsorted(sorted_idx, off)
            hi = np.searchsorted(sorted_idx, off + piece.shape[0])
            if hi > lo:
                rows[si].append(piece[torch.as_tensor(sorted_idx[lo:hi] - off, device=piece.device)])

    out = []
    dev = torch.device(device)
    for si in range(len(sets)):
        gathered = torch.cat(rows[si])
        rows[si] = None
        sample = torch.empty_like(gathered)
        sample[torch.as_tensor(orders[si], device=dev)] = gathered
        del gathered
        out.append(sample)
    return out[0] if single else out


def stream_encode_pieces(chunks_fn, n, chunk_rows=None, normalize=False, device="cpu"):
    """Yield ``(start_row, piece)`` with f32 pieces of ``chunk_rows`` rows
    (default: the build grid's) on ``device``, the last one shorter, cut at
    multiples of ``chunk_rows`` from the normalized build grid: the pieces
    ``row_pieces`` takes from ``f32_rows`` of the whole matrix."""
    grid = (piece for _, piece in grid_pieces(chunks_fn, n, normalize=normalize, device=device))
    for start, parts in _cut(grid, chunk_rows or GRID_ROWS):
        yield start, parts[0] if len(parts) == 1 else torch.cat(parts)
