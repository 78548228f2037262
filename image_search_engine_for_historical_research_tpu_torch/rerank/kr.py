"""k-reciprocal re-ranking as dense (or chunked) linear algebra.

Port of ``image_search_engine_for_historical_research_tpu/rerank/kr.py``
(:26-422): k1=20 reciprocal neighbours with 2/3-overlap expansion, exp(-d)
weights, k2=6 query expansion of V, Jaccard distance, and the final
``(1 - lambda) * jaccard + lambda * original`` with lambda=0.3.

- ``kr_rerank_scores``: the dense path, every set a boolean (n, n) matrix.
- ``kr_rerank_chunked``: the same ranks without any (n, n) array; the JAX
  package's scanned program becomes Python loops over row chunks, with the
  chunk sizes as arguments and the same defaults. The sparse V rows are
  compacted to ``compact_width``; if a row's set is wider the whole pass runs
  again at full width, so the ranks stay those of the full-width pass.
- ``kr_rerank``: ``method="auto"`` takes the dense path while its ~24 bytes
  per (n, n) entry fit ``max_bytes`` (8 GiB), the chunked path beyond.

Top-k selections put the lower id first among equal scores (``lax.top_k``,
``ops.topk._top``) and sorts are stable (``jnp.argsort``). The functions run
on their inputs' device. The JAX chunked program's ``stage=`` (early exits
that time each stage on a TPU) is not ported.
"""

from __future__ import annotations

import torch

from ..ops.normalization import l2n
from ..ops.topk import _matmul_f32, _top


def kr_rerank_scores(qvecs, vecs, k1: int = 20, k2: int = 6, lambda_value: float = 0.3):
    """The final distance matrix (Q, N), to be ranked ascending. Inputs are
    L2-normalized (``dist = 2 - 2 q.g``)."""
    feat = torch.cat([qvecs, vecs])
    nq, n = qvecs.shape[0], feat.shape[0]
    d = 2.0 - 2.0 * _matmul_f32(feat, feat)                        # (n, n)
    d = d / torch.clamp(d.max(dim=0, keepdim=True).values, min=1e-12)

    def topk_mask(dist, k):
        idx = _top(-dist, k)[1]
        return torch.zeros((n, n), dtype=torch.bool, device=d.device).scatter_(1, idx, True)

    nbr = topk_mask(d, k1 + 1)                                     # i -> top k1+1
    recip = nbr & nbr.T                                            # R(i, k1)
    half = topk_mask(d, int(round(k1 / 2)) + 1)
    recip_half = half & half.T                                     # R(j, k1/2)

    # expansion: include R_half(j) when |R_half(j) & R(i)| > 2/3 |R_half(j)|
    overlap = recip_half.float() @ recip.float().T                 # (j, i)
    sizes = recip_half.sum(1).float()[:, None]
    grow = (overlap > (2.0 / 3.0) * sizes) & recip.T               # (j, i)
    expanded = recip | ((grow.float().T @ recip_half.float()) > 0)

    # V: exp(-d) weights over the expanded sets, row-normalized
    w = torch.where(expanded, torch.exp(-d), 0.0)
    V = w / torch.clamp(w.sum(1, keepdim=True), min=1e-12)
    del w, expanded, overlap, grow, nbr, half

    # query expansion of V over the k2 nearest neighbours
    idx2 = _top(-d, k2)[1]
    V = V[idx2].mean(dim=1)                                        # (n, n)

    # Jaccard distance of the query rows against everything
    jaccard = torch.empty((nq, n), dtype=torch.float32, device=d.device)
    for q in range(nq):
        minsum = torch.minimum(V[q][None, :], V).sum(1)
        jaccard[q] = 1.0 - minsum / (2.0 - minsum)
    final = jaccard * (1 - lambda_value) + d[:nq] * lambda_value
    return final[:, nq:]


def _kr_chunked_program(
    feat,
    lambda_value: float,
    nq: int,
    k1: int,
    k2: int,
    row_chunk: int,
    set_chunk: int,
    jaccard_chunk: int,
    matmul_dtype,
    compact_width: int = 0,
):
    """The chunked re-rank over ``feat`` = [queries; gallery] (normalized):
    returns (ranks (Q, N) ascending, overflow). ``overflow`` is True when
    ``compact_width`` was too narrow for some row's expanded set."""
    n = feat.shape[0]
    dev = feat.device
    fb = feat.to(matmul_dtype)
    K = k1 + 1
    Kh = int(round(k1 / 2)) + 1

    def dist(rows):
        return 2.0 - 2.0 * _matmul_f32(rows, fb)

    # pass A: the column max of the raw distance (the normalizer)
    colmax = torch.full((n,), float("-inf"), device=dev)
    for s in range(0, n, row_chunk):
        colmax = torch.maximum(colmax, dist(fb[s:s + row_chunk]).max(dim=0).values)
    denom = torch.clamp(colmax, min=1e-12)[None, :]

    # pass B: top-(k1+1) of the normalized distance
    rank = torch.cat([_top(-(dist(fb[s:s + row_chunk]) / denom), K)[1]
                      for s in range(0, n, row_chunk)])              # (n, K)
    rank_h = rank[:, :Kh]

    # reciprocity: i in top(j) for each candidate j = rank[i, l]
    iexp = torch.arange(n, device=dev)[:, None, None]
    recip = (rank[rank] == iexp).any(2)                            # (n, K)
    recip_h = (rank_h[rank_h] == iexp).any(2)                      # (n, Kh)
    size_h = recip_h.sum(1).float()

    # expansion + weights: candidate j in R(i) contributes R_half(j) when
    # |R_half(j) & R(i)| > 2/3 |R_half(j)|. Sets are fixed-width padded id
    # rows (pad = n); a duplicate keeps its first sorted slot, like the
    # dense boolean OR. Member distances come from the chunk's distance row.
    vi, vv = [], []
    for s in range(0, n, set_chunk):
        rank_cc, recip_cc = rank[s:s + set_chunk], recip[s:s + set_chunk]
        r = rank_cc.shape[0]
        j = rank_cc.clamp(0, n - 1)
        Rh_idx, Rh_m = rank_h[j], recip_h[j]                       # (r, K, Kh)
        Ri = torch.where(recip_cc, rank_cc, -1)
        in_R = (Rh_idx[..., None] == Ri[:, None, None, :]).any(3) & Rh_m
        grow = recip_cc & (in_R.sum(2) > (2.0 / 3.0) * size_h[j])
        add_idx = torch.where(grow[..., None] & Rh_m, Rh_idx, n).reshape(r, K * Kh)
        base_idx = torch.where(recip_cc, rank_cc, n)
        srt = torch.sort(torch.cat([base_idx, add_idx], 1), dim=1).values
        dup = torch.cat([torch.zeros((r, 1), dtype=torch.bool, device=dev),
                         srt[:, 1:] == srt[:, :-1]], 1)
        valid = (srt < n) & ~dup
        sc = srt.clamp(0, n - 1)
        dval = (dist(fb[s:s + set_chunk]) / denom).gather(1, sc)   # (r, W)
        w = torch.where(valid, torch.exp(-dval), 0.0)
        wn = w / torch.clamp(w.sum(1, keepdim=True), min=1e-12)
        vi.append(torch.where(valid, sc, 0))
        vv.append(torch.where(valid, wn, 0.0))
    vidx, vval = torch.cat(vi), torch.cat(vv)                      # (n, W)
    W = vidx.shape[1]

    # lossless compaction: valid entries stably to the front, cut to the
    # budget; a wider row raises ``overflow`` and the caller runs again
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if compact_width and compact_width < W:
        invalid = vval <= 0.0
        order = torch.argsort(invalid.int(), dim=1, stable=True)
        vidx = vidx.gather(1, order)[:, :compact_width]
        vval = vval.gather(1, order)[:, :compact_width]
        overflow = ((~invalid).sum(1) > compact_width).any()

    # the dense query side of the query-expanded V: (nq, n) scatter-add of
    # k2 sparse rows
    nbq = rank[:nq, :k2]
    vq = torch.zeros((nq, n), dtype=torch.float32, device=dev).scatter_add_(
        1, vidx[nbq].reshape(nq, -1), (vval[nbq] / k2).reshape(nq, -1))
    vqT = vq.T                                                     # (n, nq)

    # query-expanded sparse rows -> Jaccard against the dense query side:
    # a row's k2 nearest sparse V rows concatenated, summed per column id by
    # a stable sort and a cumsum, then min-summed against vqT
    jacc = []
    for s in range(0, n, jaccard_chunk):
        nbr_cc = rank[s:s + jaccard_chunk, :k2]
        r = nbr_cc.shape[0]
        gi2 = vidx[nbr_cc].reshape(r, -1)
        gv2 = (vval[nbr_cc] / k2).reshape(r, -1)
        L = gi2.shape[1]
        si, perm = torch.sort(gi2, dim=1, stable=True)
        cs = torch.cumsum(gv2.gather(1, perm), dim=1)
        ones = torch.ones((r, 1), dtype=torch.bool, device=dev)
        last = torch.cat([si[:, :-1] != si[:, 1:], ones], 1)
        first = torch.cat([ones, si[:, 1:] != si[:, :-1]], 1)
        pos = torch.arange(L, device=dev)[None, :]
        start = torch.cummax(torch.where(first, pos, -1), dim=1).values
        base = torch.where(start > 0, cs.gather(1, (start - 1).clamp(min=0)), 0.0)
        sval = torch.where(last, cs - base, 0.0)                   # group sum at its end
        minsum = torch.minimum(sval[..., None], vqT[si]).sum(1)    # (r, nq)
        jacc.append(1.0 - minsum / (2.0 - minsum))
    jacc = torch.cat(jacc)                                         # (n, nq)

    dq = dist(fb[:nq]) / denom
    final = jacc.T * (1.0 - lambda_value) + dq * lambda_value
    return torch.argsort(final[:, nq:], dim=1, stable=True), overflow


def kr_rerank_chunked(
    qvecs,
    vecs,
    k1: int = 20,
    k2: int = 6,
    lambda_value: float = 0.3,
    row_chunk: int = 8192,
    set_chunk: int = 2048,
    jaccard_chunk: int = 8192,
    matmul_dtype=torch.float32,
    compact_width: int = 96,
):
    """Chunked k-reciprocal re-rank: the dense path's ranks (Q, N) without an
    (n, n) array. Peak memory is about n x W x 12 bytes for the sparse V plus
    transients bounded by the chunk sizes. If a row's expanded set exceeds
    ``compact_width`` the pass runs once more at full width."""
    qn = l2n(torch.as_tensor(qvecs).float())
    gn = l2n(torch.as_tensor(vecs).float())
    feat = torch.cat([qn, gn])
    kw = dict(nq=int(qn.shape[0]), k1=k1, k2=k2, row_chunk=row_chunk, set_chunk=set_chunk,
              jaccard_chunk=jaccard_chunk, matmul_dtype=matmul_dtype)
    ranks, overflow = _kr_chunked_program(feat, lambda_value, compact_width=compact_width, **kw)
    if compact_width and bool(overflow):
        # a row's expanded set outgrew the budget: run again at full width
        ranks, _ = _kr_chunked_program(feat, lambda_value, compact_width=0, **kw)
    return ranks


def kr_rerank(
    qvecs,
    vecs,
    k1: int = 20,
    k2: int = 6,
    lambda_value: float = 0.3,
    max_bytes: int = 8 << 30,
    method: str = "auto",
    matmul_dtype=torch.float32,
):
    """Ranks (Q, N) ascending by the re-ranked distance.

    ``method="auto"``: dense while its ~6 (n, n) f32 buffers (~24 bytes an
    entry) fit ``max_bytes``, chunked beyond; ``"dense"`` / ``"chunked"``
    force a path, and a forced dense path over budget raises.
    ``matmul_dtype`` (chunked path) runs its distance products in that dtype.
    """
    n = int(qvecs.shape[0]) + int(vecs.shape[0])
    est = 24 * n * n
    if method == "auto":
        method = "dense" if est <= max_bytes else "chunked"
    if method == "chunked":
        return kr_rerank_chunked(qvecs, vecs, k1=k1, k2=k2, lambda_value=lambda_value,
                                 matmul_dtype=matmul_dtype)
    if est > max_bytes:
        raise ValueError(
            f"kr_rerank(method='dense') needs ~{est / 2**30:.1f} GiB for n={n} "
            f"(queries+gallery); budget is {max_bytes / 2**30:.1f} GiB. The dense "
            "path is inherently O(n^2) (the reference's own V buffer, "
            "Reranking.py:513) — use method='chunked' (the auto default at this "
            "size) or raise max_bytes explicitly."
        )
    final = kr_rerank_scores(l2n(torch.as_tensor(qvecs)), l2n(torch.as_tensor(vecs)), k1=k1,
                             k2=k2, lambda_value=lambda_value)
    return torch.argsort(final, dim=1, stable=True)
