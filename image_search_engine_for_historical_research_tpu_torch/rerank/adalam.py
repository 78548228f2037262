"""AdaLAM spatial verification as batched torch ops with static shapes.

Port of ``image_search_engine_for_historical_research_tpu/rerank/adalam.py``
(all of it): ``DEFAULT_CONFIG``, ``_first_k_couples``, ``_orientation_diff``,
``_run_weights``, ``_sorted_count``, ``_count_inliers``, ``_select_inliers``,
``_fit_affine``, ``_ellipse_filter``, ``_adalam_impl`` and ``AdalamFilter``
(``filter_matches``, ``match_and_filter``, ``radius`` and the batched,
banked and banked-scan pair counters).

AdaLAM (seed selection by local score minima, radius / orientation /
scale-gated neighbourhoods, confidence-based local affine RANSAC with a
refit) works on dense fixed-shape rows: each neighbourhood is a row of a
``(seeds, members)`` layout capped at ``max_seeds`` x ``max_neighbors``, and
the 128 RANSAC iterations run in blocks of 16. JAX's ``vmap`` over pairs is a
leading batch dimension of ``_adalam_impl`` here; JAX's ``lax.scan`` over
pair blocks is a Python loop whose launches queue on the device with no
host round trip between blocks (nothing in a block reads a value back).

What the translation keeps from JAX:

- ``jnp.argsort`` is stable: every argsort is ``stable=True``, and the
  inverse permutation of ``_select_inliers`` is a scatter of ``arange``
  (JAX argsorts the permutation; both give the same ranks).
- ``_run_weights`` finds equal residuals after an f16 round trip
  (``.half().float()``), as JAX's ``astype(float16)`` does.
- ``.at[].max`` is ``scatter_reduce(reduce="amax", include_self=True)`` on a
  zero int32 vector.
- ``lax.top_k(-dist, 2)`` ties on ``inf`` (invalid columns) and goes through
  ``ops.topk._top_exact``.
- The block scan keeps the first best iteration within a block and takes a
  later block only on a strictly larger count.
- The 2 x 2 affine products are written out elementwise and the descriptor
  distances run with TF32 off, so products stay f32 on the card.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import _full_f32, _top_exact

DEFAULT_CONFIG = {
    "area_ratio": 100,
    "search_expansion": 4.0,
    "ransac_iters": 128,
    "min_inliers": 6,
    "min_confidence": 200.0,
    "orientation_difference_threshold": 30.0,  # degrees; None disables
    "scale_rate_threshold": 1.5,               # ratio; None disables
    "detected_scale_rate_threshold": 5.0,
    "refit": True,
    "force_seed_mnn": True,
    # Static work caps (not in the reference AdaLAM): every problem is padded
    # to fixed shapes, and score-ranked truncation at these budgets is a
    # no-op for typical scenes (~n/10 seeds, ~n/6 members a neighbourhood)
    "max_seeds": 256,
    "max_neighbors": 256,
}

BLOCK = 16  # RANSAC iterations scored together


def _first_k_couples(iters: int) -> np.ndarray:
    """Deterministic sampling schedule: exhaustive pairs over the
    best-ranked members first. Returns (iters, 2) relative member ranks."""
    m = int(np.sqrt(2 * iters + 0.25) - 0.5)
    residual = iters - m * (m + 1) // 2
    blocks = [np.full(j, j) for j in range(1, m + 1)]
    seconds = [np.arange(j) for j in range(1, m + 1)]
    if residual:
        blocks.append(np.full(residual, residual))
        seconds.append(np.arange(residual))
    first = np.concatenate(blocks) if blocks else np.zeros(0, np.int64)
    second = np.concatenate(seconds) if seconds else np.zeros(0, np.int64)
    return np.stack([first, second], axis=-1).astype(np.int32)  # (iters, 2)


def _orientation_diff(o1, o2):
    """Wrapped angular difference in degrees, range [-180, 180)."""
    diff = o2 - o1
    diff = torch.where(diff < -180.0, diff + 360.0, diff)
    return torch.where(diff >= 180.0, diff - 360.0, diff)


def _run_weights(sorted_sq):
    """1/run-length weights for half-precision-equal residual runs
    (duplicated keypoints must not over-count as inliers)."""
    r16 = sorted_sq.half().float()
    n = r16.shape[-1]
    idx = torch.arange(n, device=r16.device).expand(r16.shape)
    new = torch.cat([torch.ones(r16.shape[:-1] + (1,), dtype=torch.bool, device=r16.device),
                     r16[..., 1:] != r16[..., :-1]], dim=-1)
    start = torch.cummax(torch.where(new, idx, -1), dim=-1).values
    nxt = torch.where(new, idx, n)
    suffix_min = torch.flip(torch.cummin(torch.flip(nxt, (-1,)), dim=-1).values, (-1,))
    next_start = torch.cat([suffix_min[..., 1:], torch.full(r16.shape[:-1] + (1,), n,
                                                             device=r16.device)], dim=-1)
    runlen = (next_start - 1) - start + 1
    return 1.0 / runlen.float()


def _sorted_count(sorted_sq, min_confidence):
    """count / total / largest from value-sorted residuals."""
    finite = torch.isfinite(sorted_sq)
    zero = torch.zeros((), device=sorted_sq.device)
    w = torch.where(finite, _run_weights(sorted_sq), zero)
    too_perfect = sorted_sq <= 1e-8
    w = torch.where(too_perfect, zero, w)

    total = torch.sum(w, dim=-1, keepdim=True)
    rate = torch.cumsum(w, dim=-1) / torch.clamp(total, min=1e-12)
    good = ((sorted_sq * min_confidence <= rate) | too_perfect) & finite
    count = torch.floor(torch.sum(torch.where(good, w, zero), dim=-1)).to(torch.int32)

    pos = torch.clamp(count - 1, min=0).long()[..., None]
    largest = torch.gather(sorted_sq, -1, pos)[..., 0]
    largest = torch.where(count > 0, largest, zero)
    return count, total[..., 0], largest


def _count_inliers(res_sq, member, min_confidence):
    """Count-only selection for the RANSAC block scan: a values-only sort
    (the counts depend only on the sorted values)."""
    key = torch.where(member, res_sq, torch.full((), torch.inf, device=res_sq.device))
    count, _, _ = _sorted_count(torch.sort(key, dim=-1).values, min_confidence)
    return count


def _select_inliers(res_sq, member, min_confidence):
    """Confidence-based inlier selection on dense rows.

    ``res_sq`` / ``member``: (..., n). Returns (count int, total_weight,
    largest_accepted_sq, inlier_prefix_mask in original keypoint order).
    """
    key = torch.where(member, res_sq, torch.full((), torch.inf, device=res_sq.device))
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_sq = torch.gather(key, -1, order)
    count, total, largest = _sorted_count(sorted_sq, min_confidence)
    pos = torch.arange(key.shape[-1], device=key.device).expand(order.shape)
    rank = torch.empty_like(order).scatter_(-1, order, pos)   # inverse permutation
    return count, total, largest, rank < count[..., None].long()


def _mat2(a, b):
    """``a @ b`` of (..., 2, 2) matrices, written out elementwise."""
    return torch.stack([
        torch.stack([a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                     for j in range(2)], -1)
        for i in range(2)], -2)


def _inv2(m, det_floor):
    """Inverse of (..., 2, 2) matrices whose small determinants are floored."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < det_floor, torch.full_like(det, det_floor), det)
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[..., None,
                                                                                       None]


def _fit_affine(px, py, det_floor=1e-10):
    """Minimal 2-point affine fit: rows of ``px`` (..., 2, 2) map to ``py``
    via ``px @ A^T = py``."""
    return _mat2(_inv2(px, det_floor), py).transpose(-1, -2)


def _ellipse_filter(A, det_thr):
    """Replace affinities with out-of-range singular values by identity
    (eigenvalues of A A^T)."""
    am, bm = A[..., 0, 0], A[..., 0, 1]
    cm, dm = A[..., 1, 0], A[..., 1, 1]
    a = am ** 2 + bm ** 2
    b = am * cm + bm * dm
    d = cm ** 2 + dm ** 2
    trh = (a + d) / 2
    disc = torch.sqrt(((a - d) / 2) ** 2 + b ** 2)
    ev_hi = torch.clamp(trh + disc, min=0.0)
    ev_lo = torch.clamp(trh - disc, min=0.0)
    bad = (ev_lo < 1.0 / det_thr ** 2) | (ev_hi > det_thr ** 2)
    eye = torch.eye(2, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.where(bad[..., None, None], eye, A)


def _residuals(x_rel, y_rel, A):
    """Squared residuals of ``x_rel @ A^T`` against ``y_rel``.
    ``x_rel`` / ``y_rel``: (P, ns, mn, 2); ``A``: (P, ns, 2, 2) -> (P, ns, mn),
    or (P, B, ns, 2, 2) -> (P, B, ns, mn)."""
    if A.dim() == 5:
        x_rel, y_rel = x_rel[:, None], y_rel[:, None]
    x0, x1 = x_rel[..., 0], x_rel[..., 1]
    p0 = x0 * A[..., 0, 0, None] + x1 * A[..., 0, 1, None]
    p1 = x0 * A[..., 1, 0, None] + x1 * A[..., 1, 1, None]
    return (p0 - y_rel[..., 0]) ** 2 + (p1 - y_rel[..., 1]) ** 2


def _rows(a, idx):
    """``a[p, idx[p, ...]]`` for a (P, n, ...) tensor and (P, ...) ids."""
    P = a.shape[0]
    bi = torch.arange(P, device=a.device).reshape((P,) + (1,) * (idx.dim() - 1))
    return a[bi, idx]


def _adalam_impl(
    k1, k2, fnn12, scores1, mnn, o1, o2, s1, s2, valid1, R1, R2,
    *,
    iters: int,
    refit: bool,
    use_orientation: bool,
    use_scale: bool,
    search_expansion: float,
    min_inliers: int,
    min_confidence: float,
    orientation_thr: float,
    scale_rate_thr: float,
    det_thr: float,
    block: int,
    max_seeds: int = 256,
    max_neighbors: int = 256,
):
    """The AdaLAM filter of ``P`` pairs at once: keypoints ``k1 (P, n1, 2)``,
    ``k2 (P, n2, 2)``, matches ``fnn12 (P, n1)`` with ratio ``scores1``,
    the mutual-NN mask ``mnn`` (or None), orientations (degrees), scales,
    ``valid1`` and the radii ``R1`` / ``R2`` (P,). Returns (keep (P, n1),
    count, conf, seed_idx)."""
    P, n1 = k1.shape[:2]
    dev = k1.device
    inf = torch.full((), torch.inf, device=dev)
    R1 = R1.reshape(P, 1, 1)
    R2 = R2.reshape(P, 1, 1)

    # --- seed selection: local minima of the ratio score ---
    d1 = torch.sum((k1[:, :, None, :] - k1[:, None, :, :]) ** 2, dim=-1)   # (P, n1, n1)
    neigh = d1 < R1 ** 2
    better = scores1[:, :, None] > scores1[:, None, :]     # (i, j): j beats i
    consider = neigh & better & valid1[:, None, :]
    if mnn is not None:
        consider = consider & mnn[:, None, :]
        seed_mask = ~torch.any(consider, dim=2) & mnn
    else:
        seed_mask = ~torch.any(consider, dim=2)
    seed_mask = seed_mask & (scores1 < 0.8 ** 2) & valid1

    # static seed budget, best score first
    ns = min(n1, max_seeds)
    seed_idx = torch.argsort(torch.where(seed_mask, scores1, inf), dim=1, stable=True)[:, :ns]
    seed_valid = torch.gather(seed_mask, 1, seed_idx)

    # --- neighbourhood sets ---
    f_seed = torch.gather(fnn12, 1, seed_idx)
    dst1 = _rows(d1, seed_idx)                             # (P, ns, n1)
    k2m = _rows(k2, fnn12)                                 # (P, n1, 2)
    k2s = _rows(k2, f_seed)                                # (P, ns, 2)
    dst2 = torch.sum((k2s[:, :, None, :] - k2m[:, None, :, :]) ** 2, dim=-1)

    se = search_expansion
    member = (dst1 < (se * R1) ** 2) & (dst2 < (se * R2) ** 2)
    member = member & valid1[:, None, :] & seed_valid[:, :, None]

    if use_orientation:
        relo = _orientation_diff(o1, torch.gather(o2, 1, fnn12))
        od = torch.abs(_orientation_diff(relo[:, None, :],
                                         torch.gather(relo, 1, seed_idx)[:, :, None]))
        member = member & (od < orientation_thr)
    if use_scale:
        rels = torch.gather(s2, 1, fnn12) / torch.clamp(s1, min=1e-12)
        rate = torch.gather(rels, 1, seed_idx)[:, :, None] / torch.clamp(rels[:, None, :],
                                                                         min=1e-12)
        member = member & (rate < scale_rate_thr) & (rate > 1.0 / scale_rate_thr)

    # --- compact member layout: each seed's top-``mn`` members by score ---
    mn = min(n1, max_neighbors)
    member_key = torch.where(member, scores1[:, None, :], inf)
    mem_idx = torch.argsort(member_key, dim=2, stable=True)[:, :, :mn]   # (P, ns, mn)
    member_c = torch.gather(member, 2, mem_idx)

    rdims = torch.sum(member_c, dim=2)
    seed_ok = rdims >= min_inliers
    member_c = member_c & seed_ok[:, :, None]
    rdims = torch.where(seed_ok, rdims, torch.zeros_like(rdims))

    # --- relative, radius-normalized coordinates ---
    k1_seed = _rows(k1, seed_idx)                          # (P, ns, 2)
    x_rel = (_rows(k1, mem_idx) - k1_seed[:, :, None, :]) / (R1[..., None] * se)
    y_rel = (_rows(k2m, mem_idx) - k2s[:, :, None, :]) / (R2[..., None] * se)

    schedule = torch.as_tensor(_first_k_couples(iters), dtype=torch.int64, device=dev)
    rdim_safe = torch.clamp(rdims, min=1)                  # (P, ns)
    pi = torch.arange(P, device=dev)
    si = torch.arange(ns, device=dev)

    def sample(rel):
        """(P, ..., ns, 2) member ranks -> the (P, ..., ns, 2, 2) sampled
        relative coordinates in both images."""
        b, s = pi.reshape((P,) + (1,) * (rel.dim() - 1)), si[:, None]
        return x_rel[b, s, rel], y_rel[b, s, rel]

    # --- the RANSAC iterations in blocks, the best iteration per seed ---
    best_cnt = torch.full((P, ns), -1, dtype=torch.int32, device=dev)
    best_it = torch.zeros((P, ns), dtype=torch.int64, device=dev)
    for start in range(0, iters, block):
        rows = schedule[start:start + block]
        ids = torch.arange(start, start + block, device=dev)
        if rows.shape[0] < block:          # the last block, padded as JAX pads
            rows = torch.cat([rows, rows.new_zeros((block - rows.shape[0], 2))])
        rel = rows[None, :, None, :] % rdim_safe[:, None, :, None]   # (P, block, ns, 2)
        A = _fit_affine(*sample(rel))
        if not refit:
            A = _ellipse_filter(A, det_thr)
        cnt = _count_inliers(_residuals(x_rel, y_rel, A), member_c[:, None], min_confidence)
        cnt = torch.where((ids < iters)[None, :, None], cnt, torch.full_like(cnt, -1))
        blk_arg = torch.argmax(cnt, dim=1)                 # first max in the block
        blk_best = torch.gather(cnt, 1, blk_arg[:, None])[:, 0]
        take = blk_best > best_cnt                         # strict: keep the earliest
        best_it = torch.where(take, start + blk_arg, best_it)
        best_cnt = torch.where(take, blk_best, best_cnt)

    # --- the best iteration per seed again, with full statistics ---
    rel = schedule[best_it] % rdim_safe[..., None]         # (P, ns, 2)
    A = _fit_affine(*sample(rel))
    if not refit:
        A = _ellipse_filter(A, det_thr)
    count, total_w, largest, inl = _select_inliers(_residuals(x_rel, y_rel, A), member_c,
                                                   min_confidence)

    if refit:
        # least-squares refit over the selected inliers
        zero = torch.zeros((), device=dev)
        Xm = torch.where(inl[..., None], x_rel, zero)
        Ym = torch.where(inl[..., None], y_rel, zero)
        XtX = torch.sum(Xm[..., :, None] * Xm[..., None, :], dim=2)     # (P, ns, 2, 2)
        YtX = torch.sum(Ym[..., :, None] * Xm[..., None, :], dim=2)
        A = _ellipse_filter(_mat2(YtX, _inv2(XtX, 1e-10)), det_thr)
        count, total_w, largest, inl = _select_inliers(_residuals(x_rel, y_rel, A), member_c,
                                                       min_confidence)

    expected = total_w * largest
    countf = count.float()
    conf = torch.where(expected > 0, countf / expected, torch.zeros_like(expected))
    seed_pass = (conf >= min_confidence) & (
        countf * (1.0 - 1.0 / torch.clamp(conf, min=1e-12)) >= min_inliers)
    # scatter compact inliers back to keypoint order (duplicate-index max)
    contrib = (inl & seed_pass[..., None] & member_c).to(torch.int32)
    keep = torch.zeros((P, n1), dtype=torch.int32, device=dev).scatter_reduce(
        1, mem_idx.reshape(P, -1), contrib.reshape(P, -1), reduce="amax",
        include_self=True) > 0

    # fallback when no seed survives: plain ratio test
    ratio_keep = (scores1 < 0.8 ** 2) & valid1
    keep = torch.where(torch.any(seed_ok, dim=1)[:, None], keep, ratio_keep)
    return keep, count, conf, seed_idx


def _match(d1, d2, valid1, valid2, force_mnn: bool):
    """NN matching of ``P`` pairs: squared-L2 distances, the Lowe ratio of
    the two nearest, the mutual-NN mask. Returns (fnn12, scores, mnn)."""
    P, n1 = d1.shape[:2]
    with _full_f32():
        dist = (torch.sum(d1 ** 2, -1)[:, :, None] + torch.sum(d2 ** 2, -1)[:, None, :]
                - 2.0 * torch.bmm(d1, d2.transpose(1, 2)))
    inf = torch.full((), torch.inf, device=d1.device)
    dist = torch.where(valid2[:, None, :], dist, inf)
    dd, nn = _top_exact(-dist.reshape(P * n1, -1), 2)
    dd, nn = -dd.reshape(P, n1, 2), nn.reshape(P, n1, 2)
    fnn12 = nn[..., 0]
    scores = dd[..., 0] / torch.clamp(dd[..., 1], min=1e-3)
    mnn = None
    if force_mnn:
        back = torch.argmin(torch.where(valid1[:, :, None], dist, inf), dim=1)   # (P, n2)
        mnn = torch.gather(back, 1, fnn12) == torch.arange(n1, device=d1.device)
    return fnn12, torch.where(valid1, scores, inf), mnn


class AdalamFilter:
    """Counterpart of the reference's ``AdalamFilter``, on ``device``.

    ``filter_matches`` / ``match_and_filter`` return a boolean keep-mask over
    the source keypoints (the reference's unique (i, fnn12[i]) list) plus the
    matched indices, as numpy.
    """

    def __init__(self, custom_config: Optional[dict] = None, device="cuda"):
        self.config = dict(DEFAULT_CONFIG)
        if custom_config:
            unknown = set(custom_config) - set(self.config)
            if unknown:
                raise ValueError(f"unknown AdaLAM config keys: {sorted(unknown)}")
            self.config.update(custom_config)
        self.device = resolve_device(device)
        c = self.config
        othr = c["orientation_difference_threshold"]
        sthr = c["scale_rate_threshold"]
        self._core = partial(
            _adalam_impl,
            iters=int(c["ransac_iters"]),
            refit=bool(c["refit"]),
            use_orientation=othr is not None and othr < 180,
            use_scale=sthr is not None and sthr < 10,
            search_expansion=float(c["search_expansion"]),
            min_inliers=int(c["min_inliers"]),
            min_confidence=float(c["min_confidence"]),
            orientation_thr=float(othr if othr is not None else 180.0),
            scale_rate_thr=float(sthr if sthr is not None else 10.0),
            det_thr=float(c["detected_scale_rate_threshold"]),
            block=BLOCK,
            max_seeds=int(c["max_seeds"]),
            max_neighbors=int(c["max_neighbors"]),
        )

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def filter_matches(
        self,
        k1,
        k2,
        fnn12,
        scores1,
        mnn=None,
        im1shape: Optional[Tuple[int, int]] = None,
        im2shape: Optional[Tuple[int, int]] = None,
        o1=None,
        o2=None,
        s1=None,
        s2=None,
        valid1=None,
    ):
        """Run the filter on one pair. Returns (keep_mask (n1,) bool,
        matches (kept_i, fnn12[kept_i]) as an (m, 2) int array)."""
        k1, k2, scores1 = self._t(k1), self._t(k2), self._t(scores1)
        fnn12 = self._t(fnn12, torch.int64)
        n1 = k1.shape[0]
        valid1 = (torch.ones((n1,), dtype=torch.bool, device=self.device) if valid1 is None
                  else self._t(valid1, torch.bool))
        c = self.config
        if im1shape is None:
            im1shape = tuple((k1.max(0).values - k1.min(0).values).cpu().numpy())
        if im2shape is None:
            im2shape = tuple((k2.max(0).values - k2.min(0).values).cpu().numpy())
        R1, R2 = self.radius(im1shape), self.radius(im2shape)

        othr = c["orientation_difference_threshold"]
        sthr = c["scale_rate_threshold"]
        if othr is not None and othr < 180 and (o1 is None or o2 is None):
            raise ValueError("orientation gating enabled but o1/o2 not given")
        if sthr is not None and sthr < 10 and (s1 is None or s2 is None):
            raise ValueError("scale gating enabled but s1/s2 not given")

        zeros1 = torch.zeros((n1,), device=self.device)
        zeros2 = torch.zeros((k2.shape[0],), device=self.device)
        keep, _, _, _ = self._core(
            k1[None], k2[None], fnn12[None], scores1[None],
            None if mnn is None else self._t(mnn, torch.bool)[None],
            (self._t(o1) if o1 is not None else zeros1)[None],
            (self._t(o2) if o2 is not None else zeros2)[None],
            (self._t(s1) if s1 is not None else zeros1 + 1)[None],
            (self._t(s2) if s2 is not None else zeros2 + 1)[None],
            valid1[None], self._t([R1]), self._t([R2]),
        )
        keep_np = keep[0].cpu().numpy()
        kept = np.nonzero(keep_np)[0]
        return keep_np, np.stack([kept, fnn12.cpu().numpy()[kept]], axis=1)

    def make_batched_counter(self):
        """Pair-batched surviving-match counter: ``counter(k1 (B,K,2), k2,
        d1 (B,K,128), d2, o1 (B,K), o2, s1, s2, valid1 (B,K), valid2, R1 (B,),
        R2 (B,)) -> counts (B,)`` int32, on the inputs' device. Matching
        semantics are those of ``match_and_filter``."""
        force_mnn = bool(self.config["force_seed_mnn"])

        def counter(k1, k2, d1, d2, o1, o2, s1, s2, valid1, valid2, R1, R2):
            fnn12, scores, mnn = _match(d1, d2, valid1, valid2, force_mnn)
            keep, _, _, _ = self._core(k1, k2, fnn12, scores, mnn, o1, o2, s1, s2, valid1,
                                       R1, R2)
            return keep.sum(1).to(torch.int32)

        return counter

    def make_banked_counter(self):
        """Pair counter over a device-resident feature bank:
        ``counter(xy (U,K,2), desc (U,K,128), odeg (U,K), sc (U,K),
        valid (U,K), R (U,), iq (B,), ic (B,)) -> counts (B,)``; the pairs'
        features are gathered from the bank by index on the device."""
        pairwise = self.make_batched_counter()

        def counter(xy, desc, odeg, sc, valid, R, iq, ic):
            return pairwise(xy[iq], xy[ic], desc[iq], desc[ic], odeg[iq], odeg[ic],
                            sc[iq], sc[ic], valid[iq], valid[ic], R[iq], R[ic])

        return counter

    def make_banked_scan_counter(self):
        """The banked counter over ``(nb, B)`` pair-index blocks:
        ``counter(bank..., iq (nb, B), ic (nb, B)) -> counts (nb, B)``. The
        blocks run one after another on the device with no host round trip
        between them (JAX's one-dispatch ``lax.scan``)."""
        banked = self.make_banked_counter()

        def counter(xy, desc, odeg, sc, valid, R, iq, ic):
            return torch.stack([banked(xy, desc, odeg, sc, valid, R, bq, bc)
                                for bq, bc in zip(iq, ic)])

        return counter

    def radius(self, imshape: Tuple[int, int]) -> float:
        """AdaLAM neighbourhood radius for an image shape."""
        return float(np.sqrt(np.prod(imshape[:2]) / self.config["area_ratio"] / np.pi))

    def match_and_filter(
        self, k1, k2, d1, d2,
        im1shape=None, im2shape=None, o1=None, o2=None, s1=None, s2=None,
        valid1=None, valid2=None,
    ):
        """NN matching + ratio scores + MNN mask + filtering of one pair.

        ``d1`` / ``d2`` are raw descriptors; distances are squared L2 and
        scores the squared Lowe ratio, as in the reference driver.
        """
        d1, d2 = self._t(d1), self._t(d2)
        n1, n2 = d1.shape[0], d2.shape[0]
        v1 = (torch.ones((n1,), dtype=torch.bool, device=self.device) if valid1 is None
              else self._t(valid1, torch.bool))
        v2 = (torch.ones((n2,), dtype=torch.bool, device=self.device) if valid2 is None
              else self._t(valid2, torch.bool))
        fnn12, scores, mnn = _match(d1[None], d2[None], v1[None], v2[None],
                                    bool(self.config["force_seed_mnn"]))
        return self.filter_matches(
            k1, k2, fnn12[0], scores[0], None if mnn is None else mnn[0], im1shape, im2shape,
            o1, o2, s1, s2, valid1=v1,
        )
