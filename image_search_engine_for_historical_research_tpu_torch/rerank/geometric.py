"""Local-feature geometric verification re-ranking (the SAHA / AdaLAM path).

Port of the SIFT half of
``image_search_engine_for_historical_research_tpu/rerank/geometric.py``
(:1-490): ``LocalFeatures`` (the same npz both ways), ``sift_extract``
(OpenCV on the host), ``sift_extract_device`` (JAX's ``sift_extract_tpu``:
``ops.sift`` on ``device``), ``sift_offline``, ``_match_and_verify_impl``,
``make_verifier``, ``make_adalam_verifier``, ``rerank_by_inliers``,
``adalam_count_pairs`` (both ``dispatch`` modes), ``sift_rerank``, and
(:492-604) ``loftr_rerank``, the detector-free LoFTR re-rank.

SIFT keypoints come from OpenCV on the host (``backend="cv2"``, imported
when first used, so a machine without OpenCV fails there) or from the
port's device SIFT (``backend="device"``; ``"tpu"``, JAX's name for it, is
taken as the same). Matching and verification run on ``device``: mutual-NN
ratio-test matching is one matmul a pair, and AdaLAM runs on pair batches
gathered from a feature bank that is uploaded once. The re-rank re-sorts
the top-``b`` candidates of each query by their verified match counts
(stably).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import _full_f32, _top_exact
from ..utils import tracing

MAX_KPTS = 1024  # fixed keypoint budget per image (static shapes)
DEVICE_BACKENDS = ("device", "tpu")


@dataclass
class LocalFeatures:
    """Padded per-image local features: positions, scale, angle, descriptors."""

    xy: np.ndarray      # (MAX_KPTS, 2) float32
    scale: np.ndarray   # (MAX_KPTS,) float32
    angle: np.ndarray   # (MAX_KPTS,) float32 radians
    desc: np.ndarray    # (MAX_KPTS, 128) float32, L2-normalized rows
    count: int
    shape: Tuple[int, int]

    def save(self, path: str):
        np.savez(
            path, xy=self.xy, scale=self.scale, angle=self.angle,
            desc=self.desc, count=self.count, shape=np.asarray(self.shape),
        )

    @classmethod
    def load(cls, path: str) -> "LocalFeatures":
        z = np.load(path)
        return cls(
            xy=z["xy"], scale=z["scale"], angle=z["angle"], desc=z["desc"],
            count=int(z["count"]), shape=tuple(int(x) for x in z["shape"]),
        )


def _check_backend(backend: str):
    if backend != "cv2" and backend not in DEVICE_BACKENDS:
        raise ValueError(f"unknown SIFT backend {backend!r}: cv2, device (or tpu)")


def sift_extract(
    image_path: str,
    resize: Optional[Tuple[int, int]] = (1000, 1000),
    max_kpts: int = MAX_KPTS,
) -> LocalFeatures:
    """OpenCV SIFT with a fixed keypoint budget (the reference resizes to
    1000 x 1000 and runs ``cv2.SIFT_create``)."""
    import cv2

    img = cv2.imread(image_path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(image_path)
    if resize is not None:
        img = cv2.resize(img, resize)
    sift = cv2.SIFT_create(nfeatures=max_kpts)
    kpts, desc = sift.detectAndCompute(img, None)

    out = LocalFeatures(
        xy=np.zeros((max_kpts, 2), np.float32),
        scale=np.zeros((max_kpts,), np.float32),
        angle=np.zeros((max_kpts,), np.float32),
        desc=np.zeros((max_kpts, 128), np.float32),
        count=0,
        shape=img.shape[:2],
    )
    if not kpts:
        return out
    n = min(len(kpts), max_kpts)
    out.count = n
    out.xy[:n] = np.asarray([k.pt for k in kpts[:n]], np.float32)
    out.scale[:n] = np.asarray([k.size for k in kpts[:n]], np.float32)
    out.angle[:n] = np.deg2rad(np.asarray([k.angle for k in kpts[:n]], np.float32))
    d = np.asarray(desc[:n], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    out.desc[:n] = d
    return out


def sift_extract_device(
    paths: Sequence[str],
    resize: Optional[Tuple[int, int]] = (1000, 1000),
    max_kpts: int = MAX_KPTS,
    batch_size: int = 8,
    n_octaves: int = 4,
    device="cuda",
) -> List[LocalFeatures]:
    """Device SIFT (``ops.sift``) over batches of ``batch_size`` images, the
    counterpart of JAX's ``sift_extract_tpu``. Keypoint ``scale`` is stored
    as 2 * sigma; AdaLAM reads only scale ratios, so any consistent
    convention works, but stores from cv2 and from the device must not be
    mixed."""
    from PIL import Image

    from ..ops import sift as sift_ops

    device = resolve_device(device)
    feats: List[LocalFeatures] = []
    for start in range(0, len(paths), batch_size):
        imgs = []
        for p in paths[start:start + batch_size]:
            im = Image.open(p).convert("L")
            if resize is not None:
                im = im.resize(resize)  # (W, H), cv2.resize's convention
            imgs.append(np.asarray(im, np.float32) / 255.0)
        arr = np.stack(imgs)
        for f in sift_ops.sift_extract_batch(arr, max_kpts, n_octaves, device=device):
            feats.append(LocalFeatures(
                xy=f["xy"].astype(np.float32),
                scale=(2.0 * f["scale"]).astype(np.float32),
                angle=f["angle"].astype(np.float32),
                desc=f["desc"].astype(np.float32),
                count=int(f["count"]),
                shape=arr.shape[1:3],
            ))
    return feats


def _store_path(store_dir: str, image_path: str) -> str:
    return os.path.join(store_dir, os.path.splitext(os.path.basename(image_path))[0] + ".npz")


def sift_offline(
    paths: Sequence[str],
    store_dir: str,
    resize=(1000, 1000),
    max_kpts: int = MAX_KPTS,
    backend: str = "cv2",
    batch_size: int = 8,
    device="cuda",
) -> List[str]:
    """Persist SIFT features per image (the SAHA offline half), skipping
    images already in the store. ``backend="device"`` extracts whole batches
    with ``ops.sift`` on ``device``."""
    _check_backend(backend)
    device = resolve_device(device)
    os.makedirs(store_dir, exist_ok=True)
    out = [_store_path(store_dir, p) for p in paths]
    missing = [(p, dst) for p, dst in zip(paths, out) if not os.path.exists(dst)]
    if missing and backend in DEVICE_BACKENDS:
        feats = sift_extract_device([p for p, _ in missing], resize, max_kpts, batch_size,
                                    device=device)
        for (_, dst), lf in zip(missing, feats):
            lf.save(dst)
    else:
        for p, dst in missing:
            sift_extract(p, resize, max_kpts).save(dst)
    return out


# ------------------------------------------------------- matching + RANSAC


def _match_and_verify_impl(xy1, sc1, an1, d1, n1, xy2, sc2, an2, d2, n2,
                           ratio: float, inlier_px: float, min_confidence: float):
    """Mutual-NN ratio matches + one-match similarity-hypothesis votes.

    Returns the verified inlier count (0-d int32) and the match count."""
    K = xy1.shape[0]
    dev = xy1.device
    ar = torch.arange(K, device=dev)
    valid1 = ar < n1
    valid2 = ar < n2

    with _full_f32():
        sims = d1 @ d2.T                                   # descriptors are L2 normalized
    sims = torch.where(valid1[:, None] & valid2[None, :], sims, torch.full((), -1.0, device=dev))

    # ratio test via top-2 (distance ratio on the unit sphere: d^2 = 2 - 2 s)
    top2, idx2 = _top_exact(sims, 2)
    best2 = idx2[:, 0]
    dist_sq = torch.clamp(2.0 - 2.0 * top2, min=1e-12)
    ratio_ok = dist_sq[:, 0] < (ratio ** 2) * dist_sq[:, 1]

    # mutual nearest neighbours
    back = torch.argmax(sims, dim=0)                       # best row for each column
    mutual = back[best2] == ar
    match_ok = ratio_ok & mutual & valid1
    m2 = best2

    # hypotheses: each match proposes a similarity transform from its
    # keypoints' scale ratio, angle delta and translation
    s_ratio = torch.where(sc1 > 0, sc2[m2] / torch.clamp(sc1, min=1e-6), torch.ones_like(sc1))
    d_angle = an2[m2] - an1
    cos, sin = torch.cos(d_angle), torch.sin(d_angle)
    x1, y1 = xy1[:, 0], xy1[:, 1]
    tgt = xy2[m2]                                          # (K, 2)
    # hypothesis h maps p to s_h R_h p + t_h, t_h = xy2[m2[h]] - s_h R_h xy1[h]
    tx = tgt[:, 0] - s_ratio * (cos * x1 - sin * y1)
    ty = tgt[:, 1] - s_ratio * (sin * x1 + cos * y1)
    px = s_ratio[:, None] * (x1[None, :] * cos[:, None] - y1[None, :] * sin[:, None]) + tx[:, None]
    py = s_ratio[:, None] * (x1[None, :] * sin[:, None] + y1[None, :] * cos[:, None]) + ty[:, None]
    resid = torch.sqrt((px - tgt[None, :, 0]) ** 2 + (py - tgt[None, :, 1]) ** 2)   # (h, i)
    votes = ((resid < inlier_px) & match_ok[None, :]).sum(1)
    votes = torch.where(match_ok, votes, torch.zeros_like(votes))
    best = votes.max()
    best = torch.where(best >= min_confidence, best, torch.zeros_like(best))
    return best.to(torch.int32), match_ok.sum()


def make_verifier(ratio: float = 0.9, inlier_px: float = 15.0, min_confidence: int = 6,
                  device="cuda"):
    """Pair verifier on ``device``: (LocalFeatures, LocalFeatures) -> inlier count."""
    dev = resolve_device(device)

    def verify(f1: LocalFeatures, f2: LocalFeatures) -> int:
        t = [torch.as_tensor(a, device=dev) for a in (f1.xy, f1.scale, f1.angle, f1.desc,
                                                      f2.xy, f2.scale, f2.angle, f2.desc)]
        inliers, _ = _match_and_verify_impl(*t[:4], f1.count, *t[4:], f2.count, ratio=ratio,
                                            inlier_px=inlier_px, min_confidence=min_confidence)
        return int(inliers)

    return verify


def make_adalam_verifier(custom_config: Optional[dict] = None, device="cuda"):
    """Pair verifier running the full AdaLAM filter (``rerank.adalam``) on
    ``device``: NN matching + ratio scores + MNN, then seed-based local
    affine RANSAC; the returned count is the number of surviving matches
    (what SAHA sorts candidates by)."""
    from .adalam import AdalamFilter

    filt = AdalamFilter(custom_config, device=device)

    def verify(f1: LocalFeatures, f2: LocalFeatures) -> int:
        if f1.count < 2 or f2.count < 2:
            return 0
        keep, _ = filt.match_and_filter(
            f1.xy, f2.xy, f1.desc, f2.desc,
            im1shape=f1.shape, im2shape=f2.shape,
            o1=np.degrees(f1.angle), o2=np.degrees(f2.angle),
            s1=f1.scale, s2=f2.scale,
            valid1=np.arange(f1.xy.shape[0]) < f1.count,
            valid2=np.arange(f2.xy.shape[0]) < f2.count,
        )
        return int(keep.sum())

    return verify


# ------------------------------------------------------------ rerank drivers


def rerank_by_inliers(ranks: np.ndarray, counts: np.ndarray, b: int) -> np.ndarray:
    """Stable re-sort of the top-b candidates by descending inlier count
    (the reference's bubble sort is exactly this)."""
    ranks = np.asarray(ranks).copy()
    order = np.argsort(-counts, axis=1, kind="stable")
    for qi in range(ranks.shape[0]):
        ranks[qi, :b] = ranks[qi, order[qi]]
    return ranks


def adalam_count_pairs(
    feats_q: Sequence[LocalFeatures],
    feats_c: Sequence[LocalFeatures],
    custom_config: Optional[dict] = None,
    pair_batch: int = 8,
    dispatch: str = "scan",
    device="cuda",
) -> np.ndarray:
    """Surviving-AdaLAM-match counts for a list of feature pairs, on ``device``.

    Unique ``LocalFeatures`` objects go into a feature bank uploaded once (a
    query's features repeat across its b candidate pairs); pairs are
    gathered from it by index on the device, ``pair_batch`` at a time.
    ``dispatch="scan"`` queues every pair block before reading any count
    back; ``dispatch="loop"`` reads each block's counts back before the
    next. Returns (len(pairs),) int64."""
    from .adalam import AdalamFilter

    if dispatch not in ("scan", "loop"):
        raise ValueError(f"dispatch={dispatch!r}: scan or loop")
    dev = resolve_device(device)
    filt = AdalamFilter(custom_config, device=dev)
    P = len(feats_q)
    if P == 0:
        return np.zeros((0,), np.int64)
    K = feats_q[0].xy.shape[0]

    bank: list = []
    slot: dict = {}

    def bid(f):
        if id(f) not in slot:
            slot[id(f)] = len(bank)
            bank.append(f)
        return slot[id(f)]

    iq = np.array([bid(f) for f in feats_q], np.int64)
    ic = np.array([bid(f) for f in feats_c], np.int64)

    def up(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    xy = up(np.stack([f.xy for f in bank]))
    desc = up(np.stack([f.desc for f in bank]))
    odeg = up(np.degrees(np.stack([f.angle for f in bank])))
    sc = up(np.stack([f.scale for f in bank]))
    valid = up(np.stack([np.arange(K) < f.count for f in bank]), torch.bool)
    R = up([filt.radius(f.shape) for f in bank])

    nb = -(-P // pair_batch)
    pad = nb * pair_batch - P               # pad to whole blocks with the last pair
    iq_p = up(np.concatenate([iq, np.full(pad, iq[-1])]), torch.int64).reshape(nb, pair_batch)
    ic_p = up(np.concatenate([ic, np.full(pad, ic[-1])]), torch.int64).reshape(nb, pair_batch)
    if dispatch == "scan":
        out = filt.make_banked_scan_counter()(xy, desc, odeg, sc, valid, R, iq_p, ic_p)
        return out.reshape(-1)[:P].cpu().numpy().astype(np.int64)
    counter = filt.make_banked_counter()
    counts = np.zeros((nb * pair_batch,), np.int64)
    for b in range(nb):
        counts[b * pair_batch:(b + 1) * pair_batch] = counter(
            xy, desc, odeg, sc, valid, R, iq_p[b], ic_p[b]).cpu().numpy()
    return counts[:P]


def sift_rerank(
    query_paths: Sequence[str],
    db_paths: Sequence[str],
    ranks: np.ndarray,
    b: int = 30,
    store_dir: Optional[str] = None,
    resize=(1000, 1000),
    verifier=None,
    pair_batch: int = 8,
    backend: str = "cv2",
    device="cuda",
):
    """SAHA-style re-rank: verify each query against its top-b candidates.
    ``ranks`` is row-major (Q, >= b). With ``store_dir``, features are
    persisted and reused (the offline half).

    Default path: the full AdaLAM filter over pairs stacked into batches of
    ``pair_batch`` (``adalam_count_pairs``). Pass a ``verifier`` (e.g.
    ``make_verifier()``) for the sequential per-pair path instead. Each
    image's features are extracted once; with the device backend, the
    images the re-rank needs are extracted up front in full batches."""
    _check_backend(backend)
    device = resolve_device(device)
    ranks = np.asarray(ranks)
    Q = len(query_paths)
    b = min(b, ranks.shape[1]) if ranks.size else 0
    if Q == 0 or b == 0:
        return ranks
    on_device = backend in DEVICE_BACKENDS
    cache: dict = {}

    if on_device:
        needed, seen = [], set()
        for p in list(query_paths) + [db_paths[int(ranks[qi, j])]
                                      for qi in range(Q) for j in range(b)]:
            if p not in seen:
                seen.add(p)
                if store_dir is None or not os.path.exists(_store_path(store_dir, p)):
                    needed.append(p)
        if needed and store_dir is None:
            cache.update(zip(needed, sift_extract_device(needed, resize, device=device)))
        elif needed:
            os.makedirs(store_dir, exist_ok=True)
            for p, lf in zip(needed, sift_extract_device(needed, resize, device=device)):
                lf.save(_store_path(store_dir, p))

    def extract_one(path):
        if on_device:
            return sift_extract_device([path], resize, device=device)[0]
        return sift_extract(path, resize)

    def features(path):
        if path in cache:
            return cache[path]
        if store_dir is None:
            f = extract_one(path)
        else:
            dst = _store_path(store_dir, path)
            if not os.path.exists(dst):
                os.makedirs(store_dir, exist_ok=True)
                extract_one(path).save(dst)
            f = LocalFeatures.load(dst)
        cache[path] = f
        return f

    if verifier is not None:
        counts = np.zeros((Q, b), np.int64)
        for qi in range(Q):
            fq = features(query_paths[qi])
            for j in range(b):
                counts[qi, j] = verifier(fq, features(db_paths[int(ranks[qi, j])]))
        return rerank_by_inliers(ranks, counts, b)

    feats_q, feats_c = [], []
    for qi in range(Q):
        fq = features(query_paths[qi])
        for j in range(b):
            feats_q.append(fq)
            feats_c.append(features(db_paths[int(ranks[qi, j])]))
    counts = adalam_count_pairs(feats_q, feats_c, pair_batch=pair_batch,
                                device=device).reshape(Q, b)
    return rerank_by_inliers(ranks, counts, b)


# ------------------------------------------------------- LoFTR-class rerank


def loftr_rerank(
    query_paths: Sequence[str],
    db_paths: Sequence[str],
    ranks: np.ndarray,
    match_fn=None,
    b: int = 60,
    resolution: Tuple[int, int] = (640, 480),
    count_fn=None,
    pair_batch: int = 4,
    banked_count_fn=None,
):
    """Detector-free matcher re-rank: each query's top-``b`` candidates are
    re-sorted (stably) by their LoFTR match counts. Images are read as
    grayscale and resized to ``resolution`` (w, h), in [0, 1]. Pass exactly
    one driver of ``models.loftr``, which carries the matcher's device:

    - ``banked_count_fn`` (``make_banked_count_fn``): the unique images
      upload once and every block of ``pair_batch`` pairs is gathered from
      them on the device; the counts are read back once;
    - ``count_fn`` (``make_batched_count_fn``): one forward a block of
      ``pair_batch`` pairs (the last padded with its last pair), images
      uploaded a block at a time; the counts are read back once, at the end;
    - ``match_fn`` (``make_match_fn``): one pair at a time, each count read
      back before the next pair.

    Spans (``utils.tracing``): ``verify.rerank`` the call, ``verify.load``
    each image's read and resize, ``verify.readback`` the counts' read-back.
    """
    if sum(f is not None for f in (match_fn, count_fn, banked_count_fn)) != 1:
        raise ValueError("pass exactly one of match_fn / count_fn / banked_count_fn")
    with tracing.span("verify.rerank"):
        return _loftr_rerank(query_paths, db_paths, ranks, match_fn, b, resolution, count_fn,
                             pair_batch, banked_count_fn)


def _loftr_rerank(query_paths, db_paths, ranks, match_fn, b, resolution, count_fn, pair_batch,
                  banked_count_fn):
    import cv2

    w, h = resolution

    def load(path):
        with tracing.span("verify.load"):
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise FileNotFoundError(path)
            img = cv2.resize(img, (w, h)).astype(np.float32) / 255.0
        return img[:, :, None]

    ranks = np.asarray(ranks)
    Q = len(query_paths)
    b = min(b, ranks.shape[1])
    pairs = [(query_paths[qi], db_paths[int(ranks[qi, j])]) for qi in range(Q) for j in range(b)]
    P = len(pairs)
    if P == 0:
        return ranks.copy()

    if banked_count_fn is not None:
        uniq: dict = {}
        for p in [pq for pq, _ in pairs] + [pc for _, pc in pairs]:
            uniq.setdefault(p, len(uniq))
        bank = np.stack([load(p) for p in uniq])              # (U, H, W, 1), uploaded once
        nb = -(-P // pair_batch)
        pad = nb * pair_batch - P
        iq = np.array([uniq[q] for q, _ in pairs] + [uniq[pairs[-1][0]]] * pad, np.int64)
        ic = np.array([uniq[c] for _, c in pairs] + [uniq[pairs[-1][1]]] * pad, np.int64)
        out = banked_count_fn(bank, iq.reshape(nb, pair_batch), ic.reshape(nb, pair_batch))
        with tracing.span("verify.readback"):
            counts = out.reshape(-1)[:P].cpu().numpy().astype(np.int64).reshape(Q, b)
        return rerank_by_inliers(ranks, counts, b)

    if count_fn is not None:
        img_cache: dict = {}

        def cached(path):
            if path not in img_cache:
                img_cache[path] = load(path)
            return img_cache[path]

        outs = []
        for s in range(0, P, pair_batch):
            chunk = pairs[s:s + pair_batch]
            n = len(chunk)
            chunk = chunk + [chunk[-1]] * (pair_batch - n)    # pad to the block's shape
            outs.append(count_fn(np.stack([cached(q) for q, _ in chunk]),
                                 np.stack([cached(c) for _, c in chunk]))[:n])
        with tracing.span("verify.readback"):
            counts = torch.cat(outs).cpu().numpy().astype(np.int64).reshape(Q, b)
        return rerank_by_inliers(ranks, counts, b)

    counts = np.zeros((Q, b), np.int64)
    for i, (q, c) in enumerate(pairs):
        counts.flat[i] = int(match_fn(load(q), load(c)).num_matches)
    return rerank_by_inliers(ranks, counts, b)
