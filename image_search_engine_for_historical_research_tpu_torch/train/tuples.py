"""Training tuples with per-epoch hard-negative mining.

Port of ``image_search_engine_for_historical_research_tpu/train/tuples.py``
(the reference's ``TuplesDataset``, ``traindataset.py:20-502``): each epoch
the current network embeds the query set and a random negative pool; each
query's negatives are the highest-scoring pool images of other clusters, at
most one per cluster; a tuple is (query, positive, ``nnum`` negatives).

Scoring is one exact top-k on the device (``ops.topk.exact_topk``, whose ties
follow ``lax.top_k``) over a shortlist, and the cluster filter runs on the
host. The permutations come from the caller's ``np.random.Generator``, so
with equal embeddings the port mines the same tuples as JAX.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TupleSpec:
    """One training tuple: indices into the dataset's image list."""

    query: int
    positive: int
    negatives: List[int]


@dataclass
class TuplesDataset:
    """Image list + cluster labels + (query, positive) pairs.

    ``qpool``/``ppool`` are matched index arrays (a positive pair per entry,
    like the reference's qidxs/pidxs from the SfM120k db file); ``cluster`` maps
    every image to its 3D-model/class id (used to exclude same-cluster
    negatives, traindataset.py:472-491).
    """

    images: Sequence[str]
    cluster: np.ndarray
    qpool: np.ndarray
    ppool: np.ndarray
    qsize: int = 2000
    poolsize: int = 20000
    nnum: int = 5

    def __post_init__(self):
        self.cluster = np.asarray(self.cluster)
        self.qpool = np.asarray(self.qpool)
        self.ppool = np.asarray(self.ppool)

    def mine_epoch(
        self,
        embed: Callable[[Sequence[str]], np.ndarray],
        rng: np.random.Generator,
        shortlist: int = 50,
        device="cuda",
    ) -> List[TupleSpec]:
        """Select this epoch's tuples (traindataset.py:389-497).

        ``embed(paths) -> (n, D)`` runs the current network; the scores and
        the shortlist are computed on ``device``. Negatives are the
        top-scoring pool entries per query with (a) cluster != query cluster
        and (b) at most one negative per cluster.
        """
        nq = min(self.qsize, len(self.qpool))
        pick = rng.permutation(len(self.qpool))[:nq]
        qidxs = self.qpool[pick]
        pidxs = self.ppool[pick]

        pool = rng.permutation(len(self.images))[: min(self.poolsize, len(self.images))]
        pool = np.asarray(pool)

        qvecs = embed([self.images[i] for i in qidxs])            # (nq, D)
        poolvecs = embed([self.images[i] for i in pool])          # (np, D)

        # device scoring + shortlist (the torch.mm + sort of :466-471)
        import torch

        from ..device import resolve_device
        from ..ops.topk import exact_topk

        dev = resolve_device(device)
        k = min(max(shortlist, self.nnum * 8), len(pool))
        _, top = exact_topk(torch.as_tensor(qvecs, device=dev),
                            torch.as_tensor(poolvecs, device=dev), k)
        top = top.cpu().numpy()

        tuples = []
        for row, (qi, pi) in enumerate(zip(qidxs, pidxs)):
            qcluster = self.cluster[qi]
            clusters_used = {qcluster}
            negs = []
            for cand in pool[top[row]]:
                c = self.cluster[cand]
                if c in clusters_used:
                    continue
                clusters_used.add(c)
                negs.append(int(cand))
                if len(negs) >= self.nnum:
                    break
            if len(negs) == self.nnum:
                tuples.append(TupleSpec(int(qi), int(pi), negs))
        return tuples


def tuples_from_folders(db_paths: Sequence[str]) -> TuplesDataset:
    """Build a TuplesDataset from a folder-labelled dataset: every image is a
    query once, paired with a random same-class positive (test fixture path;
    the reference uses SfM120k/gl18 pickles instead)."""
    labels = np.asarray([p.split("/")[-2] for p in db_paths])
    uniq = {l: i for i, l in enumerate(sorted(set(labels)))}
    cluster = np.asarray([uniq[l] for l in labels])
    rng = np.random.default_rng(0)
    qpool, ppool = [], []
    for i in range(len(db_paths)):
        same = np.where((cluster == cluster[i]) & (np.arange(len(db_paths)) != i))[0]
        if len(same):
            qpool.append(i)
            ppool.append(int(rng.choice(same)))
    return TuplesDataset(
        images=list(db_paths),
        cluster=cluster,
        qpool=np.asarray(qpool),
        ppool=np.asarray(ppool),
    )


def tuples_from_db_pickle(
    db_path: str,
    mode: str = "train",
    ims_root: Optional[str] = None,
    name: Optional[str] = None,
    qsize: int = 2000,
    poolsize: int = 20000,
    nnum: int = 5,
) -> TuplesDataset:
    """Read the reference's training db pickle (traindataset.py:47-106).

    The file holds ``{"train": split, "val": split}`` where each split has
    ``cids`` (image ids), ``cluster`` (3D-model id per image), and matched
    ``qidxs``/``pidxs`` positive pairs. Image paths resolve per dataset family:

    - ``retrieval-SfM-*``: 3-level hashed dirs via ``cid2filename``
      (traindataset.py:63, datahelpers.py:13-26); ``ims_root`` defaults to
      ``<db_dir>/ims``.
    - ``gl18``/``gl*``: flat ``<ims_root>/<cid>.jpg`` (traindataset.py:78).

    ``name`` selects the family; by default it is the pickle's basename
    (e.g. ``retrieval-SfM-120k.pkl``).
    """
    import pickle

    from ..data.images import cid2filename

    if mode not in ("train", "val"):
        raise ValueError(f"mode must be 'train' or 'val', got {mode!r}")
    with open(db_path, "rb") as f:
        db = pickle.load(f)[mode]

    name = name or os.path.splitext(os.path.basename(db_path))[0]
    if ims_root is None:
        ims_root = os.path.join(os.path.dirname(os.path.abspath(db_path)), "ims")
    cids = db["cids"]
    if name.startswith("retrieval-SfM") or name.startswith("retrieval-sfm"):
        images = [cid2filename(c, ims_root) for c in cids]
    elif name.startswith("gl"):
        images = [os.path.join(ims_root, f"{c}.jpg") for c in cids]
    else:
        raise ValueError(
            f"unknown training dataset family {name!r} "
            "(expected retrieval-SfM-* or gl*)"
        )

    return TuplesDataset(
        images=images,
        cluster=np.asarray(db["cluster"]),
        qpool=np.asarray(db["qidxs"]),
        ppool=np.asarray(db["pidxs"]),
        qsize=qsize,
        poolsize=poolsize,
        nnum=nnum,
    )


def whiten_db_from_pickle(
    db_path: str,
    ims_root: Optional[str] = None,
    name: Optional[str] = None,
) -> dict:
    """Read the reference's ``{name}-whiten.pkl`` (main_train.py:656-661): a
    FLAT dict ``{cids, qidxs, pidxs}`` (no train/val split). Returns the
    ``whiten_db`` dict ``make_retrieval_eval`` consumes: image paths resolved
    per dataset family (like ``tuples_from_db_pickle``) + the matched
    query/positive index pairs ``whitenlearn`` needs. A pre-resolved
    ``{"images": [...]}`` pickle is accepted as-is."""
    import pickle

    from ..data.images import cid2filename

    with open(db_path, "rb") as f:
        db = pickle.load(f)
    if "images" in db:
        images = list(db["images"])
    else:
        name = name or os.path.splitext(os.path.basename(db_path))[0]
        name = name.replace("-whiten", "")
        if ims_root is None:
            ims_root = os.path.join(
                os.path.dirname(os.path.abspath(db_path)), "ims"
            )
        cids = db["cids"]
        if name.lower().startswith("retrieval-sfm"):
            images = [cid2filename(c, ims_root) for c in cids]
        elif name.startswith("gl"):
            images = [os.path.join(ims_root, f"{c}.jpg") for c in cids]
        else:
            raise ValueError(f"unknown whiten dataset family {name!r}")
    return {
        "images": images,
        "qidxs": np.asarray(db["qidxs"]),
        "pidxs": np.asarray(db["pidxs"]),
    }


def batch_tuples(
    tuples: Sequence[TupleSpec],
    load_image: Callable[[int], np.ndarray],
    batch_tuples_count: int,
):
    """Yield flat (images (B*S, H, W, C), labels (B*S,)) batches.

    Layout matches ops.losses: per tuple [query, positive, negs...], labels
    -1/1/0. Images must share one shape (train-mode square crops).
    """
    if not tuples:
        return
    S = 2 + len(tuples[0].negatives)
    for start in range(0, len(tuples) - batch_tuples_count + 1, batch_tuples_count):
        chunk = tuples[start : start + batch_tuples_count]
        imgs, labels = [], []
        for t in chunk:
            for idx, lab in [(t.query, -1), (t.positive, 1)] + [
                (n, 0) for n in t.negatives
            ]:
                imgs.append(load_image(idx))
                labels.append(lab)
        yield np.stack(imgs), np.asarray(labels, np.int32), S
