"""Synthetic image datasets for tests, smoke runs and end-to-end drives.

The port's own copy of
``image_search_engine_for_historical_research_tpu/data/synthetic.py``
(numpy + PIL only): from the same seed it writes the same files. Datasets in
the layouts the loaders expect: class-structured jpg folders (the folder-label
protocol of ``cli.test_custom``), a revisited-protocol gnd pickle
(easy/hard/junk/bbx), SfM120k-format training dbs (hashed image dirs + a db
pickle) over coloured classes or over synthetic scenes, and a held-out
revisited eval set over scenes.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np


def _class_image(rng, cls_color, size, jitter=40):
    """A small 'photo': class-colored blocks + noise, so same-class images are
    visually similar to a CNN but not identical."""
    h, w = size
    base = np.ones((h, w, 3), np.float32) * np.asarray(cls_color, np.float32)
    # class-specific pattern: a grid of rectangles at class-dependent offsets
    base += rng.normal(0, jitter, (h, w, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def make_folder_dataset(
    root: str,
    n_classes: int = 4,
    per_class: int = 6,
    n_queries_per_class: int = 1,
    size: Tuple[int, int] = (96, 128),
    seed: int = 0,
):
    """Folder-labelled dataset: root/db/<class>/*.jpg + root/q/<class>/*.jpg.

    Returns (db_paths, query_paths) with the folder name as the label, matching
    the ``mAP_custom`` protocol (evaluate.py:157-174).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_classes, 3))
    db_paths, q_paths = [], []
    for c in range(n_classes):
        cls = f"class{c}"
        for split, count, out in (
            ("db", per_class, db_paths),
            ("q", n_queries_per_class, q_paths),
        ):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                # vary sizes a little to exercise canvas bucketing
                h = size[0] + 16 * int(rng.integers(0, 2))
                w = size[1] + 16 * int(rng.integers(0, 2))
                arr = _class_image(rng, colors[c], (h, w))
                p = os.path.join(d, f"im{i}.jpg")
                Image.fromarray(arr).save(p, quality=90)
                out.append(p)
    return db_paths, q_paths


def make_revisited_dataset(
    root: str,
    dataset: str = "rsynthetic",
    n_classes: int = 4,
    per_class: int = 6,
    size: Tuple[int, int] = (96, 128),
    seed: int = 0,
) -> Dict:
    """Write a revisited-protocol directory: <root>/<dataset>/jpg/*.jpg +
    gnd_<dataset>.pkl with imlist/qimlist/gnd (easy/hard/junk/bbx)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_classes, 3))
    jpg_dir = os.path.join(root, dataset, "jpg")
    os.makedirs(jpg_dir, exist_ok=True)

    imlist, labels = [], []
    for c in range(n_classes):
        for i in range(per_class):
            name = f"db_c{c}_{i}"
            Image.fromarray(_class_image(rng, colors[c], size)).save(
                os.path.join(jpg_dir, name + ".jpg"), quality=90
            )
            imlist.append(name)
            labels.append(c)
    qimlist, gnd = [], []
    labels = np.asarray(labels)
    for c in range(n_classes):
        name = f"q_c{c}"
        Image.fromarray(_class_image(rng, colors[c], size)).save(
            os.path.join(jpg_dir, name + ".jpg"), quality=90
        )
        qimlist.append(name)
        members = np.where(labels == c)[0]
        half = len(members) // 2
        gnd.append(
            {
                "easy": members[:half],
                "hard": members[half:],
                "junk": np.array([], np.int64),
                "bbx": [0, 0, size[1], size[0]],
            }
        )

    cfg = {"imlist": imlist, "qimlist": qimlist, "gnd": gnd}
    with open(os.path.join(root, dataset, f"gnd_{dataset}.pkl"), "wb") as f:
        pickle.dump(cfg, f)
    return cfg


def _scene_canvas(rng, size: Tuple[int, int], octaves=(6, 24)):
    """A per-scene multi-octave smooth random canvas.

    All scenes share identical color/noise *statistics* — identity lives only
    in the spatial pattern, so global color pooling (which trivially separates
    ``_class_image`` classes even under a random-init net) is uninformative
    and retrieval quality has to come from learned features."""
    from PIL import Image

    h, w = size
    canvas = np.full((h, w, 3), 128.0, np.float32)
    amp = 72.0
    for o in octaves:
        low = rng.normal(0.0, 1.0, (o, o, 3)).astype(np.float32)
        up = np.stack(
            [
                np.asarray(
                    Image.fromarray(np.ascontiguousarray(low[..., c])).resize(
                        (w, h), Image.BILINEAR
                    )
                )
                for c in range(3)
            ],
            axis=-1,
        )
        canvas += amp * up
        amp /= 2.0
    return np.clip(canvas, 0, 255)


def _scene_view(rng, canvas, crop: Tuple[int, int], noise: float = 6.0):
    """One 'photograph' of a scene: random crop + flip + photometric jitter.

    Overlapping crops of the same canvas mimic same-landmark views (the
    SfM120k cluster structure, traindataset.py:47-63) without real data."""
    ch, cw = crop
    h, w = canvas.shape[:2]
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    view = canvas[y : y + ch, x : x + cw].copy()
    if rng.random() < 0.5:
        view = view[:, ::-1]
    view = view * float(rng.uniform(0.8, 1.2)) + float(rng.uniform(-12, 12))
    view += rng.normal(0, noise, view.shape)
    return np.clip(view, 0, 255).astype(np.uint8)


def make_scene_sfm_dataset(
    root: str,
    n_scenes: int = 24,
    views_per_scene: int = 6,
    canvas: Tuple[int, int] = (288, 384),
    crop: Tuple[int, int] = (192, 256),
    seed: int = 0,
    name: str = "retrieval-SfM-scenes",  # retrieval-SfM-* family -> hashed dirs
):
    """SfM120k-format training db over synthetic *scenes* (see
    ``_scene_canvas``): hashed image dirs + db pickle with cids/cluster/
    qidxs/pidxs, consumable by ``train.tuples.tuples_from_db_pickle``.
    Returns the pickle path."""
    from PIL import Image

    from .images import cid2filename

    rng = np.random.default_rng(seed)
    db_root = os.path.join(root, name)
    ims_root = os.path.join(db_root, "ims")

    def one_split(tag, scene_range):
        cids, cluster, qidxs, pidxs = [], [], [], []
        for c in scene_range:
            cv = _scene_canvas(
                np.random.default_rng([seed, sum(map(ord, tag)), c]), canvas
            )
            members = []
            for i in range(views_per_scene):
                cid = f"{tag}{c:03d}{i:02d}".ljust(16, "s")
                path = cid2filename(cid, ims_root)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(_scene_view(rng, cv, crop)).save(
                    path, format="JPEG", quality=92
                )
                members.append(len(cids))
                cids.append(cid)
                cluster.append(c)
            for i in range(len(members) - 1):
                qidxs.append(members[i])
                pidxs.append(members[i + 1])
        return {"cids": cids, "cluster": cluster, "qidxs": qidxs, "pidxs": pidxs}

    db = {
        "train": one_split("t", range(n_scenes)),
        "val": one_split("v", range(max(2, n_scenes // 4))),
    }
    pkl = os.path.join(db_root, f"{name}.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(db, f)
    return pkl


def make_scene_revisited(
    root: str,
    dataset: str = "rscenes",
    n_scenes: int = 16,
    db_views: int = 5,
    canvas: Tuple[int, int] = (288, 384),
    crop: Tuple[int, int] = (192, 256),
    seed: int = 100,
) -> Dict:
    """Held-out revisited-protocol eval set over synthetic scenes.

    Writes jpgs and returns ``{"images", "qimages", "gnd"}`` (path lists +
    per-query easy/hard/junk dicts) — the shape ``train.make_retrieval_eval``
    consumes. One query view per scene; its scene's db views split into
    easy (first half) / hard (rest), like ``make_revisited_dataset``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jpg_dir = os.path.join(root, dataset, "jpg")
    os.makedirs(jpg_dir, exist_ok=True)

    images, qimages, gnd = [], [], []
    for c in range(n_scenes):
        cv = _scene_canvas(np.random.default_rng([seed, ord("e"), c]), canvas)
        members = []
        for i in range(db_views):
            p = os.path.join(jpg_dir, f"db_s{c}_{i}.jpg")
            Image.fromarray(_scene_view(rng, cv, crop)).save(p, quality=92)
            members.append(len(images))
            images.append(p)
        qp = os.path.join(jpg_dir, f"q_s{c}.jpg")
        Image.fromarray(_scene_view(rng, cv, crop)).save(qp, quality=92)
        qimages.append(qp)
        members = np.asarray(members)
        half = max(1, len(members) // 2)
        gnd.append(
            {
                "easy": members[:half],
                "hard": members[half:],
                "junk": np.array([], np.int64),
                "bbx": [0, 0, crop[1], crop[0]],
            }
        )
    return {"images": images, "qimages": qimages, "gnd": gnd}


def make_sfm_db_dataset(
    root: str,
    n_clusters: int = 4,
    per_cluster: int = 5,
    size: Tuple[int, int] = (64, 64),
    seed: int = 0,
    name: str = "retrieval-SfM-tiny",
):
    """Write an SfM120k-format training db: hashed image dirs + db pickle.

    Layout mirrors the reference's training data (traindataset.py:47-63):
    ``<root>/<name>/ims/<hash dirs>/<cid>`` images and ``<root>/<name>/<name>.pkl``
    holding ``{"train": {...}, "val": {...}}`` with cids/cluster/qidxs/pidxs.
    Returns the pickle path.
    """
    from PIL import Image

    from .images import cid2filename

    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 225, (n_clusters, 3))
    db_root = os.path.join(root, name)
    ims_root = os.path.join(db_root, "ims")

    def one_split(tag, clusters_range):
        cids, cluster, qidxs, pidxs = [], [], [], []
        for c in clusters_range:
            members = []
            for i in range(per_cluster):
                # 16-hex-char cid like the real SfM120k ids
                cid = f"{tag}{c:02d}{i:02d}".ljust(16, "a")
                path = cid2filename(cid, ims_root)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(_class_image(rng, colors[c], size)).save(
                    path, format="JPEG", quality=90
                )
                members.append(len(cids))
                cids.append(cid)
                cluster.append(c)
            for i in range(len(members) - 1):  # consecutive pairs as q/p
                qidxs.append(members[i])
                pidxs.append(members[i + 1])
        return {
            "cids": cids,
            "cluster": cluster,
            "qidxs": qidxs,
            "pidxs": pidxs,
        }

    db = {
        "train": one_split("t", range(n_clusters)),
        "val": one_split("v", range(n_clusters)),
    }
    pkl = os.path.join(db_root, f"{name}.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(db, f)
    return pkl
