"""Test-dataset configuration (revisited Oxford/Paris protocol files).

The port's own copy of
``image_search_engine_for_historical_research_tpu/data/datasets.py`` (all of
it): loads ``gnd_<dataset>.pkl`` (imlist / qimlist / gnd with
easy-hard-junk-bbx) for the standard datasets, the 1M-line imlist for
revisitop1m, and folder-based custom datasets. The gnd pickle is the public
revisitop distribution format; unpickle only files of that distribution.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

DATASETS = ["oxford5k", "paris6k", "roxford5k", "rparis6k", "revisitop1m", "custom"]


def configdataset(dataset: str, dir_main: str) -> Dict:
    """Load a dataset config dict (testdataset.py:6-44).

    Returns keys: imlist, qimlist, gnd (except revisitop1m), dir_images, n, nq,
    im_fname/qim_fname path helpers.
    """
    dataset = dataset.lower()
    if dataset not in DATASETS:
        raise ValueError(f"Unknown dataset: {dataset}!")

    if dataset == "revisitop1m":
        cfg = {}
        cfg["imlist_fname"] = os.path.join(dir_main, dataset, f"{dataset}.txt")
        cfg["imlist"] = read_imlist(cfg["imlist_fname"])
        cfg["qimlist"] = []
        cfg["ext"] = ""
        cfg["qext"] = ""
    else:
        gnd_fname = os.path.join(dir_main, dataset, f"gnd_{dataset}.pkl")
        with open(gnd_fname, "rb") as f:
            cfg = pickle.load(f)
        cfg["gnd_fname"] = gnd_fname
        cfg["ext"] = ".jpg"
        cfg["qext"] = ".jpg"

    cfg["dir_data"] = os.path.join(dir_main, dataset)
    cfg["dir_images"] = os.path.join(cfg["dir_data"], "jpg")
    cfg["n"] = len(cfg["imlist"])
    cfg["nq"] = len(cfg["qimlist"])
    cfg["im_fname"] = config_imname
    cfg["qim_fname"] = config_qimname
    cfg["dataset"] = dataset
    return cfg


def config_imname(cfg: Dict, i: int) -> str:
    return os.path.join(cfg["dir_images"], cfg["imlist"][i] + cfg["ext"])


def config_qimname(cfg: Dict, i: int) -> str:
    return os.path.join(cfg["dir_images"], cfg["qimlist"][i] + cfg["qext"])


def read_imlist(imlist_fn: str) -> List[str]:
    with open(imlist_fn, "r") as f:
        return f.read().splitlines()


def query_bbxs(cfg: Dict) -> Optional[list]:
    """Per-query bounding boxes from gnd, None when absent (test_rOP1m.py:109)."""
    gnd = cfg.get("gnd")
    if not gnd:
        return None
    try:
        return [tuple(g["bbx"]) for g in gnd]
    except (KeyError, TypeError):
        return None
