"""Revisited-Oxford/Paris mAP protocol (the golden metric), host numpy.

The port's own copy of
``image_search_engine_for_historical_research_tpu/evaluation/map.py`` (all of
it): trapezoidal AP, junk-aware mAP with E/M/H ground-truth splits,
precision@k, and the folder-label / CSV custom protocols. Host numpy on
purpose: it runs once per evaluation over small rank matrices, and exact
protocol fidelity matters more than device residency. The division-by-zero
guard for a query with no positives in its ranked list is kept.

Rank-matrix convention: ``ranks (nq, K)``, one row per query (the reference
evaluation takes ``(db_size, nq)``; drivers transpose at the boundary).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision from zero-based positive ranks (evaluate.py:4-38).

    Trapezoidal interpolation between (precision-before, precision-after) at each
    positive hit; ``nres`` is the total number of positives for the query.
    """
    nimgranks = len(ranks)
    ap = 0.0
    recall_step = 1.0 / nres
    for j in range(nimgranks):
        rank = ranks[j]
        precision_0 = 1.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(
    ranks: np.ndarray,
    gnd: Sequence[Dict[str, np.ndarray]],
    kappas: Sequence[int] = (),
):
    """Junk-aware mAP + precision@kappas (evaluate.py:40-112).

    ``ranks``: (nq, K) ranked database indices per query (row-major!).
    ``gnd[i]``: dict with 'ok' (positives) and optional 'junk' index arrays.
    Queries with no positives are excluded from the averages (NaN in per-query
    outputs). Junk entries are deleted from the ranking before AP: each positive's
    position is decreased by the number of junk images ranked above it.
    """
    nq = len(gnd)
    K = ranks.shape[1]
    aps = np.zeros(nq)
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    map_total = 0.0
    pr = np.zeros(len(kappas))

    for i in range(nq):
        qgnd = np.asarray(gnd[i]["ok"])
        if qgnd.size == 0:
            aps[i] = np.nan
            prs[i, :] = np.nan
            nempty += 1
            continue
        qgndj = np.asarray(gnd[i].get("junk", np.empty(0)))

        row = ranks[i]
        positions = np.arange(K)
        pos = positions[np.isin(row, qgnd)]
        junk = positions[np.isin(row, qgndj)]

        if junk.size:
            # shift each positive up by the number of junk results before it
            shift = np.searchsorted(junk, pos)
            pos = pos - shift

        ap = compute_ap(pos, len(qgnd))
        map_total += ap
        aps[i] = ap

        pos1 = pos + 1  # 1-based
        for j, kappa in enumerate(kappas):
            if pos1.size == 0:
                # guard from evaluate_custom.py:102-104 (evaluate.py crashes here)
                prs[i, j] = 0.0
            else:
                kq = min(int(np.max(pos1)), kappa)
                prs[i, j] = (pos1 <= kq).sum() / kq
        pr = pr + prs[i, :]

    denom = max(nq - nempty, 1)
    return map_total / denom, aps, pr / denom, prs


@dataclass
class RevisitedResult:
    """mAP/mP@k for the three revisited protocol splits."""

    dataset: str
    mapE: float
    mapM: float
    mapH: float
    apsE: np.ndarray
    apsM: np.ndarray
    apsH: np.ndarray
    kappas: Sequence[int] = (1, 5, 10)
    mprE: Optional[np.ndarray] = None
    mprM: Optional[np.ndarray] = None
    mprH: Optional[np.ndarray] = None

    def summary(self) -> str:
        parts = [
            ">> {}: mAP E: {}, M: {}, H: {}".format(
                self.dataset,
                np.around(self.mapE * 100, 2),
                np.around(self.mapM * 100, 2),
                np.around(self.mapH * 100, 2),
            )
        ]
        if self.mprE is not None:
            parts.append(
                ">> {}: mP@k{} E: {}, M: {}, H: {}".format(
                    self.dataset,
                    list(self.kappas),
                    np.around(self.mprE * 100, 2),
                    np.around(self.mprM * 100, 2),
                    np.around(self.mprH * 100, 2),
                )
            )
        return "\n".join(parts)


def _split_gnd(gnd, ok_keys: Sequence[str], junk_keys: Sequence[str]):
    out = []
    for g in gnd:
        out.append(
            {
                "ok": np.concatenate([np.asarray(g[k]).ravel() for k in ok_keys])
                if ok_keys
                else np.empty(0),
                "junk": np.concatenate([np.asarray(g[k]).ravel() for k in junk_keys])
                if junk_keys
                else np.empty(0),
            }
        )
    return out


def compute_map_revisited(
    ranks: np.ndarray,
    gnd: Sequence[Dict[str, np.ndarray]],
    dataset: str = "",
    kappas: Sequence[int] = (1, 5, 10),
) -> RevisitedResult:
    """E/M/H evaluation of the revisited protocol (evaluate.py:115-150).

    Easy:   ok = easy,        junk = junk + hard
    Medium: ok = easy + hard, junk = junk
    Hard:   ok = hard,        junk = junk + easy
    """
    mapE, apsE, mprE, _ = compute_map(ranks, _split_gnd(gnd, ["easy"], ["junk", "hard"]), kappas)
    mapM, apsM, mprM, _ = compute_map(ranks, _split_gnd(gnd, ["easy", "hard"], ["junk"]), kappas)
    mapH, apsH, mprH, _ = compute_map(ranks, _split_gnd(gnd, ["hard"], ["junk", "easy"]), kappas)
    return RevisitedResult(
        dataset=dataset,
        mapE=mapE, mapM=mapM, mapH=mapH,
        apsE=apsE, apsM=apsM, apsH=apsH,
        kappas=kappas, mprE=mprE, mprM=mprM, mprH=mprH,
    )


def compute_map_and_print(
    dataset: str,
    ranks: np.ndarray,
    gnd,
    kappas: Sequence[int] = (1, 5, 10),
):
    """Driver matching the reference's entry point (evaluate.py:115-155).

    Accepts row-major ``ranks (nq, K)``. Old-protocol datasets (oxford5k/paris6k)
    evaluate a single 'ok'/'junk' gnd; revisited datasets evaluate E/M/H.
    Returns the result object (printing is the caller's choice via ``summary()``).
    """
    if dataset.startswith("oxford5k") or dataset.startswith("paris6k"):
        m, aps, _, _ = compute_map(ranks, gnd)
        return m, aps
    return compute_map_revisited(ranks, gnd, dataset, kappas)


def map_custom(K: int, matching_idx: np.ndarray, paths_q: Sequence[str], paths_d: Sequence[str]) -> float:
    """Folder-name-as-label mAP protocol (evaluate.py:157-174).

    ``matching_idx``: (nq, K) retrieved database indices. A database image is a
    true positive when its parent folder equals the query's parent folder.
    """
    num_query = len(paths_q)
    label_d = [p.split("/")[-2] for p in paths_d]
    label_d = np.asarray(label_d)
    total = 0.0
    for i in range(num_query):
        label_q = paths_q[i].split("/")[-2]
        tp_mask = label_d == label_q
        n_tp = int(tp_mask.sum())
        denominator = min(n_tp, K)
        if denominator == 0:
            continue
        hits = tp_mask[matching_idx[i, :K]]
        cum = np.cumsum(hits) * hits  # matched[j] = running count at hits
        ap = float(np.sum(cum / (np.arange(K) + 1))) / denominator
        total += ap
    return total / num_query


def map_glm(
    K: int,
    matching_idx: np.ndarray,
    paths_q: Sequence[str],
    paths_d: Sequence[str],
    solution_csv: str,
) -> float:
    """Google-Landmarks retrieval_solution CSV protocol (evaluate.py:177-197).

    The reference hard-codes the csv path; here it is a parameter.
    """
    import pandas as pd

    q_ids = [p.split("/")[-1].split(".jpg")[0] for p in paths_q]
    d_ids = [p.split("/")[-1].split(".jpg")[0] for p in paths_d]
    df = pd.read_csv(solution_csv, usecols=["id", "images"])
    df = df.loc[df["images"] != "None"]
    sol = dict(zip(df["id"], df["images"]))
    total = 0.0
    for i, q_id in enumerate(q_ids):
        match_ids = set(sol[q_id].split(" "))
        denominator = min(len(match_ids), K)
        hits = np.array([d_ids[j] in match_ids for j in matching_idx[i, :K]])
        cum = np.cumsum(hits) * hits
        total += float(np.sum(cum / (np.arange(K) + 1))) / denominator
    return total / len(q_ids)


def cal_map_labels(idx: np.ndarray, labels_train, labels_test) -> float:
    """Label-match mAP for labelled sets (nnsearch.py:1082-1094)."""
    labels_train = np.asarray(labels_train)
    labels_test = np.asarray(labels_test)
    num_queries, K = idx.shape
    hits = labels_train[idx] == labels_test[:, None]
    cum = np.cumsum(hits, axis=1) * hits
    ap = np.sum(cum / (np.arange(K) + 1) / K, axis=1)
    return float(ap.mean())
