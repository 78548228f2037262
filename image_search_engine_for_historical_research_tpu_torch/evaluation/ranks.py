"""Ranked-results artifact: the full per-query ranking, saved for inspection.

The port's own copy of
``image_search_engine_for_historical_research_tpu/evaluation/ranks.py`` (all
of it; host numpy, no torch): ``manifest.json``-style JSON
(``{query path: [ranked gallery paths]}`` beside the path lists) plus
``ranks.npz``, and optionally a self-contained HTML contact sheet that shows
each query with its top-K gallery images through relative paths. Files
written by either package read back in the other.
"""

from __future__ import annotations

import html
import json
import os
from typing import Optional, Sequence

import numpy as np


def save_ranked_results(
    out_dir: str,
    ranks: np.ndarray,
    query_paths: Sequence[str],
    db_paths: Sequence[str],
    name: str = "custom_ranking_result",
    html_sheet: bool = False,
    html_top_k: int = 10,
) -> dict:
    """Write ``<out_dir>/<name>.json`` + ``<name>.npz`` (+ optional HTML).

    ``ranks`` is the matcher's (Q, K) int index matrix (row q = gallery ids
    ranked best-first). The JSON mirrors the reference's
    ``{query_relpath: [ranked db relpaths]}`` mapping exactly so downstream
    consumers of the reference artifact can switch by swapping the loader;
    the npz carries the raw matrix for array consumers.

    Returns ``{"json": path, "npz": path, "html": path | None}``.
    """
    ranks = np.asarray(ranks)
    if ranks.ndim != 2 or ranks.shape[0] != len(query_paths):
        raise ValueError(
            f"ranks must be (Q={len(query_paths)}, K); got {ranks.shape}"
        )
    os.makedirs(out_dir, exist_ok=True)

    mapping = {
        str(query_paths[q]): [str(db_paths[j]) for j in ranks[q]]
        for q in range(ranks.shape[0])
    }
    json_path = os.path.join(out_dir, f"{name}.json")
    with open(json_path, "w") as f:
        json.dump(
            {
                "schema": "ranked_results_v1",
                "query_paths": [str(p) for p in query_paths],
                "db_paths": [str(p) for p in db_paths],
                "ranking": mapping,
            },
            f,
            indent=1,
        )
    npz_path = os.path.join(out_dir, f"{name}.npz")
    np.savez(npz_path, ranks=ranks.astype(np.int32))

    html_path: Optional[str] = None
    if html_sheet:
        html_path = os.path.join(out_dir, f"{name}.html")
        _write_contact_sheet(
            html_path, ranks, query_paths, db_paths, top_k=html_top_k
        )
    return {"json": json_path, "npz": npz_path, "html": html_path}


def load_ranked_results(out_dir: str, name: str = "custom_ranking_result"):
    """Read back (ranks, query_paths, db_paths) from a saved artifact."""
    with open(os.path.join(out_dir, f"{name}.json")) as f:
        manifest = json.load(f)
    ranks = np.load(os.path.join(out_dir, f"{name}.npz"))["ranks"]
    return ranks, manifest["query_paths"], manifest["db_paths"]


def _rel_src(path: str, html_dir: str) -> str:
    """Relative img src when possible (artifact stays portable with the
    tree); absolute file path otherwise."""
    try:
        return os.path.relpath(path, html_dir)
    except ValueError:  # different drive (windows)
        return path


def _write_contact_sheet(
    html_path: str,
    ranks: np.ndarray,
    query_paths: Sequence[str],
    db_paths: Sequence[str],
    top_k: int,
) -> None:
    html_dir = os.path.dirname(os.path.abspath(html_path))
    rows = []
    for q in range(ranks.shape[0]):
        qp = str(query_paths[q])
        cells = [
            '<td class="q"><img src="{src}" height="120"><br>{cap}</td>'.format(
                src=html.escape(_rel_src(qp, html_dir)),
                cap=html.escape(os.path.basename(qp)),
            )
        ]
        for r, j in enumerate(ranks[q][:top_k]):
            dp = str(db_paths[int(j)])
            cells.append(
                "<td>#{r}<br><img src=\"{src}\" height=\"120\"><br>{cap}</td>".format(
                    r=r,
                    src=html.escape(_rel_src(dp, html_dir)),
                    cap=html.escape(os.path.basename(dp)),
                )
            )
        rows.append("<tr>" + "".join(cells) + "</tr>")
    doc = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>Ranked results</title><style>"
        "td{border:1px solid #ccc;padding:4px;text-align:center;"
        "font:12px sans-serif} td.q{background:#eef}"
        "</style></head><body>"
        f"<h1>Ranked results (query | top-{top_k})</h1>"
        "<table>" + "".join(rows) + "</table></body></html>"
    )
    with open(html_path, "w") as f:
        f.write(doc)
