"""Folder-labelled custom-dataset evaluation.

Port of ``image_search_engine_for_historical_research_tpu/cli/test_custom.py``:
extract gallery and query descriptors from folder-structured datasets (the
folder name is the label), run the matcher, and report the folder-label mAP.
``--save-ranks`` writes the per-query ranking under ``<outputs>/ranks/``
(JSON + npz, ``evaluation.ranks``), ``--html-sheet`` adds a contact sheet.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.test_custom \
      --db-dir data/db --query-dir data/q [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from ..data import path_all_jpg
from ..device import resolve_device
from ..evaluation import map_custom
from ..evaluation.ranks import save_ranked_results
from ..models.extract import extract_vectors
from .common import (
    add_common_args,
    check_matcher,
    dispatch_matcher,
    load_network,
    matcher_kwargs,
    parse_scales,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--db-dir", required=True, help="gallery root (label folders)")
    p.add_argument("--query-dir", required=True, help="query root (label folders)")
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--save-ranks", action="store_true",
                   help="write the per-query ranking under <outputs>/ranks/ (json + npz)")
    p.add_argument("--html-sheet", action="store_true",
                   help="with --save-ranks: also write an HTML contact sheet "
                        "(query | top-K images)")
    return p


def run(args):
    """Returns ``{"map": custom mAP@K, "ranks": (Q, K) ids, "saved": the
    written files or None}``."""
    resolve_device(args.device)
    check_matcher(args.matching_method)
    scales = parse_scales(args.multiscale)
    model = load_network(args.network_path, args.arch, device=args.device)

    db_paths, _ = path_all_jpg(args.db_dir)
    q_paths, _ = path_all_jpg(args.query_dir)
    print(f">> extracting {len(db_paths)} db + {len(q_paths)} query images")
    vecs = extract_vectors(model, db_paths, args.image_size, scales=scales,
                           batch_size=args.batch_size)
    qvecs = extract_vectors(model, q_paths, args.image_size, scales=scales,
                            batch_size=args.batch_size)

    K = min(args.K, len(db_paths))
    idx, tpq = dispatch_matcher(args.matching_method, K, vecs, qvecs,
                                **matcher_kwargs(args, "custom"))
    m = map_custom(K, idx, q_paths, db_paths)
    print(f">> custom mAP@{K}: {m * 100:.2f} ({tpq * 1e3:.3f} ms/query)")

    saved = None
    if args.save_ranks:
        saved = save_ranked_results(os.path.join(args.outputs, "ranks"), idx, q_paths,
                                    db_paths, html_sheet=args.html_sheet)
        print(f">> ranked results: {saved['json']}"
              + (f" + {saved['html']}" if saved["html"] else ""))
    return {"map": m, "ranks": idx, "saved": saved}


def main(argv=None):
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
