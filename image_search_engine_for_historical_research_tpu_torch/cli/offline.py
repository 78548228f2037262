"""Offline index build: extract gallery descriptors and build the search index.

Port of ``image_search_engine_for_historical_research_tpu/cli/offline.py``:
walk the dataset folders under ``--data-root``, extract multi-scale
descriptors, save the feature store (or reuse it with ``--ifextracted``),
then build the chosen matcher's index (``--ifgenerate`` rebuilds an existing
artifact) and run one probe query through it. ``--loader pil`` decodes the
images with PIL, ``--loader native`` with the threaded libjpeg loader.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.offline \
      --datasets mycollection --data-root /data --matching-method HNSW --ifgenerate
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import load_path_features, path_all_jpg, save_path_feature
from ..device import resolve_device
from ..models.extract import extract_vectors
from .common import (
    add_common_args,
    add_loader_arg,
    check_matcher,
    dispatch_matcher,
    load_decoder,
    load_network,
    matcher_kwargs,
    parse_scales,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--datasets", required=True,
                   help="comma-separated folder names under --data-root")
    p.add_argument("--data-root", required=True)
    p.add_argument("--ifextracted", action="store_true",
                   help="reuse stored features instead of re-extracting")
    p.add_argument("--K", type=int, default=100)
    add_loader_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    check_matcher(args.matching_method)
    load_decoder(args.loader)
    scales = parse_scales(args.multiscale)
    datasets = args.datasets.split(",")

    model = None
    all_vecs, all_paths = [], []
    for ds in datasets:
        if args.ifextracted:
            vecs, rel_paths = load_path_features(ds, root=args.outputs)
        else:
            if model is None:
                model = load_network(args.network_path, args.arch, device=args.device)
            paths, rel_paths = path_all_jpg(os.path.join(args.data_root, ds), args.data_root)
            print(f">> {ds}: extracting {len(paths)} images...")
            vecs = extract_vectors(model, paths, args.image_size, scales=scales,
                                   batch_size=args.batch_size, loader=args.loader)
            save_path_feature(ds, vecs, rel_paths, root=args.outputs)
        all_vecs.append(np.asarray(vecs))
        all_paths.extend(rel_paths)

    vecs = np.concatenate(all_vecs, axis=0)
    name = "_".join(d.replace("/", "_") for d in datasets)
    print(f">> building {args.matching_method} index over {vecs.shape[0]} vectors")
    # a self-query checks the artifact end to end
    _, tpq = dispatch_matcher(
        args.matching_method, min(args.K, len(vecs)), vecs, vecs[:1],
        **matcher_kwargs(args, name),
    )
    print(f">> index ready; probe query time {tpq * 1e3:.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
