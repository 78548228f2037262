"""Online serving CLI: load features + index, start the query service.

Port of ``image_search_engine_for_historical_research_tpu/cli/online.py`` for
``--matching-method HNSW``. Other matching methods and ``--coalesce`` exit
with the ROADMAP item that ports them.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.online \
      --datasets mycollection --matching-method HNSW --port 8080 [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import load_path_features
from ..device import resolve_device
from ..index import load_index
from ..serving.app import SearchService, serve
from .common import add_common_args, load_network, parse_scales

# matching method -> the ROADMAP item that ports it
_NOT_PORTED = {
    "L2": "FlatIndex / exact_topk (the L2 route)",
    "PQ": "the PQ family",
    "Nano_PQ": "the PQ family",
    "PQ_HNSW": "the PQ family",
    "HNSW_NanoPQ": "the PQ family",
    "IVFPQ": "the PQ family",
    "ANNOY": "the remaining matchers",
    "LSH": "the remaining matchers",
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--datasets", required=True)
    p.add_argument("--data-root", default=None,
                   help="base dir the stored relative image paths resolve "
                        "against (for result thumbnails)")
    p.add_argument("--K", type=int, default=10)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--no-rerank", action="store_true")
    p.add_argument("--coalesce", type=int, default=0, metavar="MAX_BATCH",
                   help="micro-batching of concurrent requests: not ported yet")
    return p


def make_service(args) -> SearchService:
    resolve_device(args.device)
    if args.matching_method != "HNSW":
        item = _NOT_PORTED.get(args.matching_method, "an unknown method")
        raise SystemExit(
            f"--matching-method {args.matching_method} is not ported yet: "
            f"see ROADMAP, {item}. The port serves --matching-method HNSW."
        )
    datasets = args.datasets.split(",")
    vecs_l, paths = [], []
    for ds in datasets:
        v, p = load_path_features(ds, root=args.outputs)
        vecs_l.append(v)
        paths.extend(p)
    vecs = np.concatenate(vecs_l, axis=0)
    name = "_".join(d.replace("/", "_") for d in datasets)
    index = load_index(f"{args.outputs}/{name}/hnsw", device=args.device)
    model = load_network(args.network_path, args.arch, device=args.device)
    return SearchService(
        model, index, vecs, paths, K=args.K,
        scales=parse_scales(args.multiscale), image_size=args.image_size,
        rerank=not args.no_rerank, image_root=args.data_root,
        device=args.device,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.coalesce:
        raise SystemExit("--coalesce is not ported yet: see ROADMAP, serving/batching.py")
    serve(make_service(args), args.host, args.port)


if __name__ == "__main__":
    main()
