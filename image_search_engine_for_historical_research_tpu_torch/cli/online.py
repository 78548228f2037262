"""Online serving CLI: load features + index, start the query service.

Port of ``image_search_engine_for_historical_research_tpu/cli/online.py`` for
``--matching-method L2`` (a ``FlatIndex`` over the stored features, built at
start-up), ``HNSW`` and the PQ family (``PQ``/``Nano_PQ``, ``PQ_HNSW``/
``HNSW_NanoPQ``, ``IVFPQ``, ``ANNOY``: the artifact ``cli.offline`` wrote, by
the JAX package's kind map). ``--loader native`` decodes the batched
path's uploads with the threaded libjpeg loader (``--loader pil``, the
default, with PIL). ``--coalesce MAX_BATCH``
puts ``serving.batching.CoalescingService`` in front of the service and
serves on a threaded server.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.online \
      --datasets mycollection --matching-method HNSW --port 8080 [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import load_path_features
from ..device import resolve_device
from ..index import build_flat, load_index
from ..ops.beam_search import check_ef
from ..serving.app import SearchService, serve
from ..serving.batching import CoalescingService
from .common import (
    add_common_args,
    add_loader_arg,
    check_matcher,
    load_decoder,
    load_network,
    parse_scales,
)

# matching method -> the index artifact it serves (JAX ``cli/online.py:57-60``)
SERVED_KINDS = {
    "PQ": "pq", "Nano_PQ": "pq", "ANNOY": "rpforest", "HNSW": "hnsw",
    "PQ_HNSW": "hnsw_pq", "HNSW_NanoPQ": "hnsw_pq", "IVFPQ": "ivfpq",
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
    add_loader_arg(p)
    p.add_argument("--coalesce", type=int, default=0, metavar="MAX_BATCH",
                   help="micro-batch concurrent requests into one device pass "
                        "(serving.batching; implies a threaded server). 0 = off "
                        "(one query at a time)")
    return p


def make_service(args) -> SearchService:
    resolve_device(args.device)
    check_matcher(args.matching_method)
    load_decoder(args.loader)
    datasets = args.datasets.split(",")
    vecs_l, paths = [], []
    for ds in datasets:
        v, p = load_path_features(ds, root=args.outputs)
        vecs_l.append(v)
        paths.extend(p)
    vecs = np.concatenate(vecs_l, axis=0)
    if args.matching_method == "L2":
        index = build_flat(vecs, device=args.device)
    else:
        name = "_".join(d.replace("/", "_") for d in datasets)
        if args.matching_method not in SERVED_KINDS:
            raise SystemExit(f"--matching-method {args.matching_method} has no served index; "
                             f"cli.online serves L2, {', '.join(SERVED_KINDS)}")
        kind = SERVED_KINDS[args.matching_method]
        index = load_index(f"{args.outputs}/{name}/{kind}", device=args.device)
        if kind == "hnsw" and index.device.type == "cuda":
            try:  # refuse a K the kernel cannot serve now, not on every query
                check_ef(max(index.ef_default, args.K))
            except ValueError as e:
                raise SystemExit(f"--K {args.K}: {e}") from None
    model = load_network(args.network_path, args.arch, device=args.device)
    return SearchService(
        model, index, vecs, paths, K=args.K,
        scales=parse_scales(args.multiscale), image_size=args.image_size,
        rerank=not args.no_rerank, image_root=args.data_root,
        loader=args.loader, device=args.device,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = make_service(args)
    if args.coalesce:
        service = CoalescingService(service, max_batch=args.coalesce)
    serve(service, args.host, args.port, threaded=bool(args.coalesce))


if __name__ == "__main__":
    main()
