"""Re-ranking method comparison over stored features.

Port of ``image_search_engine_for_historical_research_tpu/cli/test_reranking.py``:
load a dataset's stored features, run the base matcher, then each requested
re-ranking method, and report the revisited mAP of each. ``qge`` is alphaQE +
diffusion, ``aqe`` / ``dba`` search the augmented descriptors exactly, ``kr``
is k-reciprocal, ``diffusion`` diffuses from the raw queries, ``sift``
re-ranks each query's top ``min(30, K)`` by AdaLAM-verified SIFT matches
(``rerank.sift_rerank``: ``--sift-backend cv2`` extracts with OpenCV on the
host, ``device`` (or JAX's name ``tpu``) with ``ops.sift`` on ``--device``;
``--sift-store`` keeps the features), and ``loftr`` re-ranks the top
``min(60, K)`` by LoFTR match counts (``rerank.loftr_rerank`` with the
pair-batched counter, 640 x 480 grayscale, 4 pairs a forward) on
``--device``, with the weights of ``--loftr-ckpt`` (the released
``outdoor_ds.ckpt`` layout) or, without it, seeded random weights and a
warning. With ``--sift-backend cv2`` or ``loftr`` a machine without OpenCV fails at
start-up on its import.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.test_reranking \
      --dataset roxford5k --data-root data/test --methods qge,aqe,dba,kr,sift,loftr \
      [--sift-backend device] [--loftr-ckpt outdoor_ds.ckpt] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from .. import rerank
from ..data import configdataset, load_path_features
from ..device import resolve_device
from ..evaluation import compute_map_revisited
from ..ops.topk import exact_ranks
from .common import add_common_args, check_matcher, dispatch_matcher, matcher_kwargs


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--dataset", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--methods", default="qge",
                   help="comma list: qge,aqe,dba,kr,diffusion,sift,loftr")
    p.add_argument("--sift-store", default=None)
    p.add_argument("--sift-backend", default="cv2", choices=["cv2", "device", "tpu"],
                   help="device (or tpu, JAX's name) = batched device SIFT (ops.sift) "
                        "instead of per-image host OpenCV")
    p.add_argument("--loftr-ckpt", default=None,
                   help="released LoFTR ckpt (outdoor_ds.ckpt layout); random "
                        "weights with a warning if omitted")
    return p


def run(args):
    """Returns ``{"baseline": RevisitedResult, <method>: RevisitedResult}``."""
    methods = args.methods.split(",")
    dev = resolve_device(args.device)
    if ("sift" in methods and args.sift_backend == "cv2") or "loftr" in methods:
        import cv2  # noqa: F401  (no OpenCV: fail here, before any work)
    check_matcher(args.matching_method)
    cfg = configdataset(args.dataset, args.data_root)
    vecs, _ = load_path_features(args.dataset, root=args.outputs)
    qvecs, _ = load_path_features(args.dataset + "_queries", root=args.outputs)

    K = vecs.shape[0]
    idx, _ = dispatch_matcher(args.matching_method, K, vecs, qvecs,
                              **matcher_kwargs(args, args.dataset))
    out = {"baseline": compute_map_revisited(idx, cfg["gnd"], args.dataset)}
    print("baseline:")
    print(out["baseline"].summary())

    v, q = torch.as_tensor(vecs, device=dev), torch.as_tensor(qvecs, device=dev)
    for method in methods:
        if method == "qge":
            qe, _ = rerank.feature_enhancement(q, v, torch.as_tensor(idx, device=dev))
            ranks, _ = rerank.diffusion_rerank(v, qe, n_trunc=min(2000, K), kd=min(200, K))
        elif method == "aqe":
            ranks = exact_ranks(*rerank.average_query_expansion(q, v))
        elif method == "dba":
            ranks = exact_ranks(*rerank.database_augmentation(q, v))
        elif method == "kr":
            ranks = rerank.kr_rerank(q, v)
        elif method == "diffusion":
            ranks, _ = rerank.diffusion_rerank(v, q, n_trunc=min(2000, K), kd=min(200, K))
        elif method == "sift":
            qpaths = [cfg["qim_fname"](cfg, i) for i in range(cfg["nq"])]
            dpaths = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
            ranks = torch.as_tensor(rerank.sift_rerank(
                qpaths, dpaths, idx, b=min(30, K), store_dir=args.sift_store,
                backend=args.sift_backend, device=dev))
        elif method == "loftr":
            from ..models import loftr as loftr_mod

            if args.loftr_ckpt:
                matcher = loftr_mod.load_loftr_checkpoint(args.loftr_ckpt, device=dev)
            else:
                print("warning: no --loftr-ckpt; LoFTR re-rank uses random "
                      "weights (structure-only run)")
                matcher = loftr_mod.init_matcher(device=dev)
            qpaths = [cfg["qim_fname"](cfg, i) for i in range(cfg["nq"])]
            dpaths = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
            ranks = torch.as_tensor(rerank.loftr_rerank(
                qpaths, dpaths, idx, count_fn=loftr_mod.make_batched_count_fn(matcher),
                b=min(60, K), resolution=(640, 480)))
        else:
            print(f"skipping unknown method {method!r}")
            continue
        out[method] = compute_map_revisited(ranks.cpu().numpy(), cfg["gnd"], args.dataset)
        print(f"after {method}:")
        print(out[method].summary())
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
