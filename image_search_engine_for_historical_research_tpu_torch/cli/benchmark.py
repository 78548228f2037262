"""Benchmark reproduction: the revisited Oxford/Paris (+1M distractors) protocol.

Port of ``image_search_engine_for_historical_research_tpu/cli/benchmark.py``:
per dataset, extract database and query descriptors (queries cropped to their
gnd bounding boxes) or reuse the stored ones (``--ifextracted``), optionally
append the stored revisitop1m distractor features (``--include1m``), run the
chosen matcher in mAP mode (K = database size) or top-K mode, and report the
revisited E/M/H mAP. ``--qge`` then re-ranks: on a gallery under ``QGE_BIG``
images with alphaQE (k=10, three iterations) and then diffusion
(``n_trunc=min(2000, N)``, ``kd=min(200, N)``), on a larger one with alphaQE
alone (k=3, one iteration).

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.benchmark \
      --datasets roxford5k,rparis6k --data-root /data --matching-method L2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import configdataset, load_path_features, query_bbxs, save_path_feature
from ..device import resolve_device
from ..evaluation import compute_map_revisited
from ..models.extract import extract_vectors
from ..rerank.diffusion import diffusion_rerank
from ..rerank.qe import feature_enhancement
from .common import (
    add_common_args,
    check_matcher,
    dispatch_matcher,
    load_network,
    matcher_kwargs,
    parse_scales,
)

# gallery size from which the reference re-ranks with alphaQE alone
# (k=3, one iteration) instead of alphaQE (k=10, three) + diffusion
QGE_BIG = 120_000


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--datasets", default="roxford5k,rparis6k")
    p.add_argument("--data-root", required=True,
                   help="dir containing <dataset>/jpg and <dataset>/gnd_<dataset>.pkl")
    p.add_argument("--mode", default="mAP", help="'mAP' (K = db size) or an integer K")
    p.add_argument("--ifextracted", action="store_true")
    p.add_argument("--include1m", action="store_true",
                   help="append the stored revisitop1m distractor features")
    p.add_argument("--qge", action="store_true",
                   help="re-rank with alphaQE + diffusion (alphaQE alone from 120,000 images)")
    return p


def run(args):
    """Evaluate every dataset of ``args``; returns ``{dataset: results}``
    with the ranks and ``RevisitedResult`` of the matcher (``"ranks"``,
    ``"map"``) and, with ``--qge``, after alphaQE (``"ranks_qe"``,
    ``"map_qe"``) and, below ``QGE_BIG`` images, after alphaQE + diffusion
    (``"ranks_dfs"``, ``"map_dfs"``)."""
    dev = resolve_device(args.device)
    check_matcher(args.matching_method)
    scales = parse_scales(args.multiscale)
    cfgs = {ds: configdataset(ds, args.data_root) for ds in args.datasets.split(",")}
    d1m = load_path_features("revisitop1m", root=args.outputs)[0] if args.include1m else None

    model = None
    out = {}
    for dataset, cfg in cfgs.items():
        if args.ifextracted:
            vecs, _ = load_path_features(dataset, root=args.outputs)
            qvecs, _ = load_path_features(dataset + "_queries", root=args.outputs)
        else:
            if model is None:
                model = load_network(args.network_path, args.arch, device=args.device)
            im_paths = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
            qim_paths = [cfg["qim_fname"](cfg, i) for i in range(cfg["nq"])]
            print(f">> {dataset}: extracting {cfg['n']} database images...")
            vecs = extract_vectors(model, im_paths, args.image_size, scales=scales,
                                   batch_size=args.batch_size)
            print(f">> {dataset}: extracting {cfg['nq']} query images...")
            qvecs = extract_vectors(model, qim_paths, args.image_size, bbxs=query_bbxs(cfg),
                                    scales=scales, batch_size=args.batch_size)
            save_path_feature(dataset, vecs, cfg["imlist"], root=args.outputs)
            save_path_feature(dataset + "_queries", qvecs, cfg["qimlist"], root=args.outputs)
        if d1m is not None:
            vecs = np.concatenate([vecs, d1m], axis=0)

        K = vecs.shape[0] if args.mode == "mAP" else int(args.mode)
        idx, tpq = dispatch_matcher(args.matching_method, K, vecs, qvecs,
                                    **matcher_kwargs(args, dataset))
        print(f">> {dataset}: {args.matching_method} time/query {tpq * 1e3:.3f} ms")
        res = compute_map_revisited(idx, cfg["gnd"], dataset)
        print(res.summary())
        out[dataset] = {"ranks": idx, "map": res}

        if args.qge:
            big = vecs.shape[0] >= QGE_BIG
            k, iters = (3, 1) if big else (10, 3)
            vecs_t = torch.as_tensor(vecs, device=dev)
            qe, ranks_qe = feature_enhancement(
                torch.as_tensor(qvecs, device=dev), vecs_t,
                torch.as_tensor(idx, device=dev), k=k, iterations=iters)
            ranks_qe = ranks_qe.cpu().numpy()
            res_qe = compute_map_revisited(ranks_qe, cfg["gnd"], dataset)
            print("after alphaQE:")
            print(res_qe.summary())
            out[dataset].update(ranks_qe=ranks_qe, map_qe=res_qe)
            if not big:
                n = vecs.shape[0]
                ranks_dfs, _ = diffusion_rerank(vecs_t, qe, n_trunc=min(2000, n),
                                                kd=min(200, n))
                ranks_dfs = ranks_dfs.cpu().numpy()
                res_dfs = compute_map_revisited(ranks_dfs, cfg["gnd"], dataset)
                print("after alphaQE + diffusion:")
                print(res_dfs.summary())
                out[dataset].update(ranks_dfs=ranks_dfs, map_dfs=res_dfs)
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
