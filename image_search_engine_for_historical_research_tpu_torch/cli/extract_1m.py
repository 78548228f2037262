"""Distractor extraction at scale: the offline descriptor sweep of a 1M-image
gallery.

Port of ``image_search_engine_for_historical_research_tpu/cli/extract_1m.py``
without ``--mesh`` (multi-GPU, ROADMAP section 1, item 5). The sweep runs the
multi-scale extraction over masked canvas batches on one device and can be
resumed: by default it checkpoints ``<outputs>/<dataset>_partial.npz`` every
``--checkpoint-every`` images and writes one feature store at the end; with
``--shard-size`` it writes the sharded store (``data.save_feature_shard``)
and resumes past the last complete shard (``data.shard_resume_point``),
never holding all descriptors in one array. ``--bf16`` runs the backbone in
bfloat16 (the module's ``compute_dtype``; the head stays f32).

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.extract_1m \
      --data-root /data --dataset revisitop1m --shard-size 100000 --loader native
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import configdataset, save_feature_shard, save_path_feature, shard_resume_point
from ..device import resolve_device
from ..models.extract import extract_vectors, make_extract_fn
from .common import add_common_args, add_loader_arg, load_decoder, load_network, parse_scales


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--dataset", default="revisitop1m")
    p.add_argument("--checkpoint-every", type=int, default=50000)
    p.add_argument("--limit", type=int, default=0, help="cap image count (debug)")
    add_loader_arg(p)
    p.add_argument("--bf16", action="store_true",
                   help="run the backbone in bfloat16 (the head and the "
                        "descriptors stay f32)")
    p.add_argument("--shard-size", type=int, default=0,
                   help="write one shard file per chunk of this many images "
                        "(data.save_feature_shard) instead of one array; "
                        "data.chunked_feature_source feeds them to the "
                        "streaming index builders")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    load_decoder(args.loader)
    scales = parse_scales(args.multiscale)
    cfg = configdataset(args.dataset, args.data_root)
    paths = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
    if args.limit:
        paths = paths[: args.limit]

    model = load_network(args.network_path, args.arch, device=args.device)
    if args.bf16:
        model.module.features.compute_dtype = torch.bfloat16
    fn = make_extract_fn(model.module, scales=scales)

    if args.shard_size:
        # each chunk persists as its own atomic shard; resume at the first
        # row past the contiguous shard prefix
        start = shard_resume_point(args.dataset, root=args.outputs)
        if start:
            print(f">> resuming at {start}/{len(paths)} (complete shards)")
        for s in range(start, len(paths), args.shard_size):
            chunk = paths[s : s + args.shard_size]
            v = extract_vectors(model, chunk, args.image_size, scales=scales,
                                batch_size=args.batch_size, extract_fn=fn,
                                loader=args.loader)
            save_feature_shard(args.dataset, s, v, cfg["imlist"][s : s + len(chunk)],
                               root=args.outputs)
            print(f">> {s + len(chunk)}/{len(paths)} done (sharded)")
        print(">> distractor feature shards stored; build indexes with "
              "data.chunked_feature_source + the streaming builders")
        return 0

    ckpt = os.path.join(args.outputs, f"{args.dataset}_partial.npz")
    start = 0
    vecs = np.zeros((len(paths), model.outputdim), np.float32)
    if os.path.exists(ckpt):
        z = np.load(ckpt)
        start = int(z["done"])
        vecs[:start] = z["vecs"][:start]
        print(f">> resuming at {start}/{len(paths)}")

    step = args.checkpoint_every
    for s in range(start, len(paths), step):
        chunk = paths[s : s + step]
        vecs[s : s + len(chunk)] = extract_vectors(
            model, chunk, args.image_size, scales=scales, batch_size=args.batch_size,
            extract_fn=fn, loader=args.loader,
        )
        os.makedirs(args.outputs, exist_ok=True)
        np.savez(ckpt, vecs=vecs, done=s + len(chunk))
        print(f">> {s + len(chunk)}/{len(paths)} done")

    save_path_feature(args.dataset, vecs, cfg["imlist"][: len(paths)], root=args.outputs)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    print(">> distractor features stored")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
