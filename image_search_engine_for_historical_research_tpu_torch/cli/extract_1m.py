"""Distractor extraction at scale: the offline descriptor sweep of a 1M-image
gallery.

Port of ``image_search_engine_for_historical_research_tpu/cli/extract_1m.py``.
The sweep runs the multi-scale extraction over masked canvas batches and can
be resumed: by default it checkpoints ``<outputs>/<dataset>_partial.npz``
every ``--checkpoint-every`` images and writes one feature store at the end;
with ``--shard-size`` it writes the sharded store (``data.save_feature_shard``)
and resumes past the last complete shard (``data.shard_resume_point``),
never holding all descriptors in one array. ``--bf16`` runs the backbone in
bfloat16 (the module's ``compute_dtype``; the head stays f32).

``--mesh`` splits each batch over the processes of a ``torchrun`` launch,
one a GPU (``parallel.data_mesh``; without a launcher, a world of one in
this process). Every rank decodes the whole batch and gets every row back;
rank 0 alone writes and removes the files, and every rank waits for it
before it reads a resume point, so all resume at the same row.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.extract_1m \
      --data-root /data --dataset revisitop1m --shard-size 100000 --loader native
  torchrun --standalone --nproc-per-node 4 -m \
      image_search_engine_for_historical_research_tpu_torch.cli.extract_1m \
      --data-root /data --shard-size 100000 --batch-size 64 --mesh
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..data import configdataset, save_feature_shard, save_path_feature, shard_resume_point
from ..device import resolve_device
from ..models.extract import extract_vectors, make_extract_fn, make_sharded_extract_fn
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
    p.add_argument("--mesh", action="store_true",
                   help="split each batch over the processes of a torchrun launch "
                        "(one a GPU; a world of one without a launcher); rank 0 "
                        "writes the files")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    load_decoder(args.loader)
    if not args.mesh:
        return sweep(args)
    from ..parallel import data_mesh

    started = not dist.is_initialized()
    try:
        mesh = data_mesh(device=args.device)     # before the model: it picks this rank's card
        if args.batch_size % dist.get_world_size():
            raise SystemExit("--batch-size must divide evenly across devices")
        return sweep(args, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def sweep(args, mesh=None):
    """The sweep of ``main``; with ``mesh``, sharded, and only rank 0
    writes (a barrier after each write and before each read)."""
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    def barrier():
        if mesh is not None:
            dist.barrier()

    scales = parse_scales(args.multiscale)
    cfg = configdataset(args.dataset, args.data_root)
    paths = [cfg["im_fname"](cfg, i) for i in range(cfg["n"])]
    if args.limit:
        paths = paths[: args.limit]

    model = load_network(args.network_path, args.arch, device=args.device)
    if args.bf16:
        model.module.features.compute_dtype = torch.bfloat16
    fn = (make_extract_fn(model.module, scales=scales) if mesh is None
          else make_sharded_extract_fn(model.module, mesh, scales=scales))

    def extract(chunk):
        return extract_vectors(model, chunk, args.image_size, scales=scales,
                               batch_size=args.batch_size, extract_fn=fn,
                               pad_batches=mesh is not None, loader=args.loader)

    if args.shard_size:
        # each chunk persists as its own atomic shard; resume at the first
        # row past the contiguous shard prefix
        barrier()
        start = shard_resume_point(args.dataset, root=args.outputs)
        if start:
            say(f">> resuming at {start}/{len(paths)} (complete shards)")
        for s in range(start, len(paths), args.shard_size):
            chunk = paths[s : s + args.shard_size]
            v = extract(chunk)
            if lead:
                save_feature_shard(args.dataset, s, v, cfg["imlist"][s : s + len(chunk)],
                                   root=args.outputs)
            barrier()
            say(f">> {s + len(chunk)}/{len(paths)} done (sharded)")
        say(">> distractor feature shards stored; build indexes with "
            "data.chunked_feature_source + the streaming builders")
        return 0

    ckpt = os.path.join(args.outputs, f"{args.dataset}_partial.npz")
    start = 0
    vecs = np.zeros((len(paths), model.outputdim), np.float32)
    barrier()
    if os.path.exists(ckpt):
        z = np.load(ckpt)
        start = int(z["done"])
        vecs[:start] = z["vecs"][:start]
        say(f">> resuming at {start}/{len(paths)}")

    step = args.checkpoint_every
    for s in range(start, len(paths), step):
        chunk = paths[s : s + step]
        vecs[s : s + len(chunk)] = extract(chunk)
        if lead:
            os.makedirs(args.outputs, exist_ok=True)
            np.savez(ckpt, vecs=vecs, done=s + len(chunk))
        barrier()
        say(f">> {s + len(chunk)}/{len(paths)} done")

    if lead:
        save_path_feature(args.dataset, vecs, cfg["imlist"][: len(paths)], root=args.outputs)
        if os.path.exists(ckpt):
            os.remove(ckpt)
    barrier()
    say(">> distractor features stored")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
