"""Training CLI: contrastive / triplet tuple training with hard-negative
mining.

Port of ``image_search_engine_for_historical_research_tpu/cli/train.py``
(the reference's ``python -m src.main_train EXPORT_DIR ...``). The run
directory's name encodes the hyperparameters (``main_train.py:178-201``);
``--resume`` restores the latest checkpoint in it. Training runs on
``--device`` (default cuda); each epoch's checkpoint is a torch dict in the
SOLAR layout that ``--network-path`` of the other CLIs loads.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.train runs \
      --training-dataset /data/train_folders --arch resnet101 --epochs 5
"""

from __future__ import annotations

import argparse
import os

from ..data import path_all_jpg
from ..device import resolve_device
from ..train import TrainConfig, Trainer, tuples_from_folders
from .common import load_network


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("export_dir")
    p.add_argument("--training-dataset", required=True,
                   help="folder-labelled image root (folder name = cluster)")
    p.add_argument("--network-path", default=None)
    p.add_argument("--arch", default="resnet101")
    p.add_argument("--loss", default="contrastive", choices=["contrastive", "triplet"])
    p.add_argument("--loss-margin", type=float, default=0.7)
    p.add_argument("--sos", action="store_true", help="add second-order loss")
    p.add_argument("--lambda", dest="lambda_sos", type=float, default=10.0)
    p.add_argument("--image-size", type=int, default=362)
    p.add_argument("--neg-num", type=int, default=5)
    p.add_argument("--query-size", type=int, default=2000)
    p.add_argument("--pool-size", type=int, default=20000)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=2, help="tuples per step")
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--weight-decay", type=float, default=1e-6)
    p.add_argument("--exp-decay", type=float, default=0.01)
    p.add_argument("--no-freeze", action="store_true",
                   help="train conv1-4 too (the reference freezes them with --soa)")
    p.add_argument("--update-every", type=int, default=1,
                   help="gradient accumulation steps (main_train.py:523-529)")
    p.add_argument("--test-freq", type=int, default=1,
                   help="run the retrieval eval every N epochs (main_train.py:625-719)")
    p.add_argument("--test-datasets", default=None,
                   help="comma list of folder-labelled roots to evaluate "
                        "retrieval mAP on every --test-freq epochs")
    p.add_argument("--test-whiten", default=None,
                   help="db pickle ({cids|images, qidxs, pidxs}) to learn "
                        "supervised whitening from each eval and report "
                        "'+whiten' mAP rows (main_train.py:650-676,711-718)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def _folder_eval_datasets(roots):
    """Folder-labelled roots -> ``make_retrieval_eval`` dataset dicts (one
    query per class, the class's images as its easy positives)."""
    import numpy as np

    out = {}
    for root in roots:
        paths, _ = path_all_jpg(root)
        labels = [p.split(os.sep)[-2] for p in paths]
        gnd, qimages = [], []
        for u in sorted(set(labels)):
            members = np.array([i for i, l in enumerate(labels) if l == u])
            qimages.append(paths[int(members[0])])
            gnd.append({
                "easy": members,
                "hard": np.empty(0, np.int64),
                "junk": np.empty(0, np.int64),
            })
        out[os.path.basename(os.path.normpath(root))] = {
            "images": paths, "qimages": qimages, "gnd": gnd,
        }
    return out


def run_name(args) -> str:
    """Run-directory name from the hyperparameters (main_train.py:178-201)."""
    parts = [
        args.arch, args.loss, f"m{args.loss_margin}",
        f"lr{args.lr}", f"wd{args.weight_decay}",
        f"nnum{args.neg_num}", f"qsize{args.query_size}",
        f"psize{args.pool_size}", f"imsize{args.image_size}",
    ]
    if args.sos:
        parts.append(f"sos{args.lambda_sos}")
    return "_".join(str(x) for x in parts)


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    db_paths, _ = path_all_jpg(args.training_dataset)
    if not db_paths:
        raise SystemExit(f"no jpgs under {args.training_dataset}")
    dataset = tuples_from_folders(db_paths)

    model = load_network(args.network_path, args.arch, device=args.device)
    cfg = TrainConfig(
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        exp_decay=args.exp_decay,
        loss=args.loss,
        margin=args.loss_margin,
        lambda_sos=args.lambda_sos if args.sos else 0.0,
        image_size=args.image_size,
        nnum=args.neg_num,
        batch_tuples=args.batch_size,
        qsize=args.query_size,
        poolsize=args.pool_size,
        freeze_backbone=not args.no_freeze,
        checkpoint_dir=os.path.join(args.export_dir, run_name(args)),
        seed=args.seed,
        update_every=args.update_every,
        test_freq=args.test_freq,
    )
    eval_fn = None
    if args.test_datasets:
        from ..train import make_retrieval_eval

        whiten_db = None
        if args.test_whiten:
            from ..train.tuples import whiten_db_from_pickle

            whiten_db = whiten_db_from_pickle(args.test_whiten)
        eval_fn = make_retrieval_eval(
            _folder_eval_datasets(args.test_datasets.split(",")),
            image_size=args.image_size, batch_size=8, whiten_db=whiten_db,
        )
    trainer = Trainer(model, dataset, cfg, eval_fn=eval_fn)
    if args.resume and trainer.resume():
        print(f">> resumed at epoch {trainer.start_epoch}")
    trainer.fit()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
