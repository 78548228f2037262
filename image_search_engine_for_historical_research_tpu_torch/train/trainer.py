"""Training loop: mining -> steps -> validation -> eval -> checkpoints.

Port of ``image_search_engine_for_historical_research_tpu/train/trainer.py``
(the reference's ``main_train.py:164-435``): per-epoch tuple mining with the
current network, contrastive (+ SOS) or triplet steps, the exponential lr
decay inside the optimizer's schedule, a validation loss per epoch, the
retrieval eval every ``test_freq`` epochs, ``metrics.jsonl``, and a
checkpoint every epoch with full resume.

Checkpoints are the reference's own torch dict (``main_train.py:722-727``):
``<checkpoint_dir>/epoch_<n>.pth`` holds ``{epoch, meta, state_dict,
optimizer}`` with the ``state_dict`` in the SOLAR layout, so
``cli.common.load_network`` and the JAX package's ``load_torch_checkpoint``
both load it, plus ``scheduler``, the step and accumulation counts, the
running mean of the accumulated gradients and the mining generator's state.
JAX writes an orbax checkpoint instead; the ``train_meta.json`` and
``best.json`` sidecars are JAX's.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.images import load_train_image
from ..models.extract import extract_vectors, make_extract_fn
from ..utils.profiling import MetricsLogger
from .optim import make_optimizer
from .step import init_train_state, make_loss_fn, make_train_step
from .tuples import TuplesDataset, batch_tuples


@dataclass
class TrainConfig:
    epochs: int = 10
    lr: float = 1e-6
    weight_decay: float = 1e-6
    exp_decay: float = 0.01
    loss: str = "contrastive"
    margin: float = 0.7
    lambda_sos: float = 0.0
    image_size: int = 362          # reference --image-size default
    nnum: int = 5
    batch_tuples: int = 2          # tuples per step
    qsize: int = 2000
    poolsize: int = 20000
    freeze_backbone: bool = True   # the reference freezes conv1-4 with --soa
    checkpoint_dir: str = "runs/default"
    val_fraction: float = 0.1
    seed: int = 0
    update_every: int = 1          # gradient accumulation (main_train.py:523-529)
    test_freq: int = 1             # retrieval eval every N epochs
    # "bfloat16" runs the backbone in bf16 (f32 head, loss and parameters);
    # remat recomputes each bottleneck in the backward. Both change speed and
    # memory only: parameters and checkpoints stay f32.
    compute_dtype: Optional[str] = None
    remat: bool = False


@dataclass
class EpochMetrics:
    epoch: int
    train_loss: float
    val_loss: float
    n_tuples: int
    seconds: float
    eval_metrics: dict = field(default_factory=dict)


class Trainer:
    """Drives the mining / step / validation / eval / checkpoint cycle on the
    model's device.

    ``eval_fn(model) -> {metric: value}`` is the per-epoch retrieval eval
    (the reference's ``test()``, ``main_train.py:625-719``); build one with
    ``make_retrieval_eval``. Epoch records go to
    ``<checkpoint_dir>/metrics.jsonl``."""

    def __init__(self, model, dataset: TuplesDataset, config: TrainConfig, eval_fn=None):
        self.model = model
        self.device = model.device
        self.dataset = dataset
        self.cfg = config
        self.eval_fn = eval_fn
        dataset.nnum = config.nnum
        dataset.qsize = config.qsize
        dataset.poolsize = config.poolsize
        self.rng = np.random.default_rng(config.seed)

        # the reference decays the lr per epoch; the schedule ticks per
        # optimizer step, so map epochs onto the expected steps an epoch
        est_train_tuples = max(1, int(config.qsize * (1 - config.val_fraction)))
        steps_per_epoch = max(1, est_train_tuples // (config.batch_tuples * config.update_every))
        optimizer, scheduler, _ = make_optimizer(
            model.module, lr=config.lr, weight_decay=config.weight_decay,
            exp_decay=config.exp_decay, epochs_per_step=1.0 / steps_per_epoch,
            freeze_backbone=config.freeze_backbone,
        )
        self.state = init_train_state(model.module, optimizer, scheduler,
                                      update_every=config.update_every)
        self.S = 2 + config.nnum
        # the training forward runs through a clone that shares the
        # parameters: the stem and stages 1-3 under no_grad when the backbone
        # is frozen (the reference's boundary, networks.py:194-198), bf16 or
        # remat when asked; validation and mining use the module as it is
        overrides = {}
        if config.freeze_backbone:
            overrides["frozen_stages"] = 3
        if config.compute_dtype:
            overrides["compute_dtype"] = getattr(torch, config.compute_dtype)
        if config.remat:
            overrides["remat"] = True
        self.train_module = model.module.clone(**overrides) if overrides else model.module
        self.step_fn = make_train_step(self.train_module, self.S, loss=config.loss,
                                       margin=config.margin, lambda_sos=config.lambda_sos)
        self._val_loss_fn = make_loss_fn(model.module, self.S, config.loss, config.margin,
                                         config.lambda_sos)
        # mining embeds at about a third of the training size, like the
        # reference (traindataset.py:430-464)
        self._mine_size = max(64, (config.image_size // 3 + 31) // 32 * 32)
        self._extract_fn = make_extract_fn(model.module, scales=(1.0,))
        self.history: List[EpochMetrics] = []
        self.best_val = float("inf")
        self.start_epoch = 0
        self.metrics = MetricsLogger(os.path.join(config.checkpoint_dir, "metrics.jsonl"))

    def _embed(self, paths):
        return extract_vectors(self.model, paths, self._mine_size, scales=(1.0,),
                               batch_size=8, extract_fn=self._extract_fn)

    def _load_square(self, idx: int):
        return load_train_image(self.dataset.images[idx], self.cfg.image_size, self.rng)

    def _to_device(self, imgs, labels):
        return (torch.from_numpy(imgs).to(self.device),
                torch.from_numpy(labels).to(self.device))

    # --- checkpoints (main_train.py:722-727) ---
    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(os.path.abspath(self.cfg.checkpoint_dir), f"epoch_{epoch}.pth")

    def save_checkpoint(self, epoch: int, is_best: bool):
        d = os.path.abspath(self.cfg.checkpoint_dir)
        os.makedirs(d, exist_ok=True)
        st = self.state
        tmp = self.checkpoint_path(epoch) + ".tmp"
        torch.save({
            "epoch": epoch,
            "meta": self.model.meta,
            "state_dict": self.model.module.state_dict(),
            "optimizer": st.optimizer.state_dict(),
            "scheduler": st.scheduler.state_dict(),
            "step": st.step,
            "micro": st.micro,
            "acc": dict(st.acc),
            "rng_state": json.dumps(self.rng.bit_generator.state),
        }, tmp)
        os.replace(tmp, self.checkpoint_path(epoch))
        meta = {
            "epoch": epoch,
            "meta": self.model.meta,
            "best_val": self.best_val,
            "history": [m.__dict__ for m in self.history],
        }
        with open(os.path.join(d, "train_meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=float)
        if is_best:
            with open(os.path.join(d, "best.json"), "w") as f:
                json.dump({"epoch": epoch}, f)

    def resume(self) -> bool:
        """Restore the latest checkpoint, if there is one: the weights, the
        optimizer's moments, the schedule, the accumulation state and the
        mining generator (main_train.py:308-326)."""
        meta_path = os.path.join(os.path.abspath(self.cfg.checkpoint_dir), "train_meta.json")
        if not os.path.exists(meta_path):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        epoch = meta["epoch"]
        ckpt = torch.load(self.checkpoint_path(epoch), map_location=self.device,
                          weights_only=True)
        module = self.model.module
        module.load_state_dict(ckpt["state_dict"], strict=True)
        st = self.state
        st.optimizer.load_state_dict(ckpt["optimizer"])
        st.scheduler.load_state_dict(ckpt["scheduler"])
        st.step, st.micro = int(ckpt["step"]), int(ckpt["micro"])
        st.acc = dict(ckpt["acc"])
        st.optimizer.zero_grad(set_to_none=True)
        self.rng.bit_generator.state = json.loads(ckpt["rng_state"])
        self.best_val = float(meta.get("best_val", float("inf")))
        self.history = [EpochMetrics(**m) for m in meta.get("history", [])]
        self.start_epoch = epoch + 1
        return True

    # --- the loop ---
    def fit(self, log: Optional[Callable[[str], None]] = print):
        for epoch in range(self.start_epoch, self.cfg.epochs):
            t0 = time.time()
            tuples = self.dataset.mine_epoch(self._embed, self.rng, device=self.device)
            self.rng.shuffle(tuples)
            n_val = max(1, int(len(tuples) * self.cfg.val_fraction))
            val_tuples, train_tuples = tuples[:n_val], tuples[n_val:]

            losses = []
            for imgs, labels, _ in batch_tuples(train_tuples, self._load_square,
                                                self.cfg.batch_tuples):
                self.state, loss = self.step_fn(self.state, *self._to_device(imgs, labels))
                losses.append(float(loss))

            val_losses = []
            with torch.no_grad():
                for imgs, labels, _ in batch_tuples(
                        val_tuples, self._load_square,
                        min(self.cfg.batch_tuples, max(len(val_tuples), 1))):
                    val_losses.append(float(self._val_loss_fn(*self._to_device(imgs, labels))))

            eval_metrics = {}
            if self.eval_fn is not None and (epoch + 1) % self.cfg.test_freq == 0:
                eval_metrics = dict(self.eval_fn(self.model))

            m = EpochMetrics(
                epoch=epoch,
                train_loss=float(np.mean(losses)) if losses else float("nan"),
                val_loss=float(np.mean(val_losses)) if val_losses else float("nan"),
                n_tuples=len(tuples),
                seconds=time.time() - t0,
                eval_metrics=eval_metrics,
            )
            self.history.append(m)
            self.metrics.log(epoch, train_loss=m.train_loss, val_loss=m.val_loss,
                             n_tuples=m.n_tuples, seconds=m.seconds, step_losses=losses,
                             **eval_metrics)
            is_best = m.val_loss < self.best_val
            if is_best:
                self.best_val = m.val_loss
            self.save_checkpoint(epoch, is_best)
            if log:
                extra = "".join(f" {k} {v:.4f}" for k, v in eval_metrics.items())
                log(f"epoch {epoch}: train {m.train_loss:.4f} val {m.val_loss:.4f} "
                    f"({m.n_tuples} tuples, {m.seconds:.1f}s){extra}")
        return self.history


def make_retrieval_eval(
    datasets: dict,
    image_size: int = 362,
    scales=(1.0,),
    batch_size: int = 8,
    top_k: Optional[int] = None,
    whiten_db: Optional[dict] = None,
):
    """The per-epoch retrieval-eval hook (main_train.py:625-719).

    ``datasets``: ``{name: {"images": [paths], "qimages": [paths], "gnd":
    [revisited gnd dicts]}}``. The hook extracts gallery and query
    descriptors with the current weights, ranks with an exact flat index on
    the model's device, and reports mAP E/M/H per dataset as
    ``{name}/mapE`` etc.

    ``whiten_db``: ``{"images": [paths], "qidxs": ..., "pidxs": ...}`` (the
    reference's ``--test-whiten``, main_train.py:650-676): learn supervised
    whitening from the current descriptors of that db and add
    ``{name}+whiten`` rows (:711-718)."""

    def eval_fn(model):
        from ..evaluation import compute_map_revisited
        from ..index import build_flat
        from ..ops.whiten import whitenapply, whitenlearn

        dev = model.device

        def extract(paths):
            return extract_vectors(model, paths, image_size, scales=scales,
                                   batch_size=batch_size)

        lw = None
        if whiten_db is not None:
            wvecs = torch.as_tensor(extract(whiten_db["images"]), device=dev)
            lw = whitenlearn(wvecs, torch.as_tensor(np.asarray(whiten_db["qidxs"]), device=dev),
                             torch.as_tensor(np.asarray(whiten_db["pidxs"]), device=dev))

        out = {}
        for name, d in datasets.items():
            vecs, qvecs = extract(d["images"]), extract(d["qimages"])
            k = top_k or vecs.shape[0]
            rows = [("", vecs, qvecs)]
            if lw is not None:
                m, P = lw
                rows.append(("+whiten",
                             whitenapply(torch.as_tensor(vecs, device=dev), m, P),
                             whitenapply(torch.as_tensor(qvecs, device=dev), m, P)))
            for tag, g, q in rows:
                _, ranks = build_flat(g, device=dev).search(torch.as_tensor(q, device=dev), k)
                res = compute_map_revisited(ranks.cpu().numpy(), d["gnd"], name + tag)
                out[f"{name}{tag}/mapE"] = float(res.mapE)
                out[f"{name}{tag}/mapM"] = float(res.mapM)
                out[f"{name}{tag}/mapH"] = float(res.mapH)
        return out

    return eval_fn
