"""Optimizer construction with the reference's parameter-group policy.

Port of ``image_search_engine_for_historical_research_tpu/train/optim.py``
(the reference's ``main_train.py:253-305``) onto torch parameter groups:

- with the backbone frozen, the stem and ``conv2_x``-``conv4_x`` (JAX's
  ``conv1``, ``bn1``, ``layer1``-``layer3``) get ``requires_grad_(False)`` and
  are in no group (JAX's ``set_to_zero``);
- the GeM exponent ``p`` trains at ``lr * gem_p_lr_mult`` with no weight
  decay;
- everything else trains at ``lr``: ``AdamW(weight_decay=wd)``, or ``Adam``
  when ``wd`` is 0 (optax's ``adamw`` / ``adam``), or SGD with momentum 0.9
  and the decay added to the gradient (optax's ``add_decayed_weights`` before
  ``sgd``);
- the exponential decay ``exp(-exp_decay * epoch)`` runs per optimizer step
  as a ``LambdaLR``: step ``k`` (counted from 0, before the increment, as
  optax counts) uses ``lr * exp(-exp_decay * k * epochs_per_step)``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

# the port's names of JAX's FROZEN_PREFIXES ("conv1", "bn1", "layer1".."layer3"):
# the stem (conv + BN) and stages 1-3, i.e. everything before soa4 / conv5_x
FROZEN_PREFIXES = ("features.conv1.", "features.conv2_x.", "features.conv3_x.",
                   "features.conv4_x.")
GEM_P_NAMES = ("pool.p", "pool.rpool.p")


def param_labels(module: nn.Module, freeze_backbone: bool = True) -> Dict[str, str]:
    """Parameter name -> ``"frozen"`` (the stem and stages 1-3),
    ``"gem_p"`` or ``"train"``."""
    labels = {}
    for name, _ in module.named_parameters():
        if name in GEM_P_NAMES:
            labels[name] = "gem_p"
        elif freeze_backbone and name.startswith(FROZEN_PREFIXES):
            labels[name] = "frozen"
        else:
            labels[name] = "train"
    return labels


def make_optimizer(
    module: nn.Module,
    lr: float = 1e-6,
    weight_decay: float = 1e-6,
    exp_decay: float = 0.01,
    epochs_per_step: float = 0.0,
    freeze_backbone: bool = True,
    optimizer: str = "adam",
    gem_p_lr_mult: float = 100.0,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR, Dict[str, str]]:
    """``(optimizer, scheduler, labels)`` over ``module``'s parameters.
    Sets ``requires_grad`` on every parameter: False for the frozen group,
    True for the rest. ``epochs_per_step`` maps the per-epoch decay onto
    optimizer steps (``1 / steps_per_epoch``); 0 keeps the lr constant."""
    labels = param_labels(module, freeze_backbone)
    groups = {"train": [], "gem_p": []}
    for name, p in module.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
        if labels[name] != "frozen":
            groups[labels[name]].append(p)
    param_groups = [
        {"params": groups["train"], "lr": lr, "weight_decay": weight_decay},
        {"params": groups["gem_p"], "lr": lr * gem_p_lr_mult, "weight_decay": 0.0},
    ]
    param_groups = [g for g in param_groups if g["params"]]
    if optimizer == "adam":
        cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
        opt = cls(param_groups, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(param_groups, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer: {optimizer}")

    if epochs_per_step <= 0 or exp_decay <= 0:
        def factor(step):
            return 1.0
    else:
        def factor(step):
            return math.exp(-exp_decay * step * epochs_per_step)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor), labels
