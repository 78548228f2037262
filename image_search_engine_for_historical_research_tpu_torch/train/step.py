"""The training step over retrieval tuples.

Port of ``image_search_engine_for_historical_research_tpu/train/step.py``
without ``mesh=`` (multi-GPU, ROADMAP section 1, item 5); the reference's
inner loop is ``main_train.py:478-529``. A whole batch of tuples is one
forward, one backward and one optimizer step. ``update_every = k`` is optax's
``MultiSteps``: the gradients of k micro-batches are averaged as optax
averages them (the running mean ``acc + (g - acc) / (n + 1)``), and the
parameters and the lr schedule move once every k calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch import nn

from ..ops.losses import contrastive_loss, sos_loss, triplet_loss


@dataclass
class TrainState:
    """The module that trains, its optimizer and lr schedule, the micro-batch
    count ``step`` (JAX's ``TrainState.step``), and with ``update_every > 1``
    the micro-batches since the last update (``micro``) and the running mean
    of their gradients by parameter name (``acc``)."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    update_every: int = 1
    step: int = 0
    micro: int = 0
    acc: Dict[str, torch.Tensor] = field(default_factory=dict)


def init_train_state(module, optimizer, scheduler, update_every: int = 1) -> TrainState:
    optimizer.zero_grad(set_to_none=True)
    return TrainState(module, optimizer, scheduler, update_every=update_every)


def make_loss_fn(module, S: int, loss: str = "contrastive", margin: float = 0.7,
                 lambda_sos: float = 0.0):
    """``loss_fn(images, labels, mask=None)`` over a flat tuple batch
    (``B * S`` images, labels -1/1/0); ``lambda_sos`` adds
    ``lambda_sos * sos_loss`` (the reference's ``--loss contrastive --sos``)."""
    if loss not in ("contrastive", "triplet"):
        raise ValueError(f"unknown loss: {loss}")

    def loss_fn(images, labels, mask=None):
        vecs = module(images, mask)                     # (B * S, D) f32
        if loss == "contrastive":
            value = contrastive_loss(vecs, labels, margin=margin, S=S)
        else:
            value = triplet_loss(vecs, labels, margin=margin, S=S)
        if lambda_sos:
            value = value + lambda_sos * sos_loss(vecs, labels, S=S)
        return value

    return loss_fn


def apply_gradients(state: TrainState) -> None:
    """Take one micro-batch's gradients from ``.grad``: step the optimizer
    and the schedule and clear them, or with ``update_every = k`` fold them
    into the running mean and step with the mean every k-th call."""
    state.step += 1
    if state.update_every > 1:
        n = state.micro
        for name, p in state.module.named_parameters():
            if p.grad is None:
                continue
            g = p.grad
            state.acc[name] = g if n == 0 else state.acc[name] + (g - state.acc[name]) / (n + 1)
            p.grad = None
        state.micro += 1
        if state.micro < state.update_every:
            return
        for name, p in state.module.named_parameters():
            if name in state.acc:
                p.grad = state.acc[name]
        state.acc, state.micro = {}, 0
    state.optimizer.step()
    state.scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)


def make_train_step(module, S: int, loss: str = "contrastive", margin: float = 0.7,
                    lambda_sos: float = 0.0):
    """``step(state, images, labels, mask=None) -> (state, loss)``: one
    forward through ``module`` (which shares ``state.module``'s parameters:
    itself, or a frozen / bf16 / remat clone), one backward, then
    ``apply_gradients``. The loss comes back as a detached 0-d tensor."""
    loss_fn = make_loss_fn(module, S, loss=loss, margin=margin, lambda_sos=lambda_sos)

    def step(state: TrainState, images, labels, mask=None):
        value = loss_fn(images, labels, mask)
        value.backward()
        apply_gradients(state)
        return state, value.detach()

    return step
