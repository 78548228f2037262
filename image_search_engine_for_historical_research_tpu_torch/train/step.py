"""The training step over retrieval tuples.

Port of ``image_search_engine_for_historical_research_tpu/train/step.py``;
the reference's inner loop is ``main_train.py:478-529``. A whole batch of
tuples is one forward, one backward and one optimizer step. ``update_every =
k`` is optax's ``MultiSteps``: the gradients of k micro-batches are averaged
as optax averages them (the running mean ``acc + (g - acc) / (n + 1)``), and
the parameters and the lr schedule move once every k calls.

With ``mesh=`` the images split over the ranks of a ``parallel.data_mesh``
and the step is still JAX's global-batch step: the loss and the gradient of
the loss over all ``B * S`` images. The losses do not split by rank (the SOS
term is the square root of a sum over every tuple, and a tuple may straddle
two ranks), so no rank takes a loss of its own rows: each rank gathers every
rank's descriptors, puts its own live ones back in its block, takes the loss
of the whole batch, and its backward gives its share of the gradient; a sum
over the ranks is the whole gradient.
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


def tuple_loss(S: int, loss: str = "contrastive", margin: float = 0.7,
               lambda_sos: float = 0.0):
    """``loss_of(vecs, labels)`` over a flat tuple batch of descriptors
    (``(B * S, D)``, labels -1/1/0); ``lambda_sos`` adds ``lambda_sos *
    sos_loss`` (the reference's ``--loss contrastive --sos``)."""
    if loss not in ("contrastive", "triplet"):
        raise ValueError(f"unknown loss: {loss}")

    def loss_of(vecs, labels):
        if loss == "contrastive":
            value = contrastive_loss(vecs, labels, margin=margin, S=S)
        else:
            value = triplet_loss(vecs, labels, margin=margin, S=S)
        if lambda_sos:
            value = value + lambda_sos * sos_loss(vecs, labels, S=S)
        return value

    return loss_of


def make_loss_fn(module, S: int, loss: str = "contrastive", margin: float = 0.7,
                 lambda_sos: float = 0.0):
    """``loss_fn(images, labels, mask=None)``: ``tuple_loss`` of ``module``'s
    descriptors of the ``B * S`` images."""
    loss_of = tuple_loss(S, loss=loss, margin=margin, lambda_sos=lambda_sos)

    def loss_fn(images, labels, mask=None):
        return loss_of(module(images, mask), labels)        # (B * S, D) f32

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


def make_grad_fn(module, S: int, loss: str = "contrastive", margin: float = 0.7,
                 lambda_sos: float = 0.0, mesh=None, batch_axis: str = "data"):
    """``fn(images, labels, mask=None) -> loss``: the loss over the whole
    tuple batch as a detached 0-d tensor, its gradient added to ``.grad``.

    With ``mesh``, every rank calls ``fn`` on the same whole batch (tensors
    or ``parallel.shard_batch`` results; the images' rows must divide the
    mesh), runs the forward and backward of its own block of images, and
    gets back the same loss and, in ``.grad``, the same whole gradient
    (summed over the ranks in one all-reduce, so ``.grad`` must hold no
    other gradient when ``fn`` is called)."""
    if mesh is None:
        loss_fn = make_loss_fn(module, S, loss=loss, margin=margin, lambda_sos=lambda_sos)

        def fn(images, labels, mask=None):
            value = loss_fn(images, labels, mask)
            value.backward()
            return value.detach()

        return fn

    from ..parallel.mesh import all_reduce_flat, full_rows, gather_rows, local_rows, mesh_size

    mesh_size(mesh, batch_axis)
    loss_of = tuple_loss(S, loss=loss, margin=margin, lambda_sos=lambda_sos)

    def fn(images, labels, mask=None):
        x, _ = local_rows(images, mesh, batch_axis)
        m = None if mask is None else local_rows(mask, mesh, batch_axis)[0]
        v = module(x, m)                                        # this rank's (rows, D)
        every = gather_rows(v.detach(), mesh, batch_axis)       # (B * S, D), rank order
        r, n = mesh.get_local_rank(batch_axis), v.shape[0]
        value = loss_of(torch.cat([every[:r * n], v, every[(r + 1) * n:]]), full_rows(labels))
        value.backward()
        all_reduce_flat([p.grad for p in module.parameters() if p.grad is not None], mesh,
                        batch_axis)
        return value.detach()

    return fn


def make_train_step(module, S: int, loss: str = "contrastive", margin: float = 0.7,
                    lambda_sos: float = 0.0, mesh=None, batch_axis: str = "data"):
    """``step(state, images, labels, mask=None) -> (state, loss)``: one
    forward through ``module`` (which shares ``state.module``'s parameters:
    itself, or a frozen / bf16 / remat clone), one backward, then
    ``apply_gradients``. The loss comes back as a detached 0-d tensor.
    With ``mesh`` the batch splits over its ``batch_axis`` (``make_grad_fn``):
    every rank folds in the same whole gradient, so the parameters stay
    the same on every rank."""
    grad_fn = make_grad_fn(module, S, loss=loss, margin=margin, lambda_sos=lambda_sos,
                           mesh=mesh, batch_axis=batch_axis)

    def step(state: TrainState, images, labels, mask=None):
        value = grad_fn(images, labels, mask)
        apply_gradients(state)
        return state, value

    return step
