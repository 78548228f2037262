"""LoFTR training: homography-supervised coarse focal and fine l2 losses.

Port of ``image_search_engine_for_historical_research_tpu/train/loftr.py``.
Each pair is an image and its warp by a known homography, so the
ground-truth coarse cell correspondences are exact. The coarse loss is the
dual-softmax focal loss over the (L, L) confidence matrix, the fine loss
the l2 between the refined matches and the homography's targets within the
fine window. AdamW runs with optax's ``warmup_exponential_decay_schedule``
reproduced step for step (``loftr_schedule``). The frozen BN statistics are
buffers of ``FrozenBatchNorm2d`` and never change. ``mesh=`` splits the
pairs over the ranks of a ``parallel.data_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.topk import _full_f32


# ------------------------------------------------------------- homographies


def random_homography(rng, height: int, width: int, jitter: float = 0.15) -> np.ndarray:
    """Random perspective warp (3, 3) f32: the 4 corners jittered by up to
    ``jitter`` of the image size, the 8-DoF DLT solved exactly (numpy; the
    JAX package's draws from the same ``rng``)."""
    rng = np.random.default_rng(rng) if not hasattr(rng, "uniform") else rng
    src = np.array([[0, 0], [width - 1, 0], [width - 1, height - 1], [0, height - 1]],
                   np.float64)
    dst = src + rng.uniform(-jitter, jitter, size=(4, 2)) * np.array([width, height], np.float64)
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A), np.asarray(b))
    return np.array([[h[0], h[1], h[2]], [h[3], h[4], h[5]], [h[6], h[7], 1.0]], np.float32)


def apply_homography(Hmat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Map (..., 2) (x, y) points through a (3, 3) homography. Each row of
    ``[x, y, 1] @ H.T`` is summed left to right without a fused
    multiply-add, as XLA computes the product on the CPU."""
    x, y = xy[..., :1], xy[..., 1:]
    p = x * Hmat[:, 0] + y * Hmat[:, 1] + Hmat[:, 2]
    return p[..., :2] / p[..., 2:3].clamp(min=1e-8)


def warp_image(img: torch.Tensor, Hmat: torch.Tensor) -> torch.Tensor:
    """Inverse-warp (H, W, C) by a homography with bilinear sampling; pixels
    that map outside the source are zero. The coordinate math is f32."""
    h, w = img.shape[:2]
    Hinv = torch.linalg.inv(Hmat.to(torch.float32))
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).to(torch.float32)
    src = apply_homography(Hinv, grid.reshape(-1, 2)).reshape(h, w, 2)
    x, y = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)

    def tap(yi, xi):
        return img[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
           + tap(y0, x0 + 1) * (wx * (1 - wy))[..., None]
           + tap(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
           + tap(y0 + 1, x0 + 1) * (wx * wy)[..., None])
    return torch.where(valid[..., None], out, 0.0)


def coarse_gt_matrix(Hmat: torch.Tensor, Hc: int, Wc: int, scale: int) -> torch.Tensor:
    """(L, L) boolean ground-truth coarse assignment: image 0's cell centres
    mapped through ``Hmat``; (i, j) is positive where centre i lands in
    cell j inside the image."""
    L = Hc * Wc
    ii = torch.arange(L, device=Hmat.device)
    x0 = (ii % Wc).to(torch.float32) * scale + scale / 2.0
    y0 = (ii // Wc).to(torch.float32) * scale + scale / 2.0
    p1 = apply_homography(Hmat, torch.stack([x0, y0], dim=1))
    cx = torch.floor(p1[:, 0] / scale).long()
    cy = torch.floor(p1[:, 1] / scale).long()
    valid = (cx >= 0) & (cx < Wc) & (cy >= 0) & (cy < Hc)
    gt = torch.zeros((L, L), dtype=torch.bool, device=Hmat.device)
    gt[ii, (cy * Wc + cx).clamp(0, L - 1)] = valid
    return gt


# ------------------------------------------------------------------ losses


def coarse_focal_loss(conf, gt, alpha: float = 0.25, gamma: float = 2.0):
    """Dual-softmax focal loss: positives weighted ``alpha (1 - p)^gamma``,
    negatives ``(1 - alpha) p^gamma``, each averaged over its own count, and
    summed."""
    c = conf.clamp(1e-6, 1 - 1e-6)
    loss_pos = -alpha * (1 - c) ** gamma * torch.log(c)
    loss_neg = -(1 - alpha) * c ** gamma * torch.log(1 - c)
    n_pos = gt.sum().clamp(min=1)
    n_neg = (~gt).sum().clamp(min=1)
    return (torch.where(gt, loss_pos, 0.0).sum() / n_pos
            + torch.where(~gt, loss_neg, 0.0).sum() / n_neg)


def fine_l2_loss(kpts0, kpts1, conf, Hmat, window_px: float):
    """l2 between the refined coordinates and the homography's targets,
    normalized by the fine window's radius, over reported matches whose
    target lies within the window."""
    err = (kpts1 - apply_homography(Hmat, kpts0)) / max(window_px, 1.0)
    ok = (conf > 0) & (torch.linalg.vector_norm(err.detach(), dim=-1) <= 1.0)
    return torch.where(ok, (err ** 2).sum(-1), 0.0).sum() / ok.sum().clamp(min=1)


# -------------------------------------------------------------- the optimizer


def loftr_schedule(step: int, lr: float = 8e-3, warmup_steps: int = 100,
                   decay_steps: int = 10000) -> float:
    """optax's ``warmup_exponential_decay_schedule(init_value=lr /
    max(warmup_steps, 1), peak_value=lr, warmup_steps, transition_steps=
    max(decay_steps, 1), decay_rate=0.5)`` at ``step``, in f32 as optax
    computes it: a linear warmup, then ``lr * 0.5 ** ((step - warmup) /
    decay_steps)``."""
    f32 = np.float32
    init, transition = lr / max(warmup_steps, 1), max(decay_steps, 1)
    if step < warmup_steps:          # warmup_steps > 0 here
        frac = f32(1) - f32(min(max(step, 0), warmup_steps)) / f32(warmup_steps)
        return float(f32(init - lr) * frac + f32(lr))
    count = step - warmup_steps
    if count <= 0:
        return float(f32(lr))
    return float(f32(lr) * np.power(f32(0.5), f32(count) / f32(transition)))


def make_loftr_optimizer(module: nn.Module, lr: float = 8e-3, weight_decay: float = 0.1,
                         warmup_steps: int = 100, decay_steps: int = 10000):
    """``(optimizer, scheduler)``: AdamW (betas 0.9 / 0.999, eps 1e-8, the
    decay on every parameter, as optax's ``adamw``) with ``loftr_schedule``
    as the lr of each step."""
    opt = torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: loftr_schedule(s, lr, warmup_steps, decay_steps) / lr)
    return opt, sched


# -------------------------------------------------------------- train step


@dataclass
class LoFTRTrainState:
    """The matcher that trains, its optimizer and lr schedule, and the count
    of steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def init_loftr_train_state(module, optimizer, scheduler) -> LoFTRTrainState:
    module.requires_grad_(True)
    optimizer.zero_grad(set_to_none=True)
    return LoFTRTrainState(module, optimizer, scheduler)


def make_loftr_loss_fn(module, fine_weight: float = 1.0, compute_dtype=None):
    """``loss(imgs (B, H, W, 1), Hmats (B, 3, 3))``: the mean over pairs of
    ``coarse focal + fine_weight * fine l2``, each pair being (img,
    warp(img, H)). The warps stay f32; ``compute_dtype`` casts the
    parameters and images for the forward (the losses stay f32)."""
    cfg = module.config
    window_px = (cfg.window // 2) * 2.0          # half-window in pixels at the 1/2 level

    def loss_fn(imgs, Hmats):
        img1 = torch.stack([warp_image(i, h) for i, h in zip(imgs, Hmats)])
        img0 = imgs
        if compute_dtype is not None:               # the layers follow the inputs' dtype
            img0, img1 = img0.to(compute_dtype), img1.to(compute_dtype)
        out, conf = module(img0, img1, return_conf=True)
        B, H, W = imgs.shape[:3]
        losses = []
        for b in range(B):
            gt = coarse_gt_matrix(Hmats[b], H // 8, W // 8, 8)
            lf = fine_l2_loss(out.kpts0[b].to(torch.float32), out.kpts1[b].to(torch.float32),
                              out.conf[b].to(torch.float32), Hmats[b], window_px)
            losses.append(coarse_focal_loss(conf[b].to(torch.float32), gt) + fine_weight * lf)
        return torch.stack(losses).mean()

    return loss_fn


def make_loftr_train_step(fine_weight: float = 1.0, compute_dtype=None,
                          accum: Optional[int] = None, mesh=None, batch_axis: str = "data"):
    """``step(state, imgs (B, H, W, 1), Hmats (B, 3, 3)) -> (state, loss)``:
    one optimizer step of ``state.module`` (``module.config.remat``
    recomputes each encoder layer in the backward). ``accum=k`` runs the
    batch as micro-batches of k pairs and steps with the mean of their
    gradients (a batch that k does not divide raises). The gradients stay in
    ``.grad`` after the step.

    With ``mesh``, every rank calls ``step`` on the same whole batch
    (tensors or ``parallel.shard_batch`` results) and runs its own ``B /
    world`` pairs, in micro-batches of ``accum`` pairs on each rank (so
    ``accum`` must divide ``B / world``: the peak stays at ``accum`` pairs a
    card); the mean of the ranks' gradients and losses (one all-reduce) is
    the whole batch's, and every rank takes the same optimizer step."""
    world = 1
    if mesh is not None:
        from ..parallel.mesh import all_reduce_flat, local_rows, mesh_size

        world = mesh_size(mesh, batch_axis)

    def step(state: LoFTRTrainState, imgs, Hmats):
        module = state.module
        dev = next(module.parameters()).device
        if mesh is not None:
            imgs = local_rows(imgs, mesh, batch_axis)[0]
            Hmats = local_rows(Hmats, mesh, batch_axis)[0]
        imgs = torch.as_tensor(imgs, device=dev)
        Hmats = torch.as_tensor(Hmats, device=dev)
        loss_fn = make_loftr_loss_fn(module, fine_weight, compute_dtype)
        B = imgs.shape[0]
        if accum and B % accum:
            if mesh is not None:
                raise ValueError(f"batch {B * world} over {world} ranks is {B} pairs a rank, "
                                 f"not divisible by accum={accum}")
            raise ValueError(f"batch {B} not divisible by accum={accum}")
        k = accum or B
        nb = B // k
        state.optimizer.zero_grad(set_to_none=True)
        total = 0.0
        with _full_f32():
            for i in range(nb):
                micro = loss_fn(imgs[i * k:(i + 1) * k], Hmats[i * k:(i + 1) * k])
                micro.backward()
                total = total + micro.detach()
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            if nb > 1:
                for g in grads:
                    g /= nb
            loss = total / nb
            if mesh is not None:
                all_reduce_flat(grads + [loss], mesh, batch_axis, mean=True)
            state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, loss

    return step
