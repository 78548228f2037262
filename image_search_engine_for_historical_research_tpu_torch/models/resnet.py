"""ResNet backbone with second-order attention (SOLAR) blocks.

Port of ``image_search_engine_for_historical_research_tpu/models/resnet.py``
(:36-242). Modules are named as in the SOLAR checkpoint (``conv1.0/1``,
``conv2_x.2.<i>``, ``conv{3,4,5}_x.<i>``, ``soa{4,5}.{f,g}.{0,1}``, ``.h``,
``.v``), so a checkpoint loads with ``load_state_dict(strict=True)``.

The public layout is the JAX package's: ``forward`` takes NHWC images and a
``(B, H, W)`` validity mask and returns NHWC features. Inside, the stack runs
NCHW (a permuted NHWC tensor, i.e. channels-last memory). The mask is
subsampled per stage and re-applied after every block, after the max-pool and
after each SOA block; SOA masks invalid keys with -1e30 before the softmax.

Two training knobs, as in JAX (:155-242): ``frozen_stages=k`` runs the stem
and stages 1..k under ``torch.no_grad()``, so autograd records nothing there
(``k=3``, the stem and ``conv2_x``-``conv4_x``, is the reference's own
``no_grad`` boundary, ``networks.py:194-198``, and JAX's ``stop_gradient``
after layer 3); ``remat`` runs each ``Bottleneck`` that records a backward
under ``torch.utils.checkpoint`` (``use_reentrant=False``), so its
activations are recomputed in the backward instead of kept.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

# stage depths per architecture (torchvision table)
STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}

# per-stage subsampling of the input mask: after the stem, then stages 1-4
_MASK_STRIDES = (4, 4, 8, 16, 32)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (parameters stay f32,
    like the JAX package's ``dtype=compute_dtype`` convs)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm that always uses its stored statistics (NCHW):
    ``x * s + (bias - mean * s)`` with ``s = weight / sqrt(var + eps)``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the affine in the parameters' f32 (in f64 for an f64 input), then
        # cast to the input's dtype
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        inv = self.weight.to(dt) / torch.sqrt(self.running_var.to(dt) + self.eps)
        shift = self.bias.to(dt) - self.running_mean.to(dt) * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (4x) + shortcut."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = None
        if use_projection:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, width * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(width * 4),
            )
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class SOABlock(nn.Module):
    """Second-order attention over feature-map positions:
    ``v(softmax(mid^-0.5 f(x)^T g(x)) h(x)) + x``; ``v`` starts at zero, so a
    fresh block is the identity. The mask restricts keys to valid pixels."""

    def __init__(self, in_ch: int, mid_ch: int):
        super().__init__()
        self.mid_ch = mid_ch
        self.f = nn.Sequential(Conv2d(in_ch, mid_ch, 1), FrozenBatchNorm2d(mid_ch), nn.ReLU())
        self.g = nn.Sequential(Conv2d(in_ch, mid_ch, 1), FrozenBatchNorm2d(mid_ch), nn.ReLU())
        self.h = Conv2d(in_ch, mid_ch, 1)
        self.v = Conv2d(mid_ch, mid_ch * (in_ch // mid_ch), 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        B, C, H, W = x.shape
        N = H * W
        f_x = self.f(x).flatten(2).transpose(1, 2)            # (B, N, mid)
        g_x = self.g(x).flatten(2)                            # (B, mid, N)
        h_x = self.h(x).flatten(2).transpose(1, 2)            # (B, N, mid)
        # logits and softmax in f32 at least (in f64 when the compute is f64)
        acc = torch.promote_types(f_x.dtype, torch.float32)
        logits = self.mid_ch ** (-0.5) * torch.bmm(f_x.to(acc), g_x.to(acc))
        if mask is not None:
            logits = logits.masked_fill(~mask.reshape(B, 1, N), -1e30)
        attn = logits.softmax(dim=-1)
        z = torch.bmm(attn.to(h_x.dtype), h_x).to(x.dtype)   # (B, N, mid)
        z = z.transpose(1, 2).reshape(B, self.mid_ch, H, W)
        return self.v(z) + x


def _apply_mask(z: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    return z if m is None else z * m[:, None].to(z.dtype)


class ResNetSOA(nn.Module):
    """conv1..conv5_x backbone + SOA4/SOA5. ``forward(x NHWC, mask)`` returns
    the final ``(B, H/32, W/32, 2048)`` NHWC feature map and its mask."""

    def __init__(self, architecture: str = "resnet101", soa_layers: str = "45",
                 compute_dtype: Optional[torch.dtype] = None, frozen_stages: int = 0,
                 remat: bool = False):
        super().__init__()
        blocks = STAGE_BLOCKS[architecture]
        self.soa_layers = soa_layers
        self.compute_dtype = compute_dtype
        self.frozen_stages = frozen_stages
        self.remat = remat
        self.conv1 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False), FrozenBatchNorm2d(64)
        )
        stages = []
        in_ch = 64
        for n_blocks, width, stride in zip(blocks, (64, 128, 256, 512), (1, 2, 2, 2)):
            stage = []
            for b in range(n_blocks):
                stage.append(Bottleneck(in_ch, width, stride if b == 0 else 1,
                                        use_projection=(b == 0)))
                in_ch = width * 4
            stages.append(nn.Sequential(*stage))
        self.conv2_x = nn.Sequential(
            nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1), stages[0]
        )
        self.conv3_x, self.conv4_x, self.conv5_x = stages[1:]
        if "4" in soa_layers:
            self.soa4 = SOABlock(1024, 1024 // 4)
        if "5" in soa_layers:
            self.soa5 = SOABlock(2048, 2048 // 2)

    def _grad_mode(self, stage: int):
        """``no_grad`` for the stem (stage 0) and stages 1..``frozen_stages``
        when any stage is frozen."""
        frozen = self.frozen_stages and stage <= self.frozen_stages
        return torch.no_grad() if frozen else contextlib.nullcontext()

    def _block(self, block: nn.Module, y: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, y, use_reentrant=False)
        return block(y)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x.permute(0, 3, 1, 2)                              # NHWC -> NCHW view
        masks = [None] * 5
        if mask is not None:
            x = _apply_mask(x, mask)
            masks = [mask[:, ::f, ::f] for f in _MASK_STRIDES]

        with self._grad_mode(0):
            y = self.conv1(x)
            y = self.conv2_x[1](self.conv2_x[0](y))            # ReLU, max-pool
            y = _apply_mask(y, masks[0])
        stages = (self.conv2_x[2], self.conv3_x, self.conv4_x, self.conv5_x)
        for i, stage in enumerate(stages, 1):
            with self._grad_mode(i):
                for block in stage:
                    y = _apply_mask(self._block(block, y), masks[i])
            if i == 3 and "4" in self.soa_layers:
                y = _apply_mask(self.soa4(y, masks[3]), masks[3])
        if "5" in self.soa_layers:
            y = _apply_mask(self.soa5(y, masks[4]), masks[4])
        return y.permute(0, 2, 3, 1), masks[4]
