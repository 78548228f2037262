"""DINOv2 ViT with registers as a global descriptor over masked canvases.

The network is DINOv2's (Oquab et al., arXiv:2304.07193) with the register
tokens of Darcet et al. (arXiv:2309.16588), in the key layout of the
released checkpoints (``dinov2_vitl14_reg4_pretrain.pth``; the hub entry
``dinov2_vitl14_reg``), so a released state dict loads strictly:
``cls_token``, ``register_tokens``, ``mask_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma,
norm2, mlp.fc1, mlp.fc2, ls2.gamma}`` and ``norm``. ``mask_token`` (masked
image modelling) takes no part in a descriptor.

The forward takes what ``SolarRetrieval`` takes, NHWC images and a
``(B, H, W)`` validity mask, and returns L2-normalized ``(B, D)`` rows:
the final norm's CLS token. On the system's canvas (uploads of any aspect
at the top left of one square canvas):

- pixels outside the mask are zeroed, and the canvas is cut to whole
  patches at its bottom and right (the stride-``patch`` convolution's floor);
- the position embedding's patch grid, learned at ``pos_grid`` patches a
  side, is resized to the canvas's grid (bicubic, antialiased, by size:
  the ``_reg`` models' ``interpolate_offset=0``);
- a patch is a key if and only if the mask is set at its top-left pixel
  (``mask[:, ::patch, ::patch]``, as the ResNet path strides its mask);
  the CLS and register tokens are always keys, and the registers take no
  position;
- before the blocks each row's keys are packed (``pack_keys``): gathered
  in their order, with the positions they took on the canvas, into a
  sequence as long as the batch's longest row of keys, so padded patches
  are neither computed nor attended to and each row equals a forward over
  its valid tokens alone. Rows with fewer keys than the longest are
  masked past their own; where every row has as many (an upload of either
  orientation at the same scale, or no padding at all) no mask is left.

Attention runs through ``torch``'s fused attention with the key mask, if
any; on CUDA it is held to the memory-efficient kernel, which takes f32
and a mask and never holds a ``(B, heads, N, N)`` score tensor (with TF32
off it computes f32 products: 2.7e-7 from an f64 softmax at 10,614 tokens
on an H100, against 9e-5 for a TF32 product).

Spans (``utils.tracing``, on the input's device): ``vit.forward`` (one
scale's forward), ``vit.embed`` (patches, positions, tokens, packing),
``vit.attention`` (each block's attention branch) holding
``vit.attention_core`` (the masked softmax(q kᵀ) v alone), and ``vit.mlp``.
While tracing is on, the counters ``vit.token_rows`` (token rows the
blocks compute, every row of every slot after packing: ``B n``) and
``vit.key_rows`` (those that were keys) add up each forward; their
difference is the padding that packing leaves.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.normalization import l2n
from ..utils import tracing

# published widths of each architecture (dinov2/hub/backbones.py and
# dinov2/models/vision_transformer.py)
ARCHITECTURES: Dict[str, dict] = {
    "dinov2_vitl14_reg": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                              mlp_dim=4096, num_register_tokens=4, pos_grid=37),
}

LN_EPS = 1e-6


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep: Optional[torch.Tensor]) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(d)) v`` of ``(B, heads, N, d)`` tensors over the
    keys ``keep`` ``(B, N)`` marks (all keys without it)."""
    mask = None if keep is None else keep[:, None, None, :]
    if q.is_cuda:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def pack_keys(tokens: torch.Tensor, keep: torch.Tensor):
    """``(B, N, D)`` tokens and their ``(B, N)`` keys -> ``(B, n, D)``: each
    row's keys in their order, ``n`` the most keys of any row, and the
    ``(B, n)`` keys of the packed rows (``None`` where every row has ``n``;
    a shorter row is filled out with its first non-keys, masked).

    ``n`` sizes the blocks, so the key counts are read back to the host
    once a forward: one wait for the embedding, a few milliseconds at
    most against the blocks' hundreds."""
    counts = keep.sum(1)
    fewest, n = torch.stack(torch.aminmax(counts)).tolist()
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :n]
    tokens = tokens.gather(1, order[..., None].expand(-1, -1, tokens.shape[-1]))
    if fewest == n:
        return tokens, None
    return tokens, torch.arange(n, device=keep.device) < counts[:, None]


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads) \
            .permute(2, 0, 3, 1, 4)
        with tracing.span("vit.attention_core", device=x.device):
            o = attention_core(q, k, v, keep)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        with tracing.span("vit.attention", device=x.device):
            x = x + self.ls1.gamma * self.attn(self.norm1(x), keep)
        with tracing.span("vit.mlp", device=x.device):
            x = x + self.ls2.gamma * self.mlp(self.norm2(x))
        return x


class DinoV2Retrieval(nn.Module):
    """DINOv2 ViT with registers -> final norm -> CLS -> L2N, on NHWC
    images + mask."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_dim: int = 4096, num_register_tokens: int = 4,
                 pos_grid: int = 37):
        super().__init__()
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.num_register_tokens = num_register_tokens
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_dim) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def embed(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """NHWC images and mask -> ``(B, 1 + R + gh gw, D)`` tokens (CLS,
        registers, patches in row order) and the ``(B, N)`` keys (``None``
        without a mask)."""
        B, H, W, _ = x.shape
        p, G = self.patch_size, self.pos_grid
        gh, gw = H // p, W // p
        img = x.permute(0, 3, 1, 2)
        if mask is not None:
            img = img * mask[:, None].to(img.dtype)
        patches = self.patch_embed.proj(img).flatten(2).transpose(1, 2)      # (B, gh gw, D)
        D = patches.shape[-1]
        grid = self.pos_embed[:, 1:].reshape(1, G, G, D).permute(0, 3, 1, 2)
        if (gh, gw) != (G, G):
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
        patches = patches + grid.permute(0, 2, 3, 1).reshape(1, gh * gw, D)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, -1, -1)
        tokens = torch.cat([cls, self.register_tokens.expand(B, -1, -1), patches], 1)
        if mask is None:
            return tokens, None
        grid_keys = mask[:, :gh * p:p, :gw * p:p].reshape(B, gh * gw)
        keep = torch.cat([grid_keys.new_ones(B, 1 + self.num_register_tokens), grid_keys], 1)
        return tokens, keep

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with tracing.span("vit.forward", device=x.device):
            with tracing.span("vit.embed", device=x.device):
                tokens, keep = self.embed(x, mask)
                if keep is not None:
                    tokens, keep = pack_keys(tokens, keep)
            if tracing.is_on():
                B, N = tokens.shape[:2]
                tracing.count("vit.token_rows", B * N)
                tracing.count("vit.key_rows", B * N if keep is None else keep.sum())
            for blk in self.blocks:
                tokens = blk(tokens, keep)
            return l2n(self.norm(tokens[:, 0]), eps=0.0)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init: linear and patch weights ~ N(0, 1/fan_in),
        biases zero, LayerNorms the identity, LayerScale 1e-5 (DINOv2's
        ``init_values``), tokens and positions ~ N(0, 0.02^2)."""
        with torch.no_grad():
            for name, t in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if name.endswith("gamma"):
                    t.fill_(1e-5)
                elif ".norm" in f".{name}" and leaf == "weight":
                    t.fill_(1.0)
                elif leaf == "bias":
                    t.zero_()
                elif leaf == "weight":
                    fan_in = t[0].numel()
                    t.copy_(torch.randn(t.shape, generator=generator) / math.sqrt(fan_in))
                else:
                    t.copy_(0.02 * torch.randn(t.shape, generator=generator))
