"""Plain reference of ``dinov2-vitl14-reg4-r1m-flat``: the upload's decode,
the DINOv2 ViT-L/14-reg multi-scale descriptor, the exact top-K over the
gallery and one qge1 iteration, in plain PyTorch (f32 operations over the
weights' state dict; no module, kernel or code of the port).

The network is DINOv2's with registers (Oquab et al., arXiv:2304.07193;
Darcet et al., arXiv:2309.16588; ``dinov2/models/vision_transformer.py``
with the ``_reg`` hub settings), run on each upload alone and over its
valid tokens alone: no padding and no mask. One scale of one upload:

- the image (ImageNet mean / std), resized by the scale as the whole
  canvas is (antialiased bilinear; the mask nearest), with pixels outside
  its mask zeroed, is cut into ``patch`` x ``patch`` patches (the canvas's
  floor), and a patch is kept if the mask is set at its top-left pixel;
- each kept patch is embedded by ``patch_embed.proj`` as one matrix
  product, plus its row of the position grid (``pos_embed``'s 37 x 37
  patch part resized to the canvas's grid: bicubic, antialiased, by size);
- the tokens are CLS (plus ``pos_embed[0]``), the registers (no
  position) and the kept patches;
- 24 blocks ``x += ls1 * proj(MHA(norm1(x)))``, ``x += ls2 *
  fc2(GELU(fc1(norm2(x))))``, LayerNorm eps 1e-6, exact GELU, attention
  computed a head at a time as ``softmax(q kᵀ / sqrt(64)) v``;
- the final norm's CLS token, L2-normalized.

``v = l2n(mean_s net(resize(x, s)))`` over the scales. The decode, the
scores, the top-K, qge1 and ``precision`` are the SOLAR reference's own
functions (``solar-r101-r1m-flat.py``, loaded from its file).
``precision(tf32=True)`` runs any of it with TF32 on: the control.
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _solar():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "solar-r101-r1m-flat.py")
    spec = importlib.util.spec_from_file_location("dinov2_reference_solar_part", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_S = _solar()
precision = _S.precision
decode_canvas = _S.decode_canvas
normalize_rows = _S.normalize_rows
scores = _S.scores
top = _S.top
unit = _S.unit
qge1_query = _S.qge1_query
gaps = _S.gaps


def _ln(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def _lin(x, sd, p):
    return F.linear(x, sd[p + ".weight"], sd[p + ".bias"])


def tokens(sd: Dict[str, torch.Tensor], x: torch.Tensor, mask: torch.Tensor,
           cfg: dict) -> torch.Tensor:
    """One image ``(H, W, 3)`` and its ``(H, W)`` mask -> ``(n, D)`` tokens:
    CLS, registers, the kept patches in row order."""
    p, G = int(cfg["patch_size"]), int(cfg["pos_grid"])
    H, W = mask.shape
    gh, gw = H // p, W // p
    img = (x * mask[..., None].to(x.dtype))[:gh * p, :gw * p]
    patches = img.reshape(gh, p, gw, p, 3).permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * p * p)
    kept = mask[:gh * p:p, :gw * p:p].reshape(-1)
    w = sd["patch_embed.proj.weight"]
    D = w.shape[0]
    t = F.linear(patches[kept], w.reshape(D, -1), sd["patch_embed.proj.bias"])
    pos = sd["pos_embed"][0]
    grid = pos[1:].reshape(1, G, G, D).permute(0, 3, 1, 2)
    if (gh, gw) != (G, G):
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=True)
    t = t + grid[0].permute(1, 2, 0).reshape(gh * gw, D)[kept]
    return torch.cat([sd["cls_token"][0] + pos[:1], sd["register_tokens"][0], t])


def net(sd: Dict[str, torch.Tensor], x: torch.Tensor, mask: torch.Tensor,
        cfg: dict) -> torch.Tensor:
    """One image ``(H, W, 3)`` and its ``(H, W)`` mask -> its ``(D,)``
    descriptor of one scale."""
    eps, heads = float(cfg["ln_eps"]), int(cfg["num_heads"])
    t = tokens(sd, x, mask, cfg)
    n, D = t.shape
    hd = D // heads
    for i in range(int(cfg["depth"])):
        b = f"blocks.{i}"
        qkv = _lin(_ln(t, sd, b + ".norm1", eps), sd, b + ".attn.qkv").reshape(n, 3, heads, hd)
        o = torch.empty(n, heads, hd, dtype=t.dtype, device=t.device)
        for h in range(heads):
            q, k, v = qkv[:, 0, h], qkv[:, 1, h], qkv[:, 2, h]
            o[:, h] = ((q @ k.T) / math.sqrt(hd)).softmax(-1) @ v
        t = t + sd[b + ".ls1.gamma"] * _lin(o.reshape(n, D), sd, b + ".attn.proj")
        m = F.gelu(_lin(_ln(t, sd, b + ".norm2", eps), sd, b + ".mlp.fc1"))
        t = t + sd[b + ".ls2.gamma"] * _lin(m, sd, b + ".mlp.fc2")
    c = _ln(t[0], sd, "norm", eps)
    return c / c.norm()


def descriptor_of(sd, x: torch.Tensor, mask: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A normalized ``(H, W, 3)`` canvas and its ``(H, W)`` mask -> the
    ``(D,)`` descriptor over ``cfg["scales"]``."""
    H, W = mask.shape
    acc = 0.0
    with torch.no_grad():
        for s in cfg["scales"]:
            if s == 1.0:
                xs, ms = x, mask
            else:
                size = (int(H * s), int(W * s))
                xs = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bilinear",
                                   align_corners=False, antialias=True)[0].permute(1, 2, 0)
                ms = F.interpolate(mask[None, None].float(), size=size,
                                   mode="nearest-exact")[0, 0] > 0.5
            acc = acc + net(sd, xs, ms, cfg)
    v = acc / len(cfg["scales"])
    return v / v.norm()


def descriptor(sd, canvas_u8: np.ndarray, hw: Tuple[int, int], cfg: dict, device) -> torch.Tensor:
    """One upload's ``(D,)`` descriptor from its uint8 canvas and ``(h, w)``."""
    u8 = torch.as_tensor(canvas_u8, device=device)
    mean = torch.as_tensor(cfg["mean"], dtype=torch.float32, device=device)
    std = torch.as_tensor(cfg["std"], dtype=torch.float32, device=device)
    x = (u8.float() / 255.0 - mean) / std
    H, W = u8.shape[:2]
    mask = ((torch.arange(H, device=device)[:, None] < hw[0])
            & (torch.arange(W, device=device)[None, :] < hw[1]))
    return descriptor_of(sd, x, mask, cfg)
