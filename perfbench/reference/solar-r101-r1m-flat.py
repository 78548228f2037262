"""Plain reference of ``solar-r101-r1m-flat``: the upload's decode, the
ResNet101-SOLAR multi-scale masked descriptor, the exact top-K over the
gallery and one qge1 iteration, in plain PyTorch (f32 operations over the
weights' state dict; no module, kernel or code of the port).

It follows SOLAR (Ng et al., ECCV 2020, arXiv:2007.12467) and the
cnnimageretrieval test protocol as the port's JAX origin states them:
the upload is decoded by PIL and thumbnailed to ``image_size``, put at the
top left of a square zero canvas of ``image_size`` rounded up to 32 with a
validity mask; ``v = l2n(mean_s net(resize(x, s)))`` over the scales, with
antialiased bilinear resizes of the whole canvas and nearest resizes of the
mask; the net is torchvision's ResNet101 v1.5 with frozen BN, the mask
re-applied after the stem, after every bottleneck and after each SOA
block, second-order attention after stages 4 and 5 (keys outside the mask
at -1e30), masked GeM (p = 3, eps 1e-6), L2N, whitening, L2N. The gallery
is searched by cosine (rows normalized), qge1 replaces a query by the
L2-normalized sum of its top-3 gallery rows weighted ``((3 - r) / 3)^4``
and ranks the gallery again.

``precision(tf32=True)`` runs any of it with TF32 on: the control.
"""

from __future__ import annotations

import io
import math
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
MASK_STRIDES = (4, 4, 8, 16, 32)
BN_EPS = 1e-5
GEM_EPS = 1e-6
L2N_EPS = 1e-6


@contextmanager
def precision(tf32: bool):
    """TF32 on (the control) or off (the reference) for matmuls and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ decode

def decode_canvas(jpeg: bytes, image_size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG bytes -> (side, side, 3) uint8 canvas and the image's (h, w)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    img.thumbnail((image_size, image_size), Image.Resampling.LANCZOS)
    arr = np.asarray(img, np.uint8)
    side = -(-image_size // 32) * 32
    canvas = np.zeros((side, side, 3), np.uint8)
    h, w = arr.shape[:2]
    canvas[:h, :w] = arr
    return canvas, (h, w)


# -------------------------------------------------------------- descriptor

def _bn(x, sd, p):
    s = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + BN_EPS)
    return x * s[:, None, None] + (sd[p + ".bias"] - sd[p + ".running_mean"] * s)[:, None, None]


def _conv(x, sd, p, stride=1, padding=0):
    return F.conv2d(x, sd[p + ".weight"], sd.get(p + ".bias"), stride=stride, padding=padding)


def _masked(x, m):
    return x if m is None else x * m[:, None].to(x.dtype)


def _bottleneck(x, sd, p, stride, projection):
    y = F.relu(_bn(_conv(x, sd, p + ".conv1"), sd, p + ".bn1"))
    y = F.relu(_bn(_conv(y, sd, p + ".conv2", stride, 1), sd, p + ".bn2"))
    y = _bn(_conv(y, sd, p + ".conv3"), sd, p + ".bn3")
    r = _bn(_conv(x, sd, p + ".downsample.0", stride), sd, p + ".downsample.1") if projection else x
    return F.relu(y + r)


def _soa(x, sd, p, m):
    B, C, H, W = x.shape
    mid = sd[p + ".f.0.weight"].shape[0]
    f = F.relu(_bn(_conv(x, sd, p + ".f.0"), sd, p + ".f.1")).flatten(2)   # (B, mid, N)
    g = F.relu(_bn(_conv(x, sd, p + ".g.0"), sd, p + ".g.1")).flatten(2)
    h = _conv(x, sd, p + ".h").flatten(2)
    logits = mid ** -0.5 * torch.bmm(f.transpose(1, 2), g)                # (B, N, N)
    if m is not None:
        logits = logits.masked_fill(~m.reshape(B, 1, H * W), -1e30)
    z = torch.bmm(logits.softmax(-1), h.transpose(1, 2))                   # (B, N, mid)
    z = z.transpose(1, 2).reshape(B, mid, H, W)
    return _conv(z, sd, p + ".v") + x


def net(sd: Dict[str, torch.Tensor], x: torch.Tensor, mask: torch.Tensor,
        architecture: str = "resnet101") -> torch.Tensor:
    """NHWC images and (B, H, W) mask -> (B, D) descriptors of one scale."""
    sd = {k[len("features."):] if k.startswith("features.") else k: v for k, v in sd.items()}
    masks = [mask[:, ::f, ::f] for f in MASK_STRIDES]
    y = _masked(x.permute(0, 3, 1, 2), mask)
    y = _bn(_conv(y, sd, "conv1.0", 2, 3), sd, "conv1.1")
    y = _masked(F.max_pool2d(F.relu(y), 3, 2, 1), masks[0])
    prefixes = ("conv2_x.2", "conv3_x", "conv4_x", "conv5_x")
    for i, (prefix, n, stride) in enumerate(zip(prefixes, STAGES[architecture], (1, 2, 2, 2)), 1):
        for b in range(n):
            y = _masked(_bottleneck(y, sd, f"{prefix}.{b}", stride if b == 0 else 1, b == 0),
                        masks[i])
        if i == 3 and "soa4.f.0.weight" in sd:
            y = _masked(_soa(y, sd, "soa4", masks[3]), masks[3])
    if "soa5.f.0.weight" in sd:
        y = _masked(_soa(y, sd, "soa5", masks[4]), masks[4])
    m = masks[4][:, None].to(y.dtype)                                        # (B, 1, h, w)
    p = sd["pool.p"].reshape(())
    pooled = (y.clamp(min=GEM_EPS).pow(p) * m).sum((2, 3)) / m.sum((2, 3)).clamp(min=1.0)
    v = pooled.pow(1.0 / p)
    v = v / (v.norm(dim=1, keepdim=True) + L2N_EPS)
    v = F.linear(v, sd["whiten.weight"], sd["whiten.bias"])
    return v / (v.norm(dim=1, keepdim=True) + L2N_EPS)


def descriptor(sd, canvas_u8: np.ndarray, hw: Tuple[int, int], cfg: dict, device) -> torch.Tensor:
    """One upload's (D,) descriptor, as ``cfg`` (scales, mean, std) states."""
    u8 = torch.as_tensor(canvas_u8, device=device)[None]
    mean = torch.as_tensor(cfg["mean"], dtype=torch.float32, device=device)
    std = torch.as_tensor(cfg["std"], dtype=torch.float32, device=device)
    x = (u8.float() / 255.0 - mean) / std
    H, W = u8.shape[1:3]
    mask = ((torch.arange(H, device=device)[:, None] < hw[0])
            & (torch.arange(W, device=device)[None, :] < hw[1]))[None]
    acc = torch.zeros(1, sd["whiten.weight"].shape[0], device=device)
    with torch.no_grad():
        for s in cfg["scales"]:
            if s == 1.0:
                xs, ms = x, mask
            else:
                size = (int(H * s), int(W * s))
                xs = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                                   align_corners=False, antialias=True).permute(0, 2, 3, 1)
                ms = F.interpolate(mask[:, None].float(), size=size,
                                   mode="nearest-exact")[:, 0] > 0.5
            acc += net(sd, xs, ms, cfg["architecture"])
    v = acc[0] / len(cfg["scales"])
    return v / v.norm()


# ---------------------------------------------------------- search, qge1

def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """In place: rows divided by their norm."""
    return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-30))


def scores(q: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(Q, N) cosine scores of unit queries against normalized rows."""
    return q @ gallery.T


def top(q: torch.Tensor, gallery: torch.Tensor, k: int, block: int = 256):
    """Exact top-``k`` (scores, ids) of each query row, in query blocks."""
    out_s, out_i = [], []
    for s in range(0, q.shape[0], block):
        v, i = torch.topk(scores(q[s:s + block], gallery), k, dim=1)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp(min=1e-30)


def qge1_query(shortlist: torch.Tensor, gallery: torch.Tensor, k: int = 3, w: float = 4.0):
    """qge1's expanded queries from each row's shortlist (its first ``k``)."""
    r = torch.arange(k, 0, -1, device=gallery.device, dtype=torch.float32)
    weights = ((r / k) ** w)[None, :, None]
    e = (gallery[shortlist[:, :k].long()] * weights).sum(1)
    return e / (torch.linalg.vector_norm(e, dim=1, keepdim=True) + L2N_EPS)


def gaps(q: torch.Tensor, gallery: torch.Tensor, ids: torch.Tensor,
         block: int = 256) -> torch.Tensor:
    """Per row: the widest gap by which the score of ``ids[r]`` lies below
    the ``r``-th best score (0 where the ids rank as the reference ranks
    them; the size of a near-tie where two swap). Invalid or repeated ids
    give ``inf``."""
    k = ids.shape[1]
    out = []
    for s in range(0, q.shape[0], block):
        qb, ib = q[s:s + block], ids[s:s + block].long()
        best, _ = torch.topk(scores(qb, gallery), k, dim=1)
        valid = ((ib >= 0) & (ib < gallery.shape[0])).all(1)
        srt = ib.sort(1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1) if k > 1 else valid
        got = torch.einsum("qd,qkd->qk", qb, gallery[ib.clamp(0, gallery.shape[0] - 1)])
        g = (best - got).amax(1).clamp(min=0.0)
        out.append(torch.where(valid & distinct, g, torch.full_like(g, math.inf)))
    return torch.cat(out)
