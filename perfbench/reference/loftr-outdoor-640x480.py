"""Plain reference of ``loftr-outdoor-640x480``'s count path: a pair's
LoFTR coarse match count, in plain PyTorch over the weights' state dict
(no module, kernel or code of the port).

It follows LoFTR (Sun et al., CVPR 2021, arXiv:2104.00680) and its
``default_cfg`` as the released code computes it: images read grey by
OpenCV, resized to 640 x 480 and scaled to [0, 1]; ResNet-FPN_8_2's coarse
path (a 7x7/2 stem and three stages of two BasicBlocks, 1x1 ``layer3_outconv``;
frozen BN); the 2-D sine positional encoding with the released
checkpoint's temperature (``temp_bug_fix=False``: ``(-log(1e4) / d) // 2``,
a floor of a negative float, -1 at d = 256) and 1-based positions; four
(self, cross) encoder layers of elu+1 linear attention (``v / S`` then
``* S``, 1e-6 in the normaliser), merge, LayerNorm (eps 1e-6 as in the
JAX origin), the concatenating MLP and a second LayerNorm, the cross
update of image 1 reading the already updated image 0; the dual softmax
over ``t0 t1^T / d / temperature``; matches above ``thr`` outside a
``border_rm`` border that are mutual maxima; the count is their number,
capped at ``max_matches``.

``precision(tf32=True)`` runs it with TF32 on: the control.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6


@contextmanager
def precision(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_grey(path: str, w: int, h: int) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.resize(img, (w, h)).astype(np.float32) / 255.0


def _bn(x, sd, p):
    s = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + BN_EPS)
    return x * s[:, None, None] + (sd[p + ".bias"] - sd[p + ".running_mean"] * s)[:, None, None]


def _conv(x, sd, p, stride=1):
    k = sd[p + ".weight"].shape[-1]
    return F.conv2d(x, sd[p + ".weight"], None, stride=stride, padding=k // 2)


def _block(x, sd, p, stride):
    y = F.relu(_bn(_conv(x, sd, p + ".conv1", stride), sd, p + ".bn1"))
    y = _bn(_conv(y, sd, p + ".conv2"), sd, p + ".bn2")
    if stride != 1:
        x = _bn(_conv(x, sd, p + ".downsample.0", stride), sd, p + ".downsample.1")
    return F.relu(x + y)


def layer3_features(sd, x):
    """(N, 1, H, W) -> the (N, C, H/8, W/8) input of ``layer3_outconv``."""
    y = F.relu(_bn(_conv(x, sd, "backbone.conv1", 2), sd, "backbone.bn1"))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        y = _block(y, sd, f"backbone.{layer}.0", stride)
        y = _block(y, sd, f"backbone.{layer}.1", 1)
    return y


def backbone_coarse(sd, x):
    """(N, 1, H, W) -> (N, C, H/8, W/8)."""
    return _conv(layer3_features(sd, x), sd, "backbone.layer3_outconv")


def positional_encoding(h: int, w: int, d: int, device) -> torch.Tensor:
    """(h, w, d): channels [sin x, cos x, sin y, cos y] interleaved."""
    div = torch.exp(torch.arange(0, d // 2, 2, dtype=torch.float32)
                    * ((-math.log(10000.0) / d) // 2))
    y = torch.arange(1, h + 1, dtype=torch.float32)[:, None, None]
    x = torch.arange(1, w + 1, dtype=torch.float32)[None, :, None]
    pe = torch.zeros(h, w, d)
    pe[:, :, 0::4] = torch.sin(x * div).expand(h, w, -1)
    pe[:, :, 1::4] = torch.cos(x * div).expand(h, w, -1)
    pe[:, :, 2::4] = torch.sin(y * div).expand(h, w, -1)
    pe[:, :, 3::4] = torch.cos(y * div).expand(h, w, -1)
    return pe.to(device)


def _layer(sd, p, x, source, nhead):
    B, L, d = x.shape
    dh = d // nhead
    q = F.elu(x @ sd[p + ".q_proj.weight"].T).reshape(B, L, nhead, dh) + 1.0
    k = F.elu(source @ sd[p + ".k_proj.weight"].T).reshape(B, -1, nhead, dh) + 1.0
    v = (source @ sd[p + ".v_proj.weight"].T).reshape(B, -1, nhead, dh)
    s = v.shape[1]
    kv = torch.einsum("bshd,bshv->bhdv", k, v / s)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(1)) + 1e-6)
    msg = torch.einsum("blhd,bhdv,blh->blhv", q, kv, z).reshape(B, L, d) * s
    msg = F.layer_norm(msg @ sd[p + ".merge.weight"].T, (d,), sd[p + ".norm1.weight"],
                       sd[p + ".norm1.bias"], LN_EPS)
    h = F.relu(torch.cat([x, msg], -1) @ sd[p + ".mlp.0.weight"].T) @ sd[p + ".mlp.2.weight"].T
    return x + F.layer_norm(h, (d,), sd[p + ".norm2.weight"], sd[p + ".norm2.bias"], LN_EPS)


def counts(sd: Dict[str, torch.Tensor], img0: torch.Tensor, img1: torch.Tensor,
           m: dict) -> torch.Tensor:
    """(B, H, W) grey pairs in [0, 1] -> (B,) coarse match counts."""
    B = img0.shape[0]
    with torch.no_grad():
        feats = backbone_coarse(sd, torch.cat([img0, img1])[:, None])
        _, d, hc, wc = feats.shape
        t = (feats.permute(0, 2, 3, 1) + positional_encoding(hc, wc, d, feats.device))
        t = t.reshape(2 * B, hc * wc, d)
        f0, f1 = t[:B], t[B:]
        for i, kind in enumerate(m["layer_names"]):
            p = f"loftr_coarse.layers.{i}"
            if kind == "self":
                f0, f1 = _layer(sd, p, f0, f0, m["nhead"]), _layer(sd, p, f1, f1, m["nhead"])
            else:
                f0 = _layer(sd, p, f0, f1, m["nhead"])
                f1 = _layer(sd, p, f1, f0, m["nhead"])
        sim = torch.einsum("blc,bsc->bls", f0, f1) / d / m["dsmax_temperature"]
        conf = sim.softmax(1) * sim.softmax(2)
        b = m["border_rm"]
        ok = torch.zeros(hc, wc, dtype=torch.bool, device=conf.device)
        ok[b:hc - b, b:wc - b] = True
        ok = ok.reshape(-1)
        keep = (conf > m["thr"]) & ok[:, None] & ok[None, :]
        keep &= conf == conf.amax(2, keepdim=True)
        keep &= conf == conf.amax(1, keepdim=True)
        return keep.any(2).sum(1).clamp(max=m["max_matches"])


def pair_counts(sd, query: str, candidates: Sequence[str], cfg: dict, device,
                block: int = 4) -> np.ndarray:
    """Counts of ``query`` against each candidate path, ``block`` pairs a
    forward (each pair is computed on its own rows)."""
    w, h = cfg["resolution_wh"]
    q = torch.as_tensor(load_grey(query, w, h), device=device)
    out = []
    for s in range(0, len(candidates), block):
        c = torch.stack([torch.as_tensor(load_grey(p, w, h), device=device)
                         for p in candidates[s:s + block]])
        out.append(counts(sd, q.expand(len(c), -1, -1), c, cfg["matcher"]))
    return torch.cat(out).cpu().numpy().astype(np.int64)


def reranked(candidates: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The shortlist re-sorted by count, descending, ties in shortlist order."""
    return np.asarray(candidates)[np.argsort(-np.asarray(c), kind="stable")]
