"""D2-Net dense local features: the VGG16 backbone and the detection pyramid.

Port of ``image_search_engine_for_historical_research_tpu/models/d2net.py``:

- ``D2Net``: its ``dense_feature_extraction.model`` is the reference's
  truncated VGG16 (conv1_1..conv3_3 with two 2x2 max-pools,
  ``AvgPool2d(2, stride=1)``, dilated conv4_1..conv4_3, an optional final
  ReLU; stride 4), under the released checkpoint's keys
  (``dense_feature_extraction.model.<idx>``), which the JAX package's
  ``convert_d2net_state_dict`` reads;
- ``hard_detection`` (depth-wise max, 3x3 local max and the Hessian edge
  test) and ``handcrafted_localization`` (the inverse-Hessian sub-pixel
  step), on ``(H, W, C)`` maps on their device;
- ``process_multiscale``: scales (0.5, 1, 2), the summed upsampled maps,
  the banned-mask propagation, the displacement gate, bilinear descriptors.
  The maps, resizes and selections run on the module's device; the JAX
  package runs the selections in host numpy. Its resizes are torch's
  ``align_corners=True`` bilinear with float64 weights, cast to f32 after,
  and torch's legacy ``nearest`` (source row ``floor(i * H / h)``); the
  port computes the same 1-d weights and indices on the host and applies
  them on the device in f64. Each scale reads back twice: the size of
  ``torch.nonzero`` and whether any keypoint's corners are valid;
- ``extract_d2net_features``: padded ``LocalFeatures`` for the verifiers;
- the compact stand-in ``DenseFeatureNet`` with the soft ``detect_keypoints``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.topk import _full_f32, _top_exact
from .retrieval import init_weights


# ---------------------------------------------------------------- backbone


def _vgg_layers(use_relu: bool):
    def conv(cin, cout, dilation=1):
        return nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)

    layers = [conv(3, 64), nn.ReLU(), conv(64, 64), nn.ReLU(), nn.MaxPool2d(2, 2),
              conv(64, 128), nn.ReLU(), conv(128, 128), nn.ReLU(), nn.MaxPool2d(2, 2),
              conv(128, 256), nn.ReLU(), conv(256, 256), nn.ReLU(), conv(256, 256), nn.ReLU(),
              nn.AvgPool2d(2, stride=1),
              conv(256, 512, 2), nn.ReLU(), conv(512, 512, 2), nn.ReLU(), conv(512, 512, 2)]
    if use_relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class DenseFeatureExtraction(nn.Module):
    def __init__(self, use_relu: bool = True):
        super().__init__()
        self.model = _vgg_layers(use_relu)


class D2Net(nn.Module):
    """``forward(images (B, H, W, 3)) -> (B, h, w, 512)`` dense features
    (NHWC in and out, as the JAX package's ``DenseFeatureExtraction``)."""

    def __init__(self, use_relu: bool = True):
        super().__init__()
        self.dense_feature_extraction = DenseFeatureExtraction(use_relu)

    def forward(self, x):
        return self.dense_feature_extraction.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def load_d2net_checkpoint(path: str, use_relu: bool = True, device="cuda") -> D2Net:
    """A released ``d2_tf.pth`` / ``d2_ots.pth`` (``{"model": ...}``) as a
    ``D2Net`` on ``device``."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    m = D2Net(use_relu)
    m.load_state_dict({k: v for k, v in sd.items() if k.startswith("dense_feature_extraction.")},
                      strict=True)
    return m.to(dev).eval().requires_grad_(False)


def init_d2net(use_relu: bool = True, seed: int = 0, device="cuda") -> D2Net:
    """A ``D2Net`` with seeded random weights (N(0, 1/fan_in), biases zero),
    drawn on the host."""
    dev = resolve_device(device)
    m = D2Net(use_relu)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(dev).eval().requires_grad_(False)


# ------------------------------------------------- stencils (zero-padded 3x3)


def _shift(x, di, dj):
    """Zero-padded shift of (H, W, C): ``out[i, j] = x[i + di, j + dj]``."""
    H, W = x.shape[:2]
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    return p[1 + di:1 + di + H, 1 + dj:1 + dj + W]


def _hessian(x):
    dii = _shift(x, -1, 0) - 2.0 * x + _shift(x, 1, 0)
    djj = _shift(x, 0, -1) - 2.0 * x + _shift(x, 0, 1)
    dij = 0.25 * (_shift(x, -1, -1) - _shift(x, -1, 1) - _shift(x, 1, -1) + _shift(x, 1, 1))
    return dii, dij, djj


def hard_detection(feats: torch.Tensor, edge_threshold: float = 5.0) -> torch.Tensor:
    """Boolean (H, W, C) detections of (H, W, C) features: the channel's
    maximum over depth, a 3x3 local maximum (-inf padding), and not an
    edge by the Hessian's trace / determinant ratio."""
    is_depth_max = feats == feats.amax(-1, keepdim=True)
    local_max = F.max_pool2d(feats.permute(2, 0, 1)[None], 3, stride=1, padding=1)[0]
    is_local_max = feats == local_max.permute(1, 2, 0)
    dii, dij, djj = _hessian(feats)
    det = dii * djj - dij * dij
    tr = dii + djj
    threshold = (edge_threshold + 1) ** 2 / edge_threshold
    return is_depth_max & is_local_max & (tr * tr / det <= threshold) & (det > 0)


def handcrafted_localization(feats: torch.Tensor) -> torch.Tensor:
    """Sub-pixel steps (H, W, C, 2) as (step_i, step_j)."""
    dii, dij, djj = _hessian(feats)
    det = dii * djj - dij * dij
    inv00, inv01, inv11 = djj / det, -dij / det, dii / det
    di = 0.5 * (_shift(feats, 1, 0) - _shift(feats, -1, 0))
    dj = 0.5 * (_shift(feats, 0, 1) - _shift(feats, 0, -1))
    return torch.stack([-(inv00 * di + inv01 * dj), -(inv01 * di + inv11 * dj)], dim=-1)


# ----------------------------------------------------- resize (torch-exact)


def _resize_bilinear_ac(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of (H, W, C): the JAX
    package's numpy form, float64 weights from ``np.linspace`` (host), the
    lerp in f64 on ``x``'s device, cast back to ``x``'s dtype."""
    H, W = x.shape[:2]
    h, w = size
    yi = np.linspace(0, H - 1, h) if h > 1 else np.zeros(1)
    xi = np.linspace(0, W - 1, w) if w > 1 else np.zeros(1)
    y0, x0 = np.floor(yi).astype(np.int64), np.floor(xi).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)

    def dev(a):
        return torch.as_tensor(a, device=x.device)

    wy = dev(yi - y0)[:, None, None]
    wx = dev(xi - x0)[None, :, None]
    z = x.to(torch.float64)
    top, bot = z.index_select(0, dev(y0)), z.index_select(0, dev(y1))
    a, b = top.index_select(1, dev(x0)), top.index_select(1, dev(x1))
    c, d = bot.index_select(1, dev(x0)), bot.index_select(1, dev(x1))
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).to(x.dtype)


def _resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Torch's legacy ``nearest`` resize of (H, W[, C]): source row
    ``floor(i * H / h)`` (not ``nearest-exact``)."""
    H, W = x.shape[:2]
    h, w = size
    yi = np.minimum((np.arange(h) * H / h).astype(np.int64), H - 1)
    xi = np.minimum((np.arange(w) * W / w).astype(np.int64), W - 1)
    return x.index_select(0, torch.as_tensor(yi, device=x.device)).index_select(
        1, torch.as_tensor(xi, device=x.device))


# ----------------------------------------------------------- the pyramid


def process_multiscale(
    image,
    module: D2Net,
    scales: Sequence[float] = (0.5, 1.0, 2.0),
    edge_threshold: float = 5.0,
):
    """Multiscale detection of ``image`` ((H, W, 3) float32, preprocessed)
    on the module's device. Returns numpy ``(keypoints (N, 3) [i, j,
    1/scale] in image coordinates, scores (N,), descriptors (N, 512)
    L2-normalized)``, each scale's detections in ``torch.nonzero`` order
    over (C, H, W). A scale whose keypoints all lose a corner is skipped,
    and then its map is not carried to the next scale (the reference's
    ``EmptyTensorError`` ``continue``)."""
    dev = next(module.parameters()).device
    image = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    h_init, w_init = image.shape[:2]
    all_kpts, all_desc, all_scores = [], [], []
    prev_dense: Optional[torch.Tensor] = None
    banned: Optional[torch.Tensor] = None

    with torch.inference_mode(), _full_f32():
        for idx, scale in enumerate(scales):
            h_level, w_level = int(h_init * scale), int(w_init * scale)
            cur = _resize_bilinear_ac(image, (h_level, w_level))
            dense = module(cur[None])[0]
            h, w = dense.shape[:2]
            if prev_dense is not None:
                dense = dense + _resize_bilinear_ac(prev_dense, (h, w))

            det = hard_detection(dense, edge_threshold=edge_threshold)
            if banned is not None:
                banned = _resize_nearest(banned.to(torch.float32), (h, w)) > 0
                det = det & ~banned[:, :, None]
                banned = det.any(-1) | banned
            else:
                banned = det.any(-1)

            cc, ii, jj = torch.nonzero(det.permute(2, 0, 1)).unbind(1)   # reads back
            disp = handcrafted_localization(dense)[ii, jj, cc]
            di, dj = disp[:, 0], disp[:, 1]
            mask = (di.abs() < 0.5) & (dj.abs() < 0.5)
            cc, ii, jj = cc[mask], ii[mask], jj[mask]
            fi = ii.to(torch.float32) + di[mask]
            fj = jj.to(torch.float32) + dj[mask]

            i0, j0 = torch.floor(fi).long(), torch.floor(fj).long()
            i1, j1 = torch.ceil(fi).long(), torch.ceil(fj).long()
            valid = (i0 >= 0) & (j0 >= 0) & (i1 < h) & (j1 < w)
            if not bool(valid.any()):                                     # reads back
                continue
            cc, ii, jj = cc[valid], ii[valid], jj[valid]
            fi, fj = fi[valid], fj[valid]
            i0, j0, i1, j1 = i0[valid], j0[valid], i1[valid], j1[valid]
            # f64 as in the JAX package's numpy (a float32 minus an int64 array)
            wi, wj = fi.to(torch.float64) - i0, fj.to(torch.float64) - j0
            dd = dense.to(torch.float64)
            desc = (dd[i0, j0] * ((1 - wi) * (1 - wj))[:, None]
                    + dd[i0, j1] * ((1 - wi) * wj)[:, None]
                    + dd[i1, j0] * (wi * (1 - wj))[:, None]
                    + dd[i1, j1] * (wi * wj)[:, None])
            desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-32)

            # feature map -> image coordinates: two x2 upscale steps (stride 4)
            ki = ((fi * 2 + 0.5) * 2 + 0.5) * (h_init / h_level)
            kj = ((fj * 2 + 0.5) * 2 + 0.5) * (w_init / w_level)
            all_kpts.append(torch.stack([ki, kj, torch.full_like(ki, 1.0 / scale)], dim=1))
            all_desc.append(desc)
            all_scores.append(dense[ii, jj, cc] / (idx + 1))
            prev_dense = dense

    if not all_kpts:
        return (np.zeros((0, 3), np.float32), np.zeros((0,), np.float32),
                np.zeros((0, 512), np.float32))
    return tuple(torch.cat(t).to(torch.float32).cpu().numpy()
                 for t in (all_kpts, all_scores, all_desc))


def extract_d2net_features(
    module: D2Net,
    image,
    max_kpts: int = 1024,
    scales: Sequence[float] = (0.5, 1.0, 2.0),
):
    """Image -> padded ``LocalFeatures`` (the top ``max_kpts`` by score, in
    numpy's ``argsort`` order, as the JAX package) for the verifiers."""
    from ..rerank.geometric import MAX_KPTS, LocalFeatures

    kpts, scores, desc = process_multiscale(image, module, scales)
    order = np.argsort(-scores)[: min(max_kpts, MAX_KPTS)]
    n = len(order)
    out = LocalFeatures(
        xy=np.zeros((MAX_KPTS, 2), np.float32),
        scale=np.zeros((MAX_KPTS,), np.float32),
        angle=np.zeros((MAX_KPTS,), np.float32),
        desc=np.zeros((MAX_KPTS, 128), np.float32),
        count=n,
        shape=tuple(np.shape(image)[:2]),
    )
    out.xy[:n] = kpts[order][:, [1, 0]]  # (x, y) convention
    out.scale[:n] = kpts[order][:, 2]
    d = desc[order]
    w = min(d.shape[1], 128)
    out.desc[:n, :w] = d[:, :w]
    norms = np.linalg.norm(out.desc[:n], axis=1, keepdims=True)
    out.desc[:n] /= np.maximum(norms, 1e-12)
    return out


# ------------------------------------------- compact stand-in (soft rule)


def _same_pad(x, k: int, stride: int):
    """Flax ``padding="SAME"`` for NCHW: ``ceil(n / stride)`` outputs, the
    odd pad at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DenseFeatureNet(nn.Module):
    """Small conv stack -> (H/4, W/4, dim) dense descriptor map; NHWC in and
    out, Flax ``SAME`` padding."""

    SPEC = ((32, 1), (32, 2), (64, 1), (64, 2))

    def __init__(self, dim: int = 128):
        super().__init__()
        chans = [3] + [c for c, _ in self.SPEC] + [dim]
        self.strides = [s for _, s in self.SPEC] + [1]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=s)
                                   for a, b, s in zip(chans, chans[1:], self.strides))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv, s in zip(self.convs, self.strides):
            x = F.relu(conv(_same_pad(x, 3, s)))
        return x.permute(0, 2, 3, 1)


def detect_keypoints(features: torch.Tensor, max_kpts: int = 512, window: int = 3):
    """Soft D2-Net detection score of (H, W, C) features: ``max_c alpha_c *
    beta_c`` with alpha the soft local maximum of channel c over a
    ``window`` neighbourhood (zero padding) and beta the ratio to the
    depth-wise maximum. Returns (xy (K, 2) in feature-map coordinates,
    scores (K,) descending, lower index first on ties, descriptors (K, C)
    L2-normalized), K = min(max_kpts, H * W)."""
    H, W, C = features.shape
    d = features
    e = torch.exp(d - d.max())
    local_sum = F.avg_pool2d(e.permute(2, 0, 1)[None], window, stride=1, padding=window // 2,
                             count_include_pad=True, divisor_override=1)[0].permute(1, 2, 0)
    alpha = e / (local_sum + 1e-12)
    beta = d / (d.amax(-1, keepdim=True) + 1e-12)
    score = (alpha * beta).amax(-1).reshape(1, -1)
    top_s, top_i = (t[0] for t in _top_exact(score, min(max_kpts, H * W)))
    xy = torch.stack([(top_i % W).to(torch.float32), (top_i // W).to(torch.float32)], dim=1)
    desc = d.reshape(-1, C)[top_i]
    desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)
    return xy, top_s, desc


def extract_dense_features(module: DenseFeatureNet, image, max_kpts: int = 512,
                           stride: int = 4):
    """Image (H, W, 3) -> ``LocalFeatures`` (image coordinates at the net
    stride) on the module's device."""
    from ..rerank.geometric import MAX_KPTS, LocalFeatures

    dev = next(module.parameters()).device
    with torch.inference_mode(), _full_f32():
        feats = module(torch.as_tensor(np.asarray(image, np.float32), device=dev)[None])[0]
        xy, _, desc = detect_keypoints(feats, max_kpts=max_kpts)
    xy, desc = xy.cpu().numpy() * stride, desc.cpu().numpy()
    n = min(max_kpts, MAX_KPTS, desc.shape[0])
    out = LocalFeatures(
        xy=np.zeros((MAX_KPTS, 2), np.float32),
        scale=np.zeros((MAX_KPTS,), np.float32),
        angle=np.zeros((MAX_KPTS,), np.float32),
        desc=np.zeros((MAX_KPTS, 128), np.float32),
        count=n,
        shape=tuple(np.shape(image)[:2]),
    )
    out.xy[:n] = xy[:n]
    out.scale[:n] = float(stride)
    w = min(desc.shape[1], 128)
    out.desc[:n, :w] = desc[:n, :w]
    return out


def init_dense_net(dim: int = 128, seed: int = 0, device="cuda") -> DenseFeatureNet:
    dev = resolve_device(device)
    m = DenseFeatureNet(dim)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(dev).eval().requires_grad_(False)
