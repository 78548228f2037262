"""Detector-free local feature matching (LoFTR).

Port of ``image_search_engine_for_historical_research_tpu/models/loftr.py``:
the ResNet-FPN_8_2 backbone, the 2-D sine positional encoding (with the
``temp_bug_fix=False`` temperature the released outdoor checkpoint was
trained with), the coarse transformer of alternating self / cross elu+1
linear-attention layers, dual-softmax coarse matching with border removal and
mutual maxima, fixed top-``max_matches`` selection, 5 x 5 fine windows with
the coarse features merged in, the fine transformer and the soft-argmax.

Modules carry the names of the reference's torch LoFTR (``backbone.layer1.0
.conv1``, ``loftr_coarse.layers.{i}.q_proj``, ``mlp.0`` / ``mlp.2``,
``fine_preprocess.down_proj``, ...), so ``state_dict()`` is a released-layout
checkpoint: the JAX package's ``convert_loftr_state_dict`` reads it
unchanged, and ``load_loftr_checkpoint`` loads ``outdoor_ds.ckpt``.
``from_flax_variables`` carries the JAX package's variables into the port.

Pairs are batched: ``LoFTRMatcher(img0, img1)`` takes ``(B, H, W, 1)``
grayscale images in [0, 1] (H, W divisible by 8), runs the ``2B`` images
through the backbone together and selects matches per pair. Precision
follows the JAX package's ``preferred_element_type=float32``: the attention
reductions, the similarity and everything after it are f32 whatever the
compute dtype (bf16, f32, or f64 in the tests). Every layer casts its
parameters to the input's dtype before it uses them, BN statistics
included, as JAX's ``_cast_floats`` casts the variables. LayerNorm uses
Flax's ``epsilon=1e-6``, not torch's 1e-5.

The count drivers run only what a match count needs (the backbone's coarse
path, the coarse transformer and the selection): XLA drops the fine stage
and the FPN's top-down path from JAX's count functions as dead code, and the
port does not run them either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.topk import _full_f32, _top_exact
from . import resnet
from .resnet import Conv2d
from .retrieval import init_weights

LN_EPS = 1e-6  # Flax nn.LayerNorm's default, which the JAX package uses


@dataclass(frozen=True)
class LoFTRConfig:
    """The reference's ``default_cfg`` (JAX ``LoFTRConfig``). ``remat``
    recomputes each encoder layer in the backward (training only)."""

    initial_dim: int = 128
    block_dims: Tuple[int, int, int] = (128, 196, 256)
    d_coarse: int = 256
    nhead: int = 8
    coarse_layers: Tuple[str, ...] = ("self", "cross") * 4
    temp_bug_fix: bool = False
    d_fine: int = 128
    fine_layers: Tuple[str, ...] = ("self", "cross")
    window: int = 5
    fine_concat_coarse: bool = True
    thr: float = 0.2
    border_rm: int = 2
    temperature: float = 0.1
    max_matches: int = 256
    remat: bool = False


def _f32_einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an f32 result, as JAX's ``preferred_element_type=
    float32``: bf16 and f32 operands multiply in f32; f64 operands (the f64
    tests) multiply in f64 and the result is rounded to f32."""
    dt = torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32
    return torch.einsum(eq, *(x.to(dt) for x in xs)).to(torch.float32)


# ----------------------------------------------------------------- backbone


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype (parameters stay
    f32: ``compute_dtype`` is the images' dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` at Flax's ``epsilon=1e-6``, in its input's dtype."""

    def __init__(self, d: int):
        super().__init__(d, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class FrozenBatchNorm2d(resnet.FrozenBatchNorm2d):
    """The ResNet's frozen BN in the JAX package's LoFTR cast order: its
    ``compute_dtype`` casts every variable before the forward, so the
    statistics and the affine round to the input's dtype first and the
    affine is computed in it (the ResNet's BN computes it in f32, then
    casts)."""

    def forward(self, x):
        w, b, mean, var = (t.to(x.dtype) for t in (self.weight, self.bias, self.running_mean,
                                                   self.running_var))
        root = torch.sqrt(var + self.eps)
        return x * (w / root)[:, None, None] + (b - mean * w / root)[:, None, None]


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs + BN; a 1x1 stride-2 ``downsample`` (Flax ``SAME`` on a
    1x1 kernel is no padding) when the block strides."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride), FrozenBatchNorm2d(planes))
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW with ``align_corners=True``, as the JAX
    package's gather-lerp: ``src = i * (n - 1) / (2n - 1)`` in f32, the
    fraction cast to the features' dtype."""

    def axis(z, n, dim):
        src = np.arange(2 * n, dtype=np.float32) * np.float32(n - 1) / np.float32(2 * n - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        shape = [1] * z.dim()
        shape[dim] = 2 * n
        f = torch.as_tensor(src - lo.astype(np.float32), device=z.device).reshape(shape)
        f = f.to(z.dtype)
        zl = z.index_select(dim, torch.as_tensor(lo, device=z.device))
        zh = z.index_select(dim, torch.as_tensor(hi, device=z.device))
        return zl * (1 - f) + zh * f

    return axis(axis(x, x.shape[2], 2), x.shape[3], 3)


class ResNetFPN_8_2(nn.Module):
    """ResNet + FPN at 1/8 (coarse, ``block_dims[2]`` channels) and 1/2
    (fine, ``block_dims[0]``). ``fine=False`` skips the top-down path, which
    only the fine features need."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256)):
        super().__init__()
        d0, d1, d2 = block_dims
        self.conv1 = Conv2d(1, initial_dim, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d0, 1), BasicBlock(d0, d0, 1))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1, 1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2, 1))
        self.layer3_outconv = _conv(d2, d2, 1)
        self.layer2_outconv = _conv(d1, d2, 1)
        self.layer2_outconv2 = nn.Sequential(_conv(d2, d2, 3), FrozenBatchNorm2d(d2),
                                             nn.LeakyReLU(0.01), _conv(d2, d1, 3))
        self.layer1_outconv = _conv(d0, d1, 1)
        self.layer1_outconv2 = nn.Sequential(_conv(d1, d1, 3), FrozenBatchNorm2d(d1),
                                             nn.LeakyReLU(0.01), _conv(d1, d0, 3))

    def forward(self, x, fine: bool = True):
        x1 = self.layer1(F.relu(self.bn1(self.conv1(x))))
        x2 = self.layer2(x1)
        x3_out = self.layer3_outconv(self.layer3(x2))
        if not fine:
            return x3_out, None
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _upsample2x_align_corners(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1)
                                      + _upsample2x_align_corners(x2_out))
        return x3_out, x1_out


def sine_positional_encoding(H: int, W: int, d: int, temp_bug_fix: bool = False) -> np.ndarray:
    """2-D sine PE, (H, W, d) f32, channel-interleaved [sin x, cos x, sin y,
    cos y] with 1-based positions. ``temp_bug_fix=False`` keeps the released
    checkpoints' temperature ``(-log(1e4) / d) // 2`` (a floor division of a
    negative float: -1.0 at d=256), copied as it stands."""
    pe = np.zeros((H, W, d), np.float32)
    y_pos = np.arange(1, H + 1, dtype=np.float32)[:, None]
    x_pos = np.arange(1, W + 1, dtype=np.float32)[None, :]
    if temp_bug_fix:
        div = np.exp(np.arange(0, d // 2, 2, dtype=np.float32) * (-np.log(10000.0) / (d // 2)))
    else:
        div = np.exp(np.arange(0, d // 2, 2, dtype=np.float32) * (-np.log(10000.0) / d // 2))
    pe[:, :, 0::4] = np.sin(x_pos[..., None] * div)
    pe[:, :, 1::4] = np.cos(x_pos[..., None] * div)
    pe[:, :, 2::4] = np.sin(y_pos[..., None] * div)
    pe[:, :, 3::4] = np.cos(y_pos[..., None] * div)
    return pe


# -------------------------------------------------------------- transformer


class LoFTREncoderLayer(nn.Module):
    """Linear attention (elu + 1 feature map, f32 reductions) and the
    concat-FFN residual update."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = Linear(d_model, d_model, bias=False)
        self.k_proj = Linear(d_model, d_model, bias=False)
        self.v_proj = Linear(d_model, d_model, bias=False)
        self.merge = Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
                                 Linear(2 * d_model, d_model, bias=False))
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x, source):
        B, L, d = x.shape
        h = self.nhead
        q = F.elu(self.q_proj(x).reshape(B, L, h, d // h)) + 1.0
        k = F.elu(self.k_proj(source).reshape(B, -1, h, d // h)) + 1.0
        v = self.v_proj(source).reshape(B, -1, h, d // h)
        s = v.shape[1]
        v = v / s
        kv = _f32_einsum("bshd,bshv->bhdv", k, v)
        ksum = k.sum(1, dtype=torch.float32)
        z = 1.0 / (_f32_einsum("blhd,bhd->blh", q, ksum.to(q.dtype)) + 1e-6)
        msg = torch.einsum("blhd,bhdv,blh->blhv", q.to(torch.float32), kv, z) * s
        msg = self.norm1(self.merge(msg.reshape(B, L, d).to(x.dtype)))
        return x + self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))


class LocalFeatureTransformer(nn.Module):
    """Sequential self / cross updates: ``f1``'s cross step reads the
    already-updated ``f0``. A self layer runs both sides in one call."""

    def __init__(self, d_model: int, nhead: int, layer_names):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(LoFTREncoderLayer(d_model, nhead) for _ in self.layer_names)

    def forward(self, f0, f1, remat: bool = False):
        def run(layer, x, src):
            if remat and torch.is_grad_enabled():
                return checkpoint(layer, x, src, use_reentrant=False)
            return layer(x, src)

        for layer, kind in zip(self.layers, self.layer_names):
            if kind == "self":
                both = torch.cat([f0, f1])
                f0, f1 = run(layer, both, both).split(f0.shape[0])
            else:
                f0 = run(layer, f0, f1)
                f1 = run(layer, f1, f0)
        return f0, f1


class FinePreprocess(nn.Module):
    def __init__(self, d_coarse: int, d_fine: int):
        super().__init__()
        self.down_proj = Linear(d_coarse, d_fine)
        self.merge_feat = Linear(2 * d_fine, d_fine)


# ----------------------------------------------------------------- matching


class MatchResult(NamedTuple):
    kpts0: torch.Tensor  # (B, max_matches, 2) image-0 (x, y)
    kpts1: torch.Tensor  # (B, max_matches, 2) image-1 (x, y), refined
    conf: torch.Tensor   # (B, max_matches) dual-softmax confidence, 0 if invalid

    @property
    def num_matches(self) -> torch.Tensor:
        return (self.conf > 0).sum(-1)


class LoFTRMatcher(nn.Module):
    """Coarse-to-fine matcher over a batch of pairs."""

    def __init__(self, config: Optional[LoFTRConfig] = None):
        super().__init__()
        cfg = self.config = config or LoFTRConfig()
        self.backbone = ResNetFPN_8_2(cfg.initial_dim, cfg.block_dims)
        self.loftr_coarse = LocalFeatureTransformer(cfg.d_coarse, cfg.nhead, cfg.coarse_layers)
        if cfg.fine_concat_coarse:
            self.fine_preprocess = FinePreprocess(cfg.d_coarse, cfg.d_fine)
        self.loftr_fine = LocalFeatureTransformer(cfg.d_fine, cfg.nhead, cfg.fine_layers)
        self._pe: Dict[Any, torch.Tensor] = {}

    def _pos(self, Hc, Wc, d, like):
        key = (Hc, Wc, d, like.device, like.dtype)
        if key not in self._pe:
            pe = sine_positional_encoding(Hc, Wc, d, self.config.temp_bug_fix)
            self._pe[key] = torch.from_numpy(pe).to(like.device, like.dtype)
        return self._pe[key]

    def forward(self, img0, img1, fine: bool = True, return_conf: bool = False):
        """``img0``, ``img1``: (B, H, W, 1). Returns a ``MatchResult`` of
        (B, M) rows, M = min(max_matches, L), and with ``return_conf`` also
        the (B, L, L) f32 confidence matrix (JAX's ``conf_matrix``
        intermediate). ``fine=False`` stops after the coarse selection:
        ``kpts1`` are then the coarse cell positions."""
        cfg = self.config
        B, H, W = img0.shape[:3]
        imgs = torch.cat([img0, img1]).permute(0, 3, 1, 2)
        feats_c, feats_f = self.backbone(imgs, fine=fine)
        Hc, Wc = feats_c.shape[2:]
        L, d = Hc * Wc, cfg.d_coarse
        t = (feats_c.permute(0, 2, 3, 1) + self._pos(Hc, Wc, d, feats_c)).reshape(2 * B, L, d)
        t0, t1 = self.loftr_coarse(t[:B], t[B:], remat=cfg.remat)

        # dual softmax over (B, L, S): axis 1 and axis 2 as in JAX's (1, L, S)
        sim = _f32_einsum("blc,bsc->bls", t0 / d ** 0.5, t1 / d ** 0.5) / cfg.temperature
        conf_mat = F.softmax(sim, dim=1) * F.softmax(sim, dim=2)
        del sim

        keep = conf_mat > cfg.thr
        b = cfg.border_rm
        if b > 0:
            ok = torch.zeros((Hc, Wc), dtype=torch.bool, device=keep.device)
            ok[b:-b, b:-b] = True
            ok = ok.reshape(L)
            keep &= ok[:, None] & ok[None, :]
        keep &= conf_mat == conf_mat.amax(2, keepdim=True)
        keep &= conf_mat == conf_mat.amax(1, keepdim=True)
        j_ids = torch.where(keep, conf_mat, -1.0).argmax(2)          # first maximum
        row_conf = torch.where(keep.any(2), conf_mat.gather(2, j_ids[..., None])[..., 0], 0.0)
        del keep
        top_conf, top_i = _top_exact(row_conf, min(cfg.max_matches, L))
        top_j = j_ids.gather(1, top_i)

        scale_c = H // Hc

        def xy(ids):
            return torch.stack([(ids % Wc).to(torch.float32) * scale_c,
                                (ids // Wc).to(torch.float32) * scale_c], dim=-1)

        kpts0, kpts1_c = xy(top_i), xy(top_j)
        if not fine:
            res = MatchResult(kpts0, kpts1_c, top_conf)
            return (res, conf_mat) if return_conf else res
        kpts1 = kpts1_c + self._refine(feats_f, t0, t1, top_i, top_j, Hc, Wc, H)
        res = MatchResult(kpts0, kpts1, top_conf)
        return (res, conf_mat) if return_conf else res

    def _refine(self, feats_f, t0, t1, top_i, top_j, Hc, Wc, H):
        """The fine stage: 5x5 windows around each match's cells at 1/2
        resolution, merged with the coarse features, the fine transformer,
        and the soft-argmax of the centre's similarity over image 1's
        window. Returns the (B, M, 2) offsets to add to the coarse
        ``kpts1``."""
        cfg = self.config
        B, M = top_i.shape
        Wn, half = cfg.window, cfg.window // 2
        Hf = feats_f.shape[2]
        stride = Hf // Hc
        fp = F.pad(feats_f, (half, half, half, half)).permute(0, 2, 3, 1)  # (2B, Hf+2h, Wf+2h, C)
        r = torch.arange(Wn, device=fp.device)

        def windows(fm, ids):
            # JAX's dynamic_slice at ((i // Wc) * stride, (i % Wc) * stride) of
            # the padded map; the window always fits, so no start is clamped
            rows = ((ids // Wc) * stride)[..., None, None] + r[:, None]
            cols = ((ids % Wc) * stride)[..., None, None] + r[None, :]
            bi = torch.arange(B, device=fp.device)[:, None, None, None]
            return fm[bi, rows, cols].reshape(B, M, Wn * Wn, fm.shape[-1])

        w0, w1 = windows(fp[:B], top_i), windows(fp[B:], top_j)
        if cfg.fine_concat_coarse:
            fpp = self.fine_preprocess

            def merge(w, t, ids):
                c = fpp.down_proj(t.gather(1, ids[..., None].expand(-1, -1, t.shape[-1])))
                return fpp.merge_feat(torch.cat([w, c[:, :, None].expand_as(w)], dim=-1))

            w0, w1 = merge(w0, t0, top_i), merge(w1, t1, top_j)
        w0, w1 = self.loftr_fine(w0.reshape(B * M, Wn * Wn, -1), w1.reshape(B * M, Wn * Wn, -1),
                                 remat=cfg.remat)
        center = w0[:, (Wn * Wn) // 2]
        heat = F.softmax(_f32_einsum("mc,mrc->mr", center, w1) / cfg.d_fine ** 0.5, dim=1)
        # JAX's linspace takes the default float dtype: f64 under x64, else f32
        gdt = torch.float64 if w0.dtype == torch.float64 else torch.float32
        g = torch.linspace(-1.0, 1.0, Wn, dtype=gdt, device=heat.device)
        grid = torch.stack([g.repeat(Wn), g.repeat_interleave(Wn)], dim=1)   # (WW, 2) x, y
        coords = heat.to(gdt) @ grid
        scale_f = H // Hf
        return (coords * half * scale_f).reshape(B, M, 2)


# -------------------------------------------------------------- weights


def _flax_path(key: str) -> Tuple[str, Tuple[str, ...], str]:
    """Port ``state_dict`` key -> (Flax collection, module path, leaf) of the
    JAX package's LoFTR variables (the inverse of its converter's names)."""
    *mod, leaf = key.split(".")
    if mod[0] == "fine_preprocess":
        mod = mod[1:]
    elif mod[0] == "backbone" and len(mod) >= 3 and mod[1].startswith("layer") \
            and mod[2].isdigit():
        if mod[1].endswith("outconv2"):
            mod = ["backbone", f"{mod[1]}_{mod[2]}"]
        elif len(mod) >= 5 and mod[3] == "downsample":
            mod = ["backbone", f"{mod[1]}_{mod[2]}",
                   "downsample_conv" if mod[4] == "0" else "downsample_bn"]
        else:
            mod = ["backbone", f"{mod[1]}_{mod[2]}"] + mod[3:]
    elif mod[0] in ("loftr_coarse", "loftr_fine"):
        sub = {"mlp.0": "mlp1", "mlp.2": "mlp2"}.get(".".join(mod[3:]), ".".join(mod[3:]))
        mod = [mod[0], f"layer{mod[2]}", sub]
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", tuple(mod), leaf[len("running_"):]
    is_norm = mod[-1].startswith(("bn", "norm", "downsample_bn")) or (
        mod[-1].startswith("layer") and mod[-1].endswith("outconv2_1"))
    if leaf == "weight":
        return "params", tuple(mod), "scale" if is_norm else "kernel"
    return "params", tuple(mod), leaf


def from_flax_variables(variables: Mapping, config: Optional[LoFTRConfig] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's LoFTR variables ``{"params", "batch_stats"}`` (numpy
    or JAX arrays) as a port ``state_dict``: conv kernels ``(kh, kw, I, O)``
    -> ``(O, I, kh, kw)``, Dense kernels transposed."""
    ref = LoFTRMatcher(config).state_dict()
    out = {}
    for key, t in ref.items():
        coll, path, leaf = _flax_path(key)
        node = variables[coll]
        for p in path:
            node = node[p]
        a = np.asarray(node[leaf], np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        if a.shape != tuple(t.shape):
            raise ValueError(f"{key}: Flax {'/'.join(path + (leaf,))} has shape {a.shape}, "
                             f"want {tuple(t.shape)}")
        out[key] = torch.tensor(a)
    return out


# keys a released checkpoint may hold that the port has no slot for
_IGNORED_SUFFIXES = (".num_batches_tracked",)
_IGNORED_KEYS = ("pos_encoding.pe",)


def load_loftr_checkpoint(path: str, config: Optional[LoFTRConfig] = None,
                          device="cuda") -> LoFTRMatcher:
    """A released LoFTR checkpoint (``{"state_dict": ...}``, keys possibly
    prefixed ``matcher.``) as a matcher on ``device``."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {(k[len("matcher."):] if k.startswith("matcher.") else k): v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items()
          if not k.endswith(_IGNORED_SUFFIXES) and k not in _IGNORED_KEYS}
    m = LoFTRMatcher(config or LoFTRConfig())
    m.load_state_dict(sd, strict=True)
    return m.to(dev).eval().requires_grad_(False)


def init_matcher(seed: int = 0, config: Optional[LoFTRConfig] = None, device="cuda",
                 **overrides) -> LoFTRMatcher:
    """A matcher with seeded random weights (conv and linear ~ N(0,
    1/fan_in), biases zero, BN and LayerNorm the identity), drawn on the
    host so that a seed gives the same weights on every device."""
    dev = resolve_device(device)
    m = LoFTRMatcher(config or LoFTRConfig(**overrides))
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(dev).eval().requires_grad_(False)


# ------------------------------------------------------------------ drivers


def _runner(module: LoFTRMatcher, compute_dtype):
    """``run(img0, img1, **kw)`` on the module's device, inference only,
    TF32 off, the images cast to ``compute_dtype`` (every layer computes in
    its input's dtype; JAX casts its variables the same way)."""
    dev = next(module.parameters()).device
    dtype = compute_dtype or torch.float32

    def run(img0, img1, **kw):
        img0, img1 = (torch.as_tensor(x, device=dev).to(dtype) for x in (img0, img1))
        with torch.inference_mode(), _full_f32():
            return module(img0, img1, **kw)

    return run, dev, dtype


def make_match_fn(module: LoFTRMatcher, compute_dtype=None):
    """``fn(img0 (H, W, 1), img1) -> MatchResult`` of one pair (rows
    ``(max_matches, ...)``)."""
    run, _, _ = _runner(module, compute_dtype)

    def fn(img0, img1):
        res = run(torch.as_tensor(img0)[None], torch.as_tensor(img1)[None])
        return MatchResult(*(x[0] for x in res))

    return fn


def make_batched_count_fn(module: LoFTRMatcher, compute_dtype=None):
    """``fn(imgs0 (B, H, W, 1), imgs1) -> (B,)`` match counts, one forward
    for the B pairs; the counts stay on the device (no sync)."""
    run, _, _ = _runner(module, compute_dtype)

    def fn(imgs0, imgs1):
        return run(imgs0, imgs1, fine=False).num_matches

    return fn


def make_banked_count_fn(module: LoFTRMatcher, compute_dtype=None):
    """``fn(bank (U, H, W, 1), iq (nb, B), ic (nb, B)) -> (nb, B)`` match
    counts: the unique images upload once, then every block of B pairs is
    gathered from the bank by index on the device and queued; nothing is
    read back until the caller reads the result."""
    run, dev, dtype = _runner(module, compute_dtype)

    def fn(bank, iq, ic):
        bank = torch.as_tensor(bank, device=dev).to(dtype)
        iq, ic = (torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev) for a in (iq, ic))
        return torch.stack([run(bank.index_select(0, q), bank.index_select(0, c),
                                fine=False).num_matches for q, c in zip(iq, ic)])

    return fn
