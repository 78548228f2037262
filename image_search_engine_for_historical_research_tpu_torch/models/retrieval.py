"""The SOLAR global-retrieval descriptor model.

Port of ``image_search_engine_for_historical_research_tpu/models/retrieval.py``
(:36-202): ResNet+SOA features -> (optional local whitening) -> pooling (GeM
by default, learnable ``p``) -> L2N -> (optional whitening Linear D->D) ->
L2N, returning row-major ``(B, D)`` descriptors; plus the reference's ``meta``
contract. Poolings: ``gem``, ``gemmp``, ``mac``, ``spoc`` and ``rmac``.

``regional=True`` is the reference's ``Rpool`` head (JAX :83-111): the base
pooler runs over the full map and every R-MAC grid region
(``ops.pooling.roipool``); each region vector is L2-normalized, whitened by
one shared Linear(D, D) (``pool.whiten``, Flax ``rwhiten``), normalized
again, and the regions are summed and normalized. GeM's ``p`` is shared by
all regions (``pool.rpool.p``). The region grid assumes full-extent maps, so
a masked (padded) batch raises, as in JAX; R-MAC pooling ignores the mask,
as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import normalization, pooling
from .resnet import STAGE_BLOCKS, FrozenBatchNorm2d, ResNetSOA

OUTPUT_DIM = {
    "resnet50": 2048,
    "resnet101": 2048,
    "resnet152": 2048,
}

FEATURE_DIM = 2048  # channels of conv5_x for every supported architecture


class GeM(nn.Module):
    """Holds the learnable GeM exponent as ``pool.p``: shape ``(1,)`` (GeM)
    or ``(C,)`` (per-channel GeMmp), as in the SOLAR checkpoint."""

    def __init__(self, p: float = 3.0, channels: int = 1):
        super().__init__()
        self.p = nn.Parameter(torch.full((channels,), float(p)))


class Rpool(nn.Module):
    """The regional head's parameters in the checkpoint layout: GeM's ``p``
    as ``pool.rpool.p`` (GeM and GeMmp only) and the shared region whitening
    ``pool.whiten``."""

    def __init__(self, pooling: str, p: float, dim: int = FEATURE_DIM):
        super().__init__()
        if pooling in ("gem", "gemmp"):
            self.rpool = GeM(p, dim if pooling == "gemmp" else 1)
        self.whiten = nn.Linear(dim, dim)


class SolarRetrieval(nn.Module):
    """features -> pool -> l2n -> whiten -> l2n, on NHWC images + mask."""

    def __init__(
        self,
        architecture: str = "resnet101",
        pooling: str = "gem",
        soa_layers: str = "45",
        whitening: bool = True,
        local_whitening: bool = False,
        regional: bool = False,
        p_init: float = 3.0,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        base = ("gem", "gemmp", "mac", "spoc")
        if pooling not in (base if regional else base + ("rmac",)):
            kind = "regional base pooling" if regional else "pooling"
            raise ValueError(f"unsupported {kind}: {pooling}")
        self.pooling = pooling
        self.regional = regional
        self.features = ResNetSOA(architecture, soa_layers, compute_dtype)
        if local_whitening:
            self.lwhiten = nn.Linear(FEATURE_DIM, FEATURE_DIM)
        if regional:
            self.pool = Rpool(pooling, p_init)
        elif pooling in ("gem", "gemmp"):
            self.pool = GeM(p_init, FEATURE_DIM if pooling == "gemmp" else 1)
        if whitening:
            self.whiten = nn.Linear(FEATURE_DIM, FEATURE_DIM)

    def _base_pool(self, feats, mask=None):
        if self.pooling in ("gem", "gemmp"):
            p = self.pool.rpool.p if self.regional else self.pool.p
            return pooling.gem(feats, p, mask=mask)
        if self.pooling == "mac":
            return pooling.mac(feats, mask=mask)
        if self.pooling == "spoc":
            return pooling.spoc(feats, mask=mask)
        return pooling.rmac(feats)       # the grid assumes full-extent maps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        feats, fmask = self.features(x, mask)
        feats = feats.float()  # the head always runs f32
        if hasattr(self, "lwhiten"):
            feats = self.lwhiten(feats)
        if self.regional:
            if fmask is not None:
                raise ValueError("regional pooling does not support masked (padded) "
                                 "batches; extract same-size batches instead")
            o = normalization.l2n(pooling.roipool(feats, self._base_pool))   # (B, R, D)
            o = normalization.l2n(self.pool.whiten(o))
            v = normalization.l2n(o.sum(dim=1))
        else:
            v = self._base_pool(feats, fmask)
        v = normalization.l2n(v)
        if hasattr(self, "whiten"):
            v = normalization.l2n(self.whiten(v))
        return v


@dataclass
class RetrievalModel:
    """The module and the reference's ``net.meta`` contract."""

    module: SolarRetrieval
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def outputdim(self) -> int:
        return self.meta["outputdim"]

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: conv and linear weights ~ N(0, 1/fan_in), biases
    zero, BN the identity, SOA ``v`` zero (a fresh SOA block is the identity,
    as in the JAX package), GeM ``p`` kept."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                if name.endswith(".v"):
                    m.weight.zero_()
                else:
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def init_network(params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda") -> RetrievalModel:
    """Factory mirroring the JAX ``init_network``: ``params`` keys (all
    optional) architecture, pooling, p, whitening, local_whitening, regional,
    soa, soa_layers, mean, std, compute_dtype. Weights are random from
    ``seed``; checkpoints load through ``cli.common.load_network``."""
    dev = resolve_device(device)
    params = dict(params or {})
    architecture = params.get("architecture", "resnet101")
    if architecture not in STAGE_BLOCKS:
        raise ValueError(f"unsupported architecture: {architecture}")
    soa = params.get("soa", True)
    soa_layers = params.get("soa_layers", "45") if soa else ""
    pooling_name = params.get("pooling", "gem")
    module = SolarRetrieval(
        architecture=architecture,
        pooling=pooling_name,
        soa_layers=soa_layers,
        whitening=params.get("whitening", True),
        local_whitening=params.get("local_whitening", False),
        regional=params.get("regional", False),
        p_init=float(params.get("p", 3.0)),
        compute_dtype=params.get("compute_dtype"),
    )
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(dev).eval().requires_grad_(False)
    meta = {
        "architecture": architecture,
        "local_whitening": params.get("local_whitening", False),
        "pooling": pooling_name,
        "regional": params.get("regional", False),
        "whitening": params.get("whitening", True),
        "mean": params.get("mean", [0.485, 0.456, 0.406]),
        "std": params.get("std", [0.229, 0.224, 0.225]),
        "outputdim": OUTPUT_DIM[architecture],
        "soa": soa,
        "soa_layers": soa_layers,
    }
    return RetrievalModel(module=module, meta=meta)
