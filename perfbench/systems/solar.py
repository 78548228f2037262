"""The SOLAR family as the port serves it: seeded weights in the SOLAR
checkpoint layout, the port's ``SolarRetrieval`` built on the device from
them, the gallery and its queries.

The weights are drawn by the benchmark, not by the port's ``init_network``
(whose SOA blocks start as the identity and whose BN is the identity, so a
check of them would not see the attention or the BN): He-normal convs, the
last BN of each bottleneck at a fifth of unit gain so that 33 residual
blocks keep the activations of order one, BN statistics and affines
perturbed around the identity, SOA's ``v`` projection live.
"""

from __future__ import annotations

import torch

from perfbench.harness import gallery as gallery_mod
from perfbench.harness.weights import he, seeded_state_dict, template

RESIDUAL_BN_GAIN = 0.2


def _module_kwargs(cfg: dict) -> dict:
    return dict(architecture=cfg["architecture"], pooling=cfg["pooling"],
                soa_layers=cfg["soa_layers"], whitening=cfg["whitening"],
                p_init=float(cfg["p"]))


def _rule(name: str, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[1]
    if name in ("pool.p", "pool.rpool.p"):
        return torch.full_like(z, 3.0)
    if z.dim() == 4:                                   # conv weight
        if name.endswith(".v.weight"):
            return he(z, 0.25)
        if name.endswith((".f.0.weight", ".g.0.weight", ".h.weight")):
            return he(z, 1.0)
        return he(z)
    if z.dim() == 2:                                   # whitening
        return he(z, 1.0)
    if leaf == "running_var":
        return torch.exp(0.2 * z)
    if leaf == "running_mean":
        return 0.1 * z
    is_bn = not name.endswith((".f.0.bias", ".g.0.bias", ".h.bias", ".v.bias", "whiten.bias"))
    if leaf == "weight" and is_bn:
        gain = RESIDUAL_BN_GAIN if name.endswith(".bn3.weight") else 1.0
        return gain * (1.0 + 0.1 * z)
    return (0.1 if is_bn else 0.01) * z              # BN shift or conv / linear bias


def state_dict(cfg: dict, seed: int, device) -> dict:
    """The seeded weights, in the SOLAR checkpoint layout, on ``device``."""
    from image_search_engine_for_historical_research_tpu_torch.models.retrieval import (
        SolarRetrieval,
    )

    shapes = template(lambda: SolarRetrieval(**_module_kwargs(cfg)))
    return seeded_state_dict(shapes, _rule, seed, "solar.weights", device)


def build_model(cfg: dict, sd: dict, device):
    """The port's ``RetrievalModel`` with ``sd`` loaded (strict)."""
    from image_search_engine_for_historical_research_tpu_torch.models.retrieval import (
        OUTPUT_DIM,
        RetrievalModel,
        SolarRetrieval,
    )

    with torch.device(device):
        module = SolarRetrieval(**_module_kwargs(cfg))
    module.load_state_dict(sd, strict=True)
    module = module.eval().requires_grad_(False)
    meta = {"architecture": cfg["architecture"], "pooling": cfg["pooling"],
            "local_whitening": False, "regional": False, "whitening": cfg["whitening"],
            "mean": list(cfg["mean"]), "std": list(cfg["std"]),
            "outputdim": OUTPUT_DIM[cfg["architecture"]], "soa": True,
            "soa_layers": cfg["soa_layers"]}
    return RetrievalModel(module=module, meta=meta)


def make_gallery(cfg: dict, seed: int, device) -> torch.Tensor:
    return gallery_mod.make_gallery(seed, cfg["gallery"], device)


def gallery_paths(cfg: dict):
    """One path a gallery row, in the order of ``cfg["gallery"]["parts"]``."""
    out = []
    for part, n in cfg["gallery"]["parts"].items():
        out.extend(f"{part}/{i:07d}.jpg" for i in range(n))
    return out
