"""DINOv2 ViT-L/14 with registers as the port serves it: seeded weights in
the released checkpoint's layout, the port's ``DinoV2Retrieval`` built on
the device from them, and the gallery.

The weights are drawn by the benchmark, not by the port's ``init_network``
(whose LayerScale starts at 1e-5, so that 24 blocks would leave the tokens
where the embedding put them and a check would not see the attention):
patch and linear weights He-normal at unit gain, ``qkv`` at twice that so
that a head's logits spread by about 2 and its softmax is not flat,
LayerScale gammas near 0.2 so that 24 residual blocks keep the tokens of
order one, LayerNorm affines perturbed around the identity, CLS, register
and position tokens of order one so that positions matter.
"""

from __future__ import annotations

import torch

from perfbench.harness import gallery as gallery_mod
from perfbench.harness.weights import he, seeded_state_dict, template

LAYERSCALE = 0.2
WIDTHS = ("patch_size", "embed_dim", "depth", "num_heads", "mlp_dim", "num_register_tokens",
          "pos_grid")


def module_kwargs(cfg: dict) -> dict:
    return {k: int(cfg[k]) for k in WIDTHS}


def _rule(name: str, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if name in ("cls_token", "register_tokens", "mask_token"):
        return z
    if name == "pos_embed":
        return 0.5 * z
    if leaf == "gamma":
        return LAYERSCALE * (1.0 + 0.1 * z)
    if z.dim() >= 2:                                   # patch, qkv, proj, fc1, fc2
        return he(z, 2.0 if name.endswith("qkv.weight") else 1.0)
    is_norm = ".norm" in f".{name}"
    if leaf == "weight" and is_norm:
        return 1.0 + 0.1 * z
    return (0.1 if is_norm else 0.01) * z             # LayerNorm shift or linear bias


def state_dict(cfg: dict, seed: int, device) -> dict:
    """The seeded weights, in the released layout, on ``device``."""
    from image_search_engine_for_historical_research_tpu_torch.models.vit import (
        DinoV2Retrieval,
    )

    shapes = template(lambda: DinoV2Retrieval(**module_kwargs(cfg)))
    return seeded_state_dict(shapes, _rule, seed, "dinov2.weights", device)


def build_model(cfg: dict, sd: dict, device):
    """The port's ``RetrievalModel`` with ``sd`` loaded (strict), with the
    ``meta`` that ``init_network`` gives the architecture."""
    from image_search_engine_for_historical_research_tpu_torch.models.retrieval import (
        RetrievalModel,
    )
    from image_search_engine_for_historical_research_tpu_torch.models.vit import (
        DinoV2Retrieval,
    )

    with torch.device(device):
        module = DinoV2Retrieval(**module_kwargs(cfg))
    module.load_state_dict(sd, strict=True)
    module = module.eval().requires_grad_(False)
    meta = {"architecture": cfg["architecture"], "pooling": "cls", "regional": False,
            "whitening": False, "mean": list(cfg["mean"]), "std": list(cfg["std"]),
            "outputdim": int(cfg["embed_dim"]), "soa": False}
    return RetrievalModel(module=module, meta=meta)


def make_gallery(cfg: dict, seed: int, device) -> torch.Tensor:
    return gallery_mod.make_gallery(seed, cfg["gallery"], device)


def gallery_paths(cfg: dict):
    """One path a gallery row, in the order of ``cfg["gallery"]["parts"]``."""
    out = []
    for part, n in cfg["gallery"]["parts"].items():
        out.extend(f"{part}/{i:07d}.jpg" for i in range(n))
    return out
