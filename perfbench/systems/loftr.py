"""The LoFTR family as the port runs it: seeded weights in the released
checkpoint's layout and the port's ``LoFTRMatcher`` built on the device
from them.

He-normal convs, N(0, 1/fan_in) linear layers, BN and LayerNorm perturbed
around the identity (the port's ``init_matcher`` keeps both at the
identity, where no cast order or statistic would show). One step stands
in for training: the coarse output projection (``layer3_outconv``) has
the mean direction of layer 3's features over a few calibration
photographs projected out. Without it every position's feature shares
one large common direction, the dot-product similarity of the dual
softmax picks a few hub positions, and every pair, an image with itself
too, counts about one match; with it an image counts the cap against
itself, other views of its scene tens to hundreds, and a count moves
when a confidence crosses the threshold.
"""

from __future__ import annotations

import torch

from perfbench.harness.weights import he, seeded_state_dict, template


def loftr_config(cfg: dict):
    from image_search_engine_for_historical_research_tpu_torch.models.loftr import LoFTRConfig

    m = cfg["matcher"]
    return LoFTRConfig(
        initial_dim=m["initial_dim"], block_dims=tuple(m["block_dims"]),
        d_coarse=m["d_model"], nhead=m["nhead"], coarse_layers=tuple(m["layer_names"]),
        temp_bug_fix=m["temp_bug_fix"], d_fine=m["d_fine"],
        fine_layers=tuple(m["fine_layer_names"]), window=m["fine_window"],
        fine_concat_coarse=m["fine_concat_coarse"], thr=m["thr"], border_rm=m["border_rm"],
        temperature=m["dsmax_temperature"], max_matches=m["max_matches"])


def _rule(name: str, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[1]
    if z.dim() == 4:
        return he(z)
    if z.dim() == 2:
        return he(z, 1.0)
    if leaf == "running_var":
        return torch.exp(0.2 * z)
    if leaf == "running_mean":
        return 0.1 * z
    if leaf == "weight":                                # BN or LayerNorm scale
        return 1.0 + 0.1 * z
    return 0.1 * z if ("bn" in name or "norm" in name or "outconv2.1" in name
                       or "downsample.1" in name) else 0.01 * z


def state_dict(cfg: dict, seed: int, device, calibration=None, features=None) -> dict:
    """The seeded weights on ``device``. ``calibration``: (N, 1, H, W) grey
    photographs; ``features(sd, x)`` gives layer 3's output (the benchmark's
    plain reference), whose mean direction the output projection drops."""
    from image_search_engine_for_historical_research_tpu_torch.models.loftr import LoFTRMatcher

    lc = loftr_config(cfg)
    shapes = template(lambda: LoFTRMatcher(lc))
    sd = seeded_state_dict(shapes, _rule, seed, "loftr.weights", device)
    if calibration is not None:
        with torch.no_grad():
            mu = features(sd, calibration).mean((0, 2, 3))
            u = mu / mu.norm()
            w = sd["backbone.layer3_outconv.weight"][:, :, 0, 0]
            w = w - (w @ u)[:, None] * u[None]
            sd["backbone.layer3_outconv.weight"] = w[:, :, None, None].contiguous()
    return sd


def build_matcher(cfg: dict, sd: dict, device):
    from image_search_engine_for_historical_research_tpu_torch.models.loftr import LoFTRMatcher

    with torch.device(device):
        m = LoFTRMatcher(loftr_config(cfg))
    m.load_state_dict(sd, strict=True)
    return m.eval().requires_grad_(False)
