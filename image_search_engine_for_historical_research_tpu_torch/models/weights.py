"""Weights in the SOLAR checkpoint layout, and the bridge to Flax variables.

Port of ``image_search_engine_for_historical_research_tpu/models/weights.py``
(:88-150). The port's modules carry the SOLAR checkpoint's names
(``models/resnet.py``), so a checkpoint loads with ``torch.load`` +
``load_state_dict(strict=True)``. Two converters join the port to the JAX
package's Flax variable tree ``{"params", "batch_stats"}`` of numpy arrays:

- ``from_flax_variables``: Flax tree -> port ``state_dict`` (the exact inverse
  of the JAX ``convert_solar_state_dict``);
- ``to_flax_variables``: port ``state_dict`` -> Flax tree (the port's own copy
  of ``convert_solar_state_dict`` for the non-regional nets it runs).

Layouts: Flax conv ``(kh, kw, I, O)`` <-> torch ``(O, I, kh, kw)``; Flax Dense
``(I, O)`` <-> torch Linear ``(O, I)``; GeM ``p`` 0-d <-> ``pool.p`` ``(1,)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# Flax stage index -> key prefix inside ``features`` (conv2_x is
# Sequential(relu, maxpool, layer1) in the checkpoint)
_STAGE_PREFIX = {1: "conv2_x.2", 2: "conv3_x", 3: "conv4_x", 4: "conv5_x"}
_PREFIX_STAGE = {v: k for k, v in _STAGE_PREFIX.items()}
_BN_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}
_BN_TO_FLAX = {v: k for k, v in _BN_TO_TORCH.items()}
_SOA_TO_TORCH = {"f_conv": "f.0", "f_bn": "f.1", "g_conv": "g.0", "g_bn": "g.1",
                 "h_conv": "h", "v_conv": "v"}
_SOA_TO_FLAX = {v: k for k, v in _SOA_TO_TORCH.items()}
_SUB_TO_TORCH = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_SUB_TO_FLAX = {v: k for k, v in _SUB_TO_TORCH.items()}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _torch_module(path: Tuple[str, ...]) -> str:
    """Flax module path (without the leaf) -> torch module name."""
    if path[0] != "features":
        return path[0]                                   # whiten, lwhiten
    mod = path[1]
    if mod == "conv1":
        return "features.conv1.0"
    if mod == "bn1":
        return "features.conv1.1"
    m = re.fullmatch(r"layer(\d)_block(\d+)", mod)
    if m:
        sub = _SUB_TO_TORCH.get(path[2], path[2])
        return f"features.{_STAGE_PREFIX[int(m.group(1))]}.{m.group(2)}.{sub}"
    if mod in ("soa4", "soa5"):
        return f"features.{mod}.{_SOA_TO_TORCH[path[2]]}"
    raise KeyError(f"unknown Flax module path {'/'.join(path)}")


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree (numpy or array-likes) -> a
    ``state_dict`` for ``SolarRetrieval.load_state_dict(strict=True)``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            arr = np.asarray(value, np.float32)
            if path == ("gem_p",):
                sd["pool.p"] = torch.from_numpy(arr.reshape(-1).copy())
                continue
            module, leaf = _torch_module(path[:-1]), path[-1]
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                name = "weight"
            else:
                name = _BN_TO_TORCH[leaf]
            sd[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def _flax_module(module: str) -> Tuple[str, ...]:
    """torch module name -> Flax module path (inverse of ``_torch_module``)."""
    parts = module.split(".")
    if parts[0] != "features":
        return (parts[0],)
    rest = ".".join(parts[1:])
    if rest == "conv1.0":
        return ("features", "conv1")
    if rest == "conv1.1":
        return ("features", "bn1")
    if parts[1] in ("soa4", "soa5"):
        return ("features", parts[1], _SOA_TO_FLAX[".".join(parts[2:])])
    m = re.fullmatch(r"(conv2_x\.2|conv[345]_x)\.(\d+)\.(.+)", rest)
    if m:
        block = f"layer{_PREFIX_STAGE[m.group(1)]}_block{m.group(2)}"
        return ("features", block, _SUB_TO_FLAX.get(m.group(3), m.group(3)))
    raise KeyError(f"unknown torch module {module}")


def to_flax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Port ``state_dict`` -> Flax ``{"params", "batch_stats"}`` numpy tree."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        if key == "pool.p":
            out["params"]["gem_p"] = arr.reshape(()) if arr.size == 1 else arr
            continue
        module, name = key.rsplit(".", 1)
        path = _flax_module(module)
        if name == "weight" and arr.ndim > 1:
            collection, leaf = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            leaf = _BN_TO_FLAX[name]
            collection = "batch_stats" if leaf in ("mean", "var") else "params"
        node = out[collection]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Read a checkpoint in the reference's layout: a bare ``state_dict`` or a
    training checkpoint with ``meta``/``state_dict``. Returns
    ``(state_dict, meta_or_None)``; BatchNorm's ``num_batches_tracked`` (no
    use in a frozen BN) is dropped so the dict loads strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    meta = None
    sd = ckpt
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        meta = ckpt.get("meta")
        sd = ckpt["state_dict"]
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return sd, meta
