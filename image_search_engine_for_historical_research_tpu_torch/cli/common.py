"""Shared CLI plumbing: network loading, common flags, scale parsing.

Port of ``image_search_engine_for_historical_research_tpu/cli/common.py``
(:20-82) for the flags the ported path uses, plus ``--device``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..models import init_network, load_torch_checkpoint


def load_network(
    network_path: Optional[str] = None,
    architecture: str = "resnet101",
    params: Optional[dict] = None,
    device="cuda",
):
    """Build the retrieval model on ``device``; when ``network_path`` exists,
    rebuild it from the checkpoint's meta and load its ``state_dict``
    strictly. Without a checkpoint the weights are random (seed 0)."""
    meta_params = {"architecture": architecture}
    meta_params.update(params or {})
    if network_path and os.path.exists(network_path):
        sd, meta = load_torch_checkpoint(network_path)
        if meta:
            meta_params.update(
                {
                    "architecture": meta.get("architecture", architecture),
                    "pooling": meta.get("pooling", "gem"),
                    "whitening": bool(meta.get("whitening", True)),
                    "local_whitening": bool(meta.get("local_whitening", False)),
                    "soa": bool(meta.get("soa", True)),
                    "soa_layers": meta.get("soa_layers", "45"),
                }
            )
        model = init_network(meta_params, device=device)
        model.module.load_state_dict(sd, strict=True)
        return model
    return init_network(meta_params, device=device)


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--network-path", default=None,
                        help="torch checkpoint (.pth) in the SOLAR layout")
    parser.add_argument("--arch", default="resnet101")
    parser.add_argument("--image-size", type=int, default=1024)
    parser.add_argument("--multiscale", default="[1, 2**(1/2), 1/2**(1/2)]",
                        help="python list of scales (reference flag format)")
    parser.add_argument("--matching-method", default="L2",
                        help="HNSW (ported); L2 | PQ | ANNOY | PQ_HNSW | IVFPQ "
                             "are not ported yet")
    parser.add_argument("--outputs", default="outputs")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def parse_scales(expr: str) -> Sequence[float]:
    return tuple(float(s) for s in eval(expr, {"__builtins__": {}}))  # noqa: S307
