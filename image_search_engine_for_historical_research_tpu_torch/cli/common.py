"""Shared CLI plumbing: network loading, common flags, scale parsing,
matcher dispatch.

Port of ``image_search_engine_for_historical_research_tpu/cli/common.py``
(:20-92), plus ``--device``, and of ``cli/offline.py``'s matcher keyword
rule (:77-91), which every CLI here shares (``matcher_kwargs``).
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
                        help="L2 (exact) | L2_int8 | fractional | LSH | ANNOY | HNSW | "
                             "PQ | Nano_PQ | PQ_HNSW | HNSW_NanoPQ | IVFPQ | Greedyhash")
    parser.add_argument("--opq", nargs="?", const=True, default=False,
                        choices=[True, False, "refine"],
                        help="learned orthogonal pre-rotation for PQ-family "
                             "indexes (OPQ, Ge et al. CVPR'13); '--opq' "
                             "rotates all code levels, '--opq refine' rotates "
                             "only the residual level (PQ_HNSW: keeps coarse-"
                             "code dedup)")
    parser.add_argument("--refine-m", type=int, default=None, metavar="BYTES",
                        help="second-level refinement codes per vector for "
                             "PQ_HNSW / IVFPQ (IVFADC+R): enables the "
                             "codes-only adc+refine re-rank; default = "
                             "backend default (PQ_HNSW 32, IVFPQ 0)")
    parser.add_argument("--ifgenerate", action="store_true",
                        help="(re)build index artifacts instead of loading")
    parser.add_argument("--outputs", default="outputs")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def parse_scales(expr: str) -> Sequence[float]:
    return tuple(float(s) for s in eval(expr, {"__builtins__": {}}))  # noqa: S307


def check_matcher(method: str) -> None:
    """Exit at start-up on a matching method that is unknown."""
    from ..index.matchers import MATCHERS

    if method not in MATCHERS:
        raise SystemExit(f"unknown matching method {method!r}; have {sorted(MATCHERS)}")


def add_loader_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--loader", default="pil", choices=["pil", "native"],
                        help="image decoding: pil; native (the threaded libjpeg loader) "
                             "is not ported yet and exits")


def check_loader(loader: str) -> None:
    """Exit at start-up on ``--loader native``, which is not ported yet."""
    if loader != "pil":
        raise SystemExit(f"--loader {loader} is not ported yet: see ROADMAP section 1, "
                         "item 2 (the native JPEG loader). The port decodes with --loader pil.")


def dispatch_matcher(method: str, *args, **kwargs):
    """Run matcher ``method`` (``index.matchers.MATCHERS``)."""
    from ..index.matchers import MATCHERS

    check_matcher(method)
    return MATCHERS[method](*args, **kwargs)


def matcher_kwargs(args, dataset: str) -> dict:
    """The matcher's keyword arguments from the CLI flags (JAX
    ``cli/offline.py:77-92``): the device; for an index with an artifact
    its name, ``--ifgenerate`` and ``--outputs``; for the PQ family
    ``--opq``, and ``--refine-m`` when it is given."""
    from ..index.matchers import PQ_METHODS

    if args.matching_method in ("L2", "L2_int8", "fractional", "LSH", "Greedyhash"):
        return {"device": args.device}
    kw = {"dataset": dataset, "ifgenerate": args.ifgenerate, "outputs": args.outputs,
          "device": args.device}
    if args.matching_method in PQ_METHODS:
        kw["opq"] = args.opq
        if args.refine_m is not None:
            kw["refine_M"] = args.refine_m
    return kw
