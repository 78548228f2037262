"""Basic retrieval entry point: extract, score, evaluate.

Port of ``image_search_engine_for_historical_research_tpu/cli/retrieve.py``:
``--mode revisited`` (default) runs ``cli.benchmark`` and ``--mode custom``
runs ``cli.test_custom``, each with the remaining arguments.

Usage:
  python -m image_search_engine_for_historical_research_tpu_torch.cli.retrieve \
      --mode custom --db-dir data/db --query-dir data/q [--device cuda]
"""

from __future__ import annotations

import argparse

from .benchmark import main as benchmark_main
from .test_custom import main as custom_main


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["revisited", "custom"], default="revisited")
    return p


def main(argv=None):
    args, rest = build_parser().parse_known_args(list(argv or []))
    if args.mode == "custom":
        return custom_main(rest)
    return benchmark_main(rest)


if __name__ == "__main__":
    raise SystemExit(main())
