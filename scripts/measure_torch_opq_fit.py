#!/usr/bin/env python3
"""Split one refine OPQ fit of the PyTorch port into its parts, on the card.

    python3 scripts/measure_torch_opq_fit.py [--rows 4112] [--reps 2]

Fits ``ops.pq.opq_train(residuals, M=32, Ks=256, iters=20, opq_iters=10)``,
the refine fit that ``build_hnsw_pq(opq="refine")`` runs, over the
residuals of ``--rows`` x 2048 unit rows (64 centres plus 0.6 noise, the
served gallery's synthetic recipe in ``chip_smoke.py``) after a coarse
``pq_train(M=16, Ks=4096)`` (the ``HNSW_NanoPQ`` matcher's codebook at 4,112
rows). It prints the fit's seconds (a one-round warm-up fit, then ``--reps``
timed ones) and
a split of one more fit: each part's functions are wrapped so that the card
is synchronized before and after every call, and their host-clock seconds
summed:

- ``host_draws``: the generators' draws (``ops.kmeans._init_draws`` and
  ``_gumbel``, made once for all of OPQ's fits);
- ``kmeanspp_steps``: the k-means++ loop less its noise draws;
- ``lloyd``: the Lloyd iterations and the final assignment;
- ``encode_decode``: ``pq_encode`` and ``pq_decode`` inside the OPQ rounds;
- ``svd``: the Procrustes ``torch.linalg.svd``;
- ``other``: the rest of the split fit's seconds.

The last line is one JSON object with the numbers and the card's name and power limit;
``measure`` returns it (``chip_smoke.py`` calls it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def residual_rows(n, dev, pq):
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((64, 2048))
    x = centers[rng.integers(0, 64, n)] + 0.6 * rng.standard_normal((n, 2048))
    x = torch.as_tensor(x / np.linalg.norm(x, axis=1, keepdims=True), dtype=torch.float32,
                        device=dev)
    cb = pq.pq_train(x, M=16, Ks=4096)
    return x - pq.pq_decode(cb, pq.pq_encode(cb, x))


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class Split:
    """Wraps module functions so each call is timed between two syncs."""

    def __init__(self):
        self.s = {}
        self.undo = []

    def wrap(self, mod, name, part):
        fn = getattr(mod, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.s[part] = self.s.get(part, 0.0) + time.perf_counter() - t0
            return out

        setattr(mod, name, timed)
        self.undo.append((mod, name, fn))

    def restore(self):
        for mod, name, fn in reversed(self.undo):
            setattr(mod, name, fn)


def measure(rows=4112, reps=2):
    """The record the script prints, for the port already on ``sys.path``."""
    from image_search_engine_for_historical_research_tpu_torch.ops import kmeans as km
    from image_search_engine_for_historical_research_tpu_torch.ops import pq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    M, Ks, iters, opq_iters, seed = 32, 256, 20, 10, 43
    r = residual_rows(rows, dev, pq)

    def fit():
        return pq.opq_train(r, M=M, Ks=Ks, iters=iters, opq_iters=opq_iters, seed=seed)

    warm = synced_seconds(lambda: pq.opq_train(r, M=M, Ks=Ks, iters=iters, opq_iters=1,
                                               seed=seed))
    fits = [synced_seconds(fit) for _ in range(reps)]
    sp = Split()
    sp.wrap(km, "_init_draws", "host_draws")
    sp.wrap(km, "_gumbel", "gumbel")           # called inside _kmeanspp_init
    sp.wrap(km, "_kmeanspp_init", "kmeanspp")
    sp.wrap(km, "_lloyd", "lloyd")
    sp.wrap(pq, "pq_encode", "encode_decode")
    sp.wrap(pq, "pq_decode", "encode_decode")
    sp.wrap(torch.linalg, "svd", "svd")
    calls = {"n": 0}
    train = pq.pq_train

    def counted(*a, **kw):
        calls["n"] += 1
        return train(*a, **kw)

    pq.pq_train = counted
    try:
        split_s = synced_seconds(fit)
    finally:
        pq.pq_train = train
        sp.restore()
    s = sp.s
    gumbel = s.get("gumbel", 0.0)
    parts = {"host_draws": s["host_draws"] + gumbel, "kmeanspp_steps": s["kmeanspp"] - gumbel,
             "lloyd": s["lloyd"], "encode_decode": s["encode_decode"], "svd": s["svd"]}
    parts["other"] = split_s - sum(parts.values())
    return {"rows": rows, "M": M, "Ks": Ks, "iters": iters,
            "opq_iters": opq_iters, "pq_train_calls": calls["n"], "warmup_s": warm,
            "fit_s": fits, "split_fit_s": split_s, "split_s": parts, "card": card_line()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4112)
    ap.add_argument("--reps", type=int, default=2, help="timed fits before the split one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(json.dumps(measure(args.rows, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
