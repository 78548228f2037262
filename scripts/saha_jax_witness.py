#!/usr/bin/env python3
"""The JAX package's SAHA re-rank of the card's shortlist, on the CPU: the
second witness that ``chip_smoke.py``'s SAHA phase is held against.

    JAX_PLATFORMS=cpu python3 scripts/saha_jax_witness.py \\
        [--shortlist scripts/saha_shortlist.json] [--images DIR] \\
        [--out scripts/saha_jax_reference.json]

``chip_smoke.py``'s SAHA phase writes ``scripts/saha_shortlist.json`` in
the card's checkout (copy it here): the layout's names and gnd, the digest
of its photographs, the HNSW baseline's ranks, the port's AdaLAM counts of
each query's top-``b`` pairs and the mAPs. This script makes the same
photographs again (``chip_smoke.make_revisitop``, seed 7; ``--images``
reuses a directory of them) and checks their digest, then runs the JAX
package at the same full width: ``rerank.geometric.sift_extract_tpu`` (1000 x 1000, 1,024 keypoints,
4 octaves) over the queries and their shortlists, ``adalam_count_pairs``
(``DEFAULT_CONFIG``, ``pair_batch=8``, ``dispatch="scan"``) over the same
pairs, ``rerank_by_inliers`` and ``compute_map_revisited``. First it holds
the port's ``ops.sift.sift_program`` against the JAX package's on the
first ``PARITY_IMAGES`` queries' photographs, both on the CPU (valid masks
equal; the largest ``xy``, ``scale``, ``angle`` and ``desc`` gaps of the
valid keypoints).

It prints the card's counts against JAX's and writes ``--out``: the digest,
``b``, JAX's count of every shortlisted pair by name (and of the next
``EXTRA`` candidates, so that a shortlist moved by a tie at rank ``b``
still finds its pairs), JAX's mAPs and the comparison. ``chip_smoke.py``
checks each run's shortlist against it. The script imports both packages;
the port and ``chip_smoke.py`` import no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PARITY_IMAGES = 3   # query photographs of the port-vs-JAX sift_program check
EXTRA = 10          # candidates past rank b whose counts are also taken


def sift_parity(paths):
    """The port's ``sift_program`` against the JAX package's on the CPU."""
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from image_search_engine_for_historical_research_tpu.ops import sift as jsift
    from image_search_engine_for_historical_research_tpu_torch.ops import sift as tsift

    imgs = chip_smoke.sift_images(paths)
    budgets = jsift.default_budgets(1024, 4)
    j = {k: np.asarray(v) for k, v in jsift.sift_program(jnp.asarray(imgs), 4, budgets).items()}
    t = {k: v.numpy() for k, v in tsift.sift_program(torch.from_numpy(imgs), 4,
                                                     budgets).items()}
    v = j["valid"]
    rec = {"images": len(paths), "valid_equal": bool(np.array_equal(v, t["valid"])),
           "valid_per_image": v.sum(1).tolist()}
    if rec["valid_equal"]:
        wrap = np.abs((j["angle"] - t["angle"] + np.pi) % (2 * np.pi) - np.pi)
        rec.update({f"max_{k}_gap": float(np.abs(j[k] - t[k])[v].max())
                    for k in ("xy", "scale", "desc")})
        rec["max_angle_gap"] = float(wrap[v].max())
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shortlist", default=os.path.join(ROOT, "scripts", "saha_shortlist.json"))
    ap.add_argument("--images", default=None,
                    help="a directory of make_revisitop's photographs (made anew if absent)")
    ap.add_argument("--out", default=os.path.join(ROOT, "scripts", "saha_jax_reference.json"))
    args = ap.parse_args()

    import chip_smoke
    from image_search_engine_for_historical_research_tpu.evaluation import (
        compute_map_revisited,
    )
    from image_search_engine_for_historical_research_tpu.rerank import geometric

    with open(args.shortlist) as f:
        sl = json.load(f)
    b, qnames, dnames = sl["b"], sl["qimlist"], sl["imlist"]
    jpg = args.images
    if jpg is None:
        root = tempfile.mkdtemp(prefix="saha_witness_")
        chip_smoke.make_revisitop(root)
        jpg = os.path.join(root, "revisitop1m", "jpg")
    digest = chip_smoke.images_digest(jpg, qnames + dnames)
    if digest != sl["images_sha256"]:
        raise SystemExit(f"the photographs under {jpg} are not the card's ({digest})")
    out = {"images_sha256": digest, "b": b}
    out["sift_parity"] = sift_parity([os.path.join(jpg, n + ".jpg")
                                      for n in qnames[:PARITY_IMAGES]])
    print(f"port vs JAX sift_program (CPU, 1000 x 1000, 1,024 keypoints, 4 octaves): "
          f"{json.dumps(out['sift_parity'])}", flush=True)

    ranks = np.asarray(sl["ranks"])
    card = np.asarray(sl["counts"])
    w = min(b + EXTRA, ranks.shape[1])
    needed = list(dict.fromkeys(qnames + [dnames[int(j)] for row in ranks for j in row[:w]]))
    t0 = time.perf_counter()
    feats = dict(zip(needed, geometric.sift_extract_tpu([os.path.join(jpg, n + ".jpg")
                                                         for n in needed])))
    out["sift_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = geometric.adalam_count_pairs(
        [feats[q] for q in qnames for _ in range(w)],
        [feats[dnames[int(j)]] for row in ranks for j in row[:w]], pair_batch=8,
        dispatch="scan").reshape(len(qnames), w)
    out["adalam_s"] = time.perf_counter() - t0
    counts = wide[:, :b]
    gnd = [{k: np.asarray(g[k], np.int64) for k in g} for g in sl["gnd"]]
    for label, r in (("baseline", ranks), ("sift", geometric.rerank_by_inliers(ranks, counts, b))):
        m = compute_map_revisited(r, gnd)
        out[f"map_{label}"] = {"E": m.mapE, "M": m.mapM, "H": m.mapH}
    differ = np.argwhere(counts != card)
    out["card_vs_jax"] = {
        "pairs": int(card.size), "differ": len(differ),
        "max_gap": int(np.abs(counts - card).max()),
        "pairs_that_differ": [{"query": qnames[qi], "db": dnames[int(ranks[qi, j])],
                               "card": int(card[qi, j]), "jax": int(counts[qi, j])}
                              for qi, j in differ],
        "card_map": sl["map"]}
    out["counts"] = {q: {dnames[int(j)]: int(c) for j, c in zip(ranks[qi, :w], wide[qi])}
                     for qi, q in enumerate(qnames)}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    print(json.dumps({k: v for k, v in out.items() if k != "counts"}))


if __name__ == "__main__":
    main()
