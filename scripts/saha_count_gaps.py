#!/usr/bin/env python3
"""Why the card's AdaLAM counts differ from the JAX package's on some
shortlisted pairs, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/saha_count_gaps.py [--images DIR] \\
        [--reference scripts/saha_jax_reference.json]

For the pairs that ``scripts/saha_jax_witness.py`` found to differ
(``card_vs_jax.pairs_that_differ`` of the reference), it extracts the
pairs' photographs with both packages' device SIFT in one batch, as the
re-ranks do, and each photograph alone, and prints each image's keypoint
counts; it crosses the two packages' AdaLAM with the two packages'
features (a gap that follows the features comes from SIFT); and for an
image whose keypoints differ alone it lists the DoG positions detected by
one package only, with the DoG value and its most extreme neighbour in
each package (a strict extremum test decides them).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def octave_dogs(mod, img, n_octaves=4):
    """Each octave's Gaussian stack (L, H, W) from one package's ``ops.sift``."""
    base = mod._blur(img, mod._gauss_kernel1d(math.sqrt(max(mod.SIGMA0 ** 2 - 0.25, 0.01))))
    out = []
    for _ in range(n_octaves):
        g = mod.gaussian_octave(base)
        out.append(g)
        base = g[:, mod.S, ::2, ::2]
    return out


def detection_gaps(path):
    """DoG positions one package detects and the other does not, alone."""
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from image_search_engine_for_historical_research_tpu.ops import sift as jsift
    from image_search_engine_for_historical_research_tpu_torch.ops import sift as tsift

    img = chip_smoke.sift_images([path])
    gaps = []
    pairs = zip(octave_dogs(jsift, jnp.asarray(img)), octave_dogs(tsift, torch.from_numpy(img)))
    for o, (gj, gt) in enumerate(pairs):
        sj = np.asarray(jsift.dog_keypoint_scores(gj)[0])[0]
        st = tsift.dog_keypoint_scores(gt)[0].numpy()[0]
        for lv, y, x in np.argwhere(np.isfinite(sj) != np.isfinite(st)):
            rec = {"octave": o, "level": int(lv), "y": int(y), "x": int(x)}
            for name, g in (("jax", np.asarray(gj)[0]), ("port", gt.numpy()[0])):
                dog = g[1:] - g[:-1]
                c = dog[1 + lv, y, x]
                nb = [dog[1 + lv + a, y + b, x + d] for a in (-1, 0, 1) for b in (-1, 0, 1)
                      for d in (-1, 0, 1) if (a, b, d) != (0, 0, 0)]
                extreme = min(nb) if c < 0 else max(nb)
                rec[name] = {"dog": float(c), "extreme_neighbour": float(extreme),
                             "strict": bool(c < extreme if c < 0 else c > extreme),
                             "detected": bool(np.isfinite(sj if name == "jax" else st)[lv, y, x])}
            gaps.append(rec)
    return gaps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", default=None,
                    help="a directory of make_revisitop's photographs (made anew if absent)")
    ap.add_argument("--reference", default=os.path.join(ROOT, "scripts",
                                                        "saha_jax_reference.json"))
    args = ap.parse_args()

    import chip_smoke
    from image_search_engine_for_historical_research_tpu.rerank import geometric as jgeo
    from image_search_engine_for_historical_research_tpu_torch.rerank import geometric as tgeo

    with open(args.reference) as f:
        ref = json.load(f)
    jpg = args.images
    if jpg is None:
        root = tempfile.mkdtemp(prefix="saha_gaps_")
        chip_smoke.make_revisitop(root)
        jpg = os.path.join(root, "revisitop1m", "jpg")
    pairs = [(d["query"], d["db"]) for d in ref["card_vs_jax"]["pairs_that_differ"]]
    names = sorted({n for p in pairs for n in p})
    paths = [os.path.join(jpg, n + ".jpg") for n in names]
    jf = dict(zip(names, jgeo.sift_extract_tpu(paths)))
    tf = dict(zip(names, tgeo.sift_extract_device(paths, device="cpu")))
    images = {}
    for n, p in zip(names, paths):
        alone = (jgeo.sift_extract_tpu([p])[0].count,
                 tgeo.sift_extract_device([p], device="cpu")[0].count)
        images[n] = {"batch_jax": jf[n].count, "batch_port": tf[n].count,
                     "alone_jax": alone[0], "alone_port": alone[1]}
        if alone[0] != alone[1]:
            images[n]["detection_gaps"] = detection_gaps(p)
        print(n, json.dumps(images[n]), flush=True)

    def as_port(f):
        return tgeo.LocalFeatures(f.xy, f.scale, f.angle, f.desc, f.count, f.shape)

    def as_jax(f):
        return jgeo.LocalFeatures(f.xy, f.scale, f.angle, f.desc, f.count, f.shape)

    qs, cs = [q for q, _ in pairs], [c for _, c in pairs]
    cross = {
        "jax_adalam_jax_features": jgeo.adalam_count_pairs([jf[q] for q in qs],
                                                           [jf[c] for c in cs]).tolist(),
        "port_adalam_jax_features": tgeo.adalam_count_pairs(
            [as_port(jf[q]) for q in qs], [as_port(jf[c]) for c in cs], device="cpu").tolist(),
        "port_adalam_port_features": tgeo.adalam_count_pairs(
            [tf[q] for q in qs], [tf[c] for c in cs], device="cpu").tolist(),
        "jax_adalam_port_features": jgeo.adalam_count_pairs(
            [as_jax(tf[q]) for q in qs], [as_jax(tf[c]) for c in cs]).tolist(),
    }
    print(json.dumps({"pairs": pairs, "cross": cross, "images": images}))


if __name__ == "__main__":
    main()
