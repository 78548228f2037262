#!/usr/bin/env python3
"""The JAX package's LoFTR and D2-Net at full width on the CPU: the witness
that ``chip_smoke.py``'s LoFTR and D2-Net phases are held against.

    JAX_PLATFORMS=cpu python3 scripts/loftr_jax_witness.py \\
        [--images DIR] [--out scripts/loftr_jax_reference.json]

It makes the SAHA phase's photographs again (``chip_smoke.make_revisitop``,
seed 7; ``--images`` reuses a directory of them) and the port's seeded
weights (``models.loftr.init_matcher(seed=0)``, ``models.d2net.init_d2net(
seed=0)``, drawn on the host), and records the digests of both, so that a
card run on other photographs or weights fails its check instead of
comparing. Then the JAX package, with those weights read by its own
converters:

- LoFTR (the default ``LoFTRConfig``, 480 x 640, the images read as
  ``loftr_rerank`` reads them) over ``chip_smoke.loftr_witness_pairs()``
  (4 queries x (7 own views + 8 views of other scenes)): the batched
  counter's counts at thr 0.2 and 0.0, 4 pairs a batch, and the row maxima
  of the confidence matrix of pair 0 (an own view) and pair 7 (another
  scene's view);
- the port on the CPU over the same pairs at thr 0.0, for the record;
- D2-Net ``process_multiscale`` (scales 0.5, 1, 2) on the photographs
  ``chip_smoke.D2NET_HELD_NAMES`` at 384 x 512 (``chip_smoke.d2net_image``),
  kept as ``chip_smoke.d2net_summary``.

It writes ``--out``. The script imports both packages; the port and
``chip_smoke.py`` import no JAX.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", default=None,
                    help="a directory of make_revisitop's photographs (made anew if absent)")
    ap.add_argument("--out", default=os.path.join(ROOT, "scripts", "loftr_jax_reference.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from image_search_engine_for_historical_research_tpu.models import d2net as jd2
    from image_search_engine_for_historical_research_tpu.models import loftr as jl
    from image_search_engine_for_historical_research_tpu_torch.models import d2net as td2
    from image_search_engine_for_historical_research_tpu_torch.models import loftr as tl

    jpg = args.images
    if jpg is None:
        root = tempfile.mkdtemp(prefix="loftr_witness_")
        cs.make_revisitop(root)
        jpg = os.path.join(root, "revisitop1m", "jpg")
    pairs = cs.loftr_witness_pairs()
    names = sorted({n for p in pairs for n in p})
    host = tl.init_matcher(seed=cs.LOFTR_SEED, device="cpu")
    out = {"images_sha256": cs.images_digest(jpg, names),
           "decoded_sha256": cs.arrays_digest(cs.loftr_images(jpg, names)),
           "weights_sha256": cs.state_digest(host), "pairs": pairs, "counts": {}}
    q = cs.loftr_images(jpg, [p[0] for p in pairs])
    c = cs.loftr_images(jpg, [p[1] for p in pairs])
    t0 = time.perf_counter()
    for thr in (0.2, 0.0):
        cfg = jl.LoFTRConfig(thr=thr)
        module, variables = jl.LoFTRMatcher(cfg), jl.convert_loftr_state_dict(host.state_dict(),
                                                                               cfg)
        fn = jl.make_batched_count_fn(module, variables)
        out["counts"][str(thr)] = [int(x) for s in range(0, len(pairs), 4)
                                   for x in np.asarray(fn(jnp.asarray(q[s:s + 4]),
                                                          jnp.asarray(c[s:s + 4])))]
        print(f"JAX counts at thr {thr}: {out['counts'][str(thr)]}", flush=True)
    apply = jax.jit(lambda v, a, b: module.apply(v, a, b, mutable=["intermediates"]))
    out["row_max"] = {}
    for key, i in (("own", 0), ("other", 7)):
        _, inter = apply(variables, jnp.asarray(q[i]), jnp.asarray(c[i]))
        out["row_max"][key] = np.asarray(inter["intermediates"]["conf_matrix"][0]).max(1).tolist()
    out["loftr_s"] = time.perf_counter() - t0

    port = tl.init_matcher(seed=cs.LOFTR_SEED, device="cpu", thr=0.0)
    fn = tl.make_batched_count_fn(port)
    mine = [int(x) for s in range(0, len(pairs), 4) for x in fn(q[s:s + 4], c[s:s + 4])]
    want = np.asarray(out["counts"]["0.0"])
    out["port_cpu_vs_jax_thr0"] = {"port": mine, "differ": int((np.asarray(mine) != want).sum()),
                                   "max_gap": int(np.abs(np.asarray(mine) - want).max())}
    print(f"port CPU vs JAX at thr 0.0: {json.dumps(out['port_cpu_vs_jax_thr0'])}", flush=True)

    t0 = time.perf_counter()
    d2 = td2.init_d2net(seed=cs.LOFTR_SEED, device="cpu")
    dmod, dvars = jd2.DenseFeatureExtraction(True), jd2.convert_d2net_state_dict(d2.state_dict())
    held = list(cs.D2NET_HELD_NAMES)
    out["d2net"] = {"weights_sha256": cs.state_digest(d2), "held": held,
                    "images_sha256": cs.images_digest(jpg, held),
                    "hw": [cs.D2NET_HELD[1], cs.D2NET_HELD[0]], "pyramids": {}, "port_cpu": {}}
    for n in held:
        img = cs.d2net_image(os.path.join(jpg, n + ".jpg"))
        jpyr = jd2.process_multiscale(img, dmod, dvars)
        out["d2net"]["pyramids"][n] = cs.d2net_summary(*jpyr)
        with torch.inference_mode():
            out["d2net"]["port_cpu"][n] = cs.d2net_agreement(td2.process_multiscale(img, d2),
                                                             out["d2net"]["pyramids"][n])
        print(f"D2-Net {n}: {len(jpyr[0])} keypoints; port CPU vs JAX "
              f"{json.dumps(out['d2net']['port_cpu'][n])}", flush=True)
    out["d2net_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f, separators=(",", ":"))
    print(json.dumps({k: v for k, v in out.items() if k in ("loftr_s", "d2net_s", "counts",
                                                            "port_cpu_vs_jax_thr0")}))


if __name__ == "__main__":
    main()
