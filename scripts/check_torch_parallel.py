#!/usr/bin/env python3
"""The PyTorch port's sharded builds and batch-sharded steps across several
processes, each against the unsharded one on its own device.

    torchrun --standalone --nproc-per-node 4 scripts/check_torch_parallel.py
    torchrun --standalone --nproc-per-node 4 scripts/check_torch_parallel.py \\
        --device cpu --rows 4096 --fit-rows 2048 --diffusion-rows 1024 --dim 64 \\
        --small-steps

Every rank joins the launcher's group through ``parallel.data_mesh`` (NCCL on
``cuda``, one card a rank; gloo on ``cpu``), makes the same clustered unit
rows from one seed (checked equal across ranks), and runs each build twice:
unsharded on its own device, then with ``mesh=``. Checked:

- every rank returns the same sharded result (digests all-gathered);
- ``sharded_exact_topk`` of 70 rows' queries over ``--rows`` bf16 rows
  against ``exact_topk``: the same scores rank by rank within 1e-5, ids
  equal but where scores tie within that;
- ``build_hnsw_device`` (m=16, k_candidates=64) on ``--rows`` rows: the
  recall@10 of the beam kernel's search (its plain version on the CPU)
  against the exact top-10 within 0.01 of the unsharded graph's, and the
  share of ``nbr0`` rows equal;
- ``kmeans_fit_sharded`` (k=256) and ``build_pq`` (M=16, Ks=256) on
  ``--fit-rows`` rows: the mean squared quantization error within 1% of
  the unsharded fit's (the sums are reduced in another order, so boundary
  rows may change centre); ``build_ivfpq`` (nlist=316): the top-1 of 70 of
  its own rows equal;
- ``build_diffusion_offline`` (n_trunc=2000, kd=50, tables solver) on
  ``--diffusion-rows`` rows: support rows equal on at least 99% of the
  rows, scores within 1e-4 on those;
- ``build_rpforest`` (100 trees, leaf 512) on ``--fit-rows`` rows: every
  array identical (each tree is built whole on one rank).

Then the batch-sharded steps (``STEPS``; ``--small-steps`` shrinks them
for a rehearsal on the CPU), each from seeded inputs made on the device:

- ``make_sharded_extract_fn``: 64 canvases of 512 px through
  ResNet101-SOLAR (seeded weights) at the three default scales, within
  1e-4 of ``make_extract_fn`` (cuDNN may pick other algorithms at another
  batch size);
- ``make_sharded_sift_fn``: 32 smooth 1000 x 1000 images (1,024
  keypoints, 4 octaves) against ``sift_program`` at ``chip_smoke.py``'s
  card-against-CPU limits (``sift_agreement``: at least 99% of the
  keypoints within 1e-2 px with descriptors within 1e-3);
- ``make_train_step(mesh=)``: ResNet101-SOLAR unfrozen, contrastive +
  0.1 SOS, 8 tuples of S=4 at 362 px: the loss within rtol 1e-5 of the
  unsharded step's; every gradient leaf within ``1e-4 * max|g|`` (JAX's
  limit, ``tests/test_parallel.py``) of the same split run on one device
  (each rank's block forwarded alone, one backward), and no farther from
  the unsharded step's than that split is, plus the same limit (cuDNN
  rounds another batch size otherwise, and random weights amplify it);
  the parameters after one AdamW step the same on every rank;
- ``make_loftr_train_step(mesh=)``: the default config at 480 x 640, 4
  pairs: the loss within rel 1e-4.

Each step is timed sharded and unsharded (host clock around synchronized
calls, the median of 3 after a warm-up).

Rank 0 prints each build's seconds unsharded and sharded (host clock around
synchronized builds, each run once after one warm-up build of the kNN
graph), the checks, and last one JSON object with them, the world size and
the card's name and power limit. Exits non-zero if a check fails.
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
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_search_engine_for_historical_research_tpu_torch.index import (  # noqa: E402
    build_hnsw_device,
    build_ivfpq,
    build_pq,
    build_rpforest,
)
from image_search_engine_for_historical_research_tpu_torch.ops.kmeans import (  # noqa: E402
    kmeans_fit,
    kmeans_fit_sharded,
)
from image_search_engine_for_historical_research_tpu_torch.ops.topk import (  # noqa: E402
    exact_topk,
)
from image_search_engine_for_historical_research_tpu_torch.parallel import (  # noqa: E402
    data_mesh,
    sharded_exact_topk,
)
from image_search_engine_for_historical_research_tpu_torch.parallel.mesh import (  # noqa: E402
    rank_device,
)
from image_search_engine_for_historical_research_tpu_torch.rerank import (  # noqa: E402
    build_diffusion_offline,
)

Q = 70
# the step checks' sizes; ``--small-steps`` for a rehearsal on the CPU
STEPS = {"arch": "resnet101", "extract_images": 64, "extract_px": 512, "sift_images": 32,
         "sift_px": 1000, "sift_kpts": 1024, "sift_octaves": 4, "tuples": 8, "train_px": 362,
         "loftr_pairs": 4, "loftr_hw": (480, 640), "loftr_config": {}}
SMALL_STEPS = {"arch": "resnet50", "extract_images": 8, "extract_px": 64, "sift_images": 8,
               "sift_px": 128, "sift_kpts": 128, "sift_octaves": 3, "tuples": 4, "train_px": 64,
               "loftr_pairs": 4, "loftr_hw": (32, 48),
               "loftr_config": dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32,
                                    d_fine=16, nhead=4, coarse_layers=("self", "cross"))}


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def clustered_rows(n, d, dev, seed=7, n_centers=8192, d_eff=64, spread=0.1):
    """(n, d) bf16 unit rows near a d_eff-dimensional subspace, made on
    ``dev`` from ``seed`` (``chip_smoke.clustered_rows``' recipe)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(n_centers, d_eff, generator=g, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)
    u = torch.randn(d_eff, d, generator=g, device=dev) / d ** 0.5
    a = torch.randint(0, n_centers, (n,), generator=g, device=dev)
    z = (centers[a] + spread * torch.randn(n, d_eff, generator=g, device=dev)) @ u
    return (z / z.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def same_ranks(s_ref, i_ref, s, i, tie=1e-5):
    """Scores equal rank by rank within ``tie`` and ids equal but where
    the reference's scores tie within ``tie`` at that rank."""
    if not torch.allclose(s, s_ref, rtol=0, atol=tie):
        return False
    diff = i != i_ref
    near = torch.zeros_like(diff)
    near[:, 1:] |= (s_ref[:, 1:] - s_ref[:, :-1]).abs() <= tie
    near[:, :-1] |= (s_ref[:, :-1] - s_ref[:, 1:]).abs() <= tie
    near[:, -1] = True
    return bool((~diff | near).all())


def qerr(x, centers, assign):
    return float(((x - centers[assign]) ** 2).sum(1).mean())


def digest(t):
    t = t.detach().double().cpu() if torch.is_tensor(t) else torch.as_tensor(t).double()
    return [float(t.sum()), float(t.abs().sum()), float(t.flatten()[:: max(1, t.numel() // 97)]
                                                        .sum())]


def step_seconds(fn, dev, reps=3):
    """Median host seconds of ``fn`` over ``reps`` synchronized calls after
    a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def smooth_images(n, h, w, dev, seed, channels=None):
    """``n`` seeded smooth images in [0, 1] made on ``dev``: uniform noise
    on a 1/8 grid, upsampled bilinearly (``(n, h, w)``, or ``(n, h, w, c)``
    with ``channels``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.rand((n, channels or 1, h // 8, w // 8), generator=g, device=dev)
    x = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous() if channels else x[:, 0].contiguous()


def run_steps(steps, mesh, dev, out, checks, digests):
    """The batch-sharded steps: each against the unsharded function on this
    rank's device, timed both ways."""
    from chip_smoke import sift_agreement

    from image_search_engine_for_historical_research_tpu_torch.models import (
        init_network,
        loftr,
        make_extract_fn,
        make_sharded_extract_fn,
    )
    from image_search_engine_for_historical_research_tpu_torch.ops import sift
    from image_search_engine_for_historical_research_tpu_torch.train import (
        init_loftr_train_state,
        init_train_state,
        make_grad_fn,
        make_loftr_optimizer,
        make_loftr_train_step,
        make_optimizer,
        make_train_step,
        random_homography,
    )
    from image_search_engine_for_historical_research_tpu_torch.train.step import tuple_loss

    def pair(label, plain, sharded):
        """Both results, and each one's seconds a call."""
        res = plain(), sharded()
        out[f"{label}_unsharded_s"] = step_seconds(plain, dev)
        out[f"{label}_sharded_s"] = step_seconds(sharded, dev)
        return res

    net = init_network({"architecture": steps["arch"]}, seed=0, device=dev)
    px = steps["extract_px"]
    canvases = smooth_images(steps["extract_images"], px, px, dev, 11, channels=3)
    mask = torch.ones(canvases.shape[:3], dtype=torch.bool, device=dev)
    v0, v1 = pair("extract", lambda: make_extract_fn(net.module)(canvases, mask),
                  lambda: make_sharded_extract_fn(net.module, mesh)(canvases, mask))
    out["extract_max_abs_diff"] = float((v0 - v1).abs().max())
    checks["extract_within_1e-4"] = out["extract_max_abs_diff"] <= 1e-4
    digests["extract"] = digest(v1)
    del canvases, mask, v0, v1

    imgs = smooth_images(steps["sift_images"], steps["sift_px"], steps["sift_px"], dev, 12)
    budgets = sift.default_budgets(steps["sift_kpts"], steps["sift_octaves"])
    f0, f1 = pair("sift", lambda: sift.sift_program(imgs, steps["sift_octaves"], budgets),
                  lambda: sift.make_sharded_sift_fn(mesh, tuple(imgs.shape[1:]),
                                                    max_kpts=steps["sift_kpts"],
                                                    n_octaves=steps["sift_octaves"])(imgs))
    agree = sift_agreement({k: v.cpu().numpy() for k, v in f1.items()},
                           {k: v.cpu().numpy() for k, v in f0.items()})
    out["sift_agreement"] = agree
    out["sift_fields_identical"] = sorted(k for k in f0 if torch.equal(f0[k], f1[k]))
    checks["sift_99pct_within_1e-2px"] = agree["matched_share"] >= 0.99
    digests["sift"] = digest(f1["xy"])
    del imgs, f0, f1

    module = net.module.requires_grad_(True)
    S, tuples, px = 4, steps["tuples"], steps["train_px"]
    # normal noise, as chip_smoke.py's train batches and JAX's parity test:
    # smooth images give nearly parallel descriptors, whose loss gradient is
    # a difference of nearly equal terms
    g = torch.Generator(device=dev).manual_seed(13)
    images = torch.randn((S * tuples, px, px, 3), generator=g, device=dev)
    labels = torch.tensor([-1, 1] + [0] * (S - 2), dtype=torch.int32,
                          device=dev).repeat(tuples)
    world = mesh.size(0)
    loss_of = tuple_loss(S, lambda_sos=0.1)

    def blockwise():
        """The sharded split on this one device: each rank's block of images
        forwarded alone (the same batch size, so the same cuDNN algorithms,
        as on its card), one loss and one backward over all of them."""
        n = images.shape[0] // world
        value = loss_of(torch.cat([module(images[r * n:(r + 1) * n]) for r in range(world)]),
                        labels)
        value.backward()
        return value.detach()

    grads = {}
    for label, fn in (("unsharded", make_grad_fn(module, S, lambda_sos=0.1)),
                      ("blockwise", lambda x, y: blockwise()),
                      ("sharded", make_grad_fn(module, S, lambda_sos=0.1, mesh=mesh))):
        module.zero_grad(set_to_none=True)
        loss = fn(images, labels)
        grads[label] = (float(loss), {n: p.grad.clone() for n, p in module.named_parameters()})

    def grad_step(m):
        module.zero_grad(set_to_none=True)
        make_grad_fn(module, S, lambda_sos=0.1, mesh=m)(images, labels)

    out["solar_grad_unsharded_s"] = step_seconds(lambda: grad_step(None), dev)
    out["solar_grad_sharded_s"] = step_seconds(lambda: grad_step(mesh), dev)
    module.zero_grad(set_to_none=True)
    (l0, g0), (_, gb), (l1, g1) = (grads[k] for k in ("unsharded", "blockwise", "sharded"))

    def gap(a, b, n):
        return float((a[n] - b[n]).abs().max())

    def limit(n):
        return max(1e-4 * float(g0[n].abs().max()), 1e-7)

    out["solar_loss"] = [l0, l1]
    for label, ref in (("unsharded", g0), ("blockwise", gb)):
        out[f"solar_worst_leaf_vs_{label}_share_of_limit"] = max(
            gap(g1, ref, n) / limit(n) for n in g0)
    out["solar_blockwise_vs_unsharded_share_of_limit"] = max(gap(gb, g0, n) / limit(n)
                                                             for n in g0)
    checks["solar_loss_rtol_1e-5"] = abs(l1 - l0) <= 1e-5 * abs(l0)
    # the sharding's own arithmetic: against the same split on one device
    checks["solar_grads_within_1e-4_max_of_blockwise"] = (
        out["solar_worst_leaf_vs_blockwise_share_of_limit"] <= 1.0)
    # against the unsharded step: no farther than the split on one device
    # is (cuDNN's batch-size-dependent rounding), plus JAX's limit
    checks["solar_grads_within_split_gap_plus_1e-4_max_of_unsharded"] = all(
        gap(g1, g0, n) <= gap(gb, g0, n) + limit(n) for n in g0)
    opt, sched, _ = make_optimizer(module, lr=1e-6, weight_decay=1e-6, exp_decay=0.0,
                                   freeze_backbone=False)
    make_train_step(module, S, lambda_sos=0.1, mesh=mesh)(init_train_state(module, opt, sched),
                                                           images, labels)
    digests["solar_params_after_step"] = digest(torch.cat([p.detach().reshape(-1)
                                                           for p in module.parameters()]))
    del net, module, grads, g0, gb, g1, images, opt, sched

    h, w = steps["loftr_hw"]
    n = steps["loftr_pairs"]
    limgs = smooth_images(n, h, w, dev, 14, channels=1)
    rng = np.random.default_rng(0)
    Hs = torch.as_tensor(np.stack([random_homography(rng, h, w, jitter=0.1)
                                   for _ in range(n)]), device=dev)
    states, losses = {}, {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        matcher = loftr.init_matcher(seed=0, device=dev, **steps["loftr_config"])
        states[label] = init_loftr_train_state(matcher, *make_loftr_optimizer(matcher))
        losses[label] = float(make_loftr_train_step(mesh=m)(states[label], limgs, Hs)[1])
    out["loftr_loss"] = [losses["unsharded"], losses["sharded"]]
    checks["loftr_loss_rel_1e-4"] = (abs(losses["sharded"] - losses["unsharded"])
                                     <= 1e-4 * abs(losses["unsharded"]))
    out["loftr_unsharded_s"] = step_seconds(
        lambda: make_loftr_train_step()(states["unsharded"], limgs, Hs), dev)
    out["loftr_sharded_s"] = step_seconds(
        lambda: make_loftr_train_step(mesh=mesh)(states["sharded"], limgs, Hs), dev)
    digests["loftr_params_after_steps"] = digest(torch.cat(
        [p.detach().reshape(-1) for p in states["sharded"].module.parameters()]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=262_144)
    p.add_argument("--fit-rows", type=int, default=65_536)
    p.add_argument("--diffusion-rows", type=int, default=16_384)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--small-steps", action="store_true",
                   help="the step checks at the sizes of a CPU rehearsal")
    args = p.parse_args(argv)

    mesh = data_mesh(device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = rank_device(mesh.device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"world": world, "device": args.device, "rows": args.rows,
           "fit_rows": args.fit_rows, "diffusion_rows": args.diffusion_rows, "dim": args.dim}
    checks, digests = {}, {}
    try:
        x = clustered_rows(args.rows, args.dim, dev)
        d = torch.tensor(digest(x), device=dev)
        lo, hi = d.clone(), d.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        checks["same_rows_on_every_rank"] = bool(torch.equal(lo, hi))

        def both(label, build):
            res = []
            for m in (None, mesh):
                sync(dev)
                t0 = time.perf_counter()
                res.append(build(m))
                sync(dev)
                out[f"{label}_{'sharded' if m is not None else 'unsharded'}_s"] = (
                    time.perf_counter() - t0)
            return res

        q = x[:: args.rows // Q][:Q].float()
        (s0, i0), (s1, i1) = both("topk", lambda m: exact_topk(
            q, x, 100, matmul_dtype=torch.bfloat16) if m is None else sharded_exact_topk(
            q, x, 100, m, matmul_dtype=torch.bfloat16))
        checks["topk_same_ranks"] = same_ranks(s0, i0, s1, i1)
        digests["topk"] = digest(i1)

        build_hnsw_device(x[:4096], m=16, k_candidates=64, normalize=False, device=dev)
        ix0, ix1 = both("hnsw", lambda m: build_hnsw_device(
            x, m=16, k_candidates=64, normalize=False, device=dev, mesh=m))
        exact = i0[:, :10].tolist()

        def recall(ix):
            got = ix.search(q, 10, ef=100)[1].tolist()
            return float(np.mean([len(set(e) & set(g)) / 10 for e, g in zip(exact, got)]))

        out["hnsw_recall10"] = [recall(ix0), recall(ix1)]
        out["hnsw_nbr0_rows_equal"] = float((ix0.nbr0 == ix1.nbr0).all(1).float().mean())
        checks["hnsw_recall_within_0.01"] = abs(out["hnsw_recall10"][1]
                                                - out["hnsw_recall10"][0]) <= 0.01
        digests["hnsw"] = digest(ix1.nbr0)
        del ix0, ix1

        f = x[:args.fit_rows].float()
        (c0, a0), (c1, a1) = both("kmeans", lambda m: kmeans_fit(f, 256, seed=0) if m is None
                                  else kmeans_fit_sharded(f, 256, m, seed=0))
        out["kmeans_qerr"] = [qerr(f, c0, a0), qerr(f, c1, a1)]
        out["kmeans_assign_agree"] = float((a0 == a1).float().mean())
        checks["kmeans_qerr_within_1pct"] = out["kmeans_qerr"][1] <= 1.01 * out["kmeans_qerr"][0]
        digests["kmeans"] = digest(c1)

        pq0, pq1 = both("pq", lambda m: build_pq(f, M=16, Ks=256, device=dev, mesh=m))

        def pq_err(ix):
            from image_search_engine_for_historical_research_tpu_torch.ops.pq import (
                pq_decode,
            )
            fn = f / f.norm(dim=1, keepdim=True)
            return float(((fn - pq_decode(ix.codebook, ix.codes)) ** 2).sum(1).mean())

        out["pq_qerr"] = [pq_err(pq0), pq_err(pq1)]
        out["pq_codes_agree"] = float((pq0.codes.long() == pq1.codes.long()).float().mean())
        checks["pq_qerr_within_1pct"] = out["pq_qerr"][1] <= 1.01 * out["pq_qerr"][0]
        digests["pq"] = digest(pq1.codewords)
        del pq0, pq1

        iv0, iv1 = both("ivfpq", lambda m: build_ivfpq(f, nlist=316, M=16, Ks=256, nprobe=64,
                                                       device=dev, mesh=m))
        top0, top1 = (ix.search(f[:Q], 5)[1][:, 0] for ix in (iv0, iv1))
        checks["ivfpq_top1_equal"] = bool(torch.equal(top0, top1))
        digests["ivfpq"] = digest(iv1.coarse_centers)
        del iv0, iv1

        dx = x[:args.diffusion_rows]
        off0, off1 = both("diffusion", lambda m: build_diffusion_offline(
            dx, n_trunc=2000, kd=50, solver="tables", mesh=m))
        rows_eq = (off0.trunc_ids == off1.trunc_ids).all(1)
        out["diffusion_rows_equal"] = float(rows_eq.float().mean())
        out["diffusion_max_abs_diff"] = float((off0.scores[rows_eq] - off1.scores[rows_eq])
                                              .abs().max())
        checks["diffusion_rows_99pct_scores_1e-4"] = (out["diffusion_rows_equal"] >= 0.99
                                                      and out["diffusion_max_abs_diff"] <= 1e-4)
        digests["diffusion"] = digest(off1.scores)
        del off0, off1

        fo0, fo1 = both("rpforest", lambda m: build_rpforest(f, n_trees=100, leaf_size=512,
                                                             device=dev, mesh=m))
        a0, a1 = fo0.to_arrays()[1], fo1.to_arrays()[1]
        checks["rpforest_identical"] = all(np.array_equal(a0[k], a1[k]) for k in a0)
        digests["rpforest"] = digest(fo1.leaf_items)
        del x, f, fo0, fo1

        run_steps(SMALL_STEPS if args.small_steps else STEPS, mesh, dev, out, checks, digests)

        every = [None] * world
        dist.all_gather_object(every, digests)
        checks["every_rank_same_sharded_result"] = all(e == every[0] for e in every)
        oks = [None] * world
        dist.all_gather_object(oks, checks)
        out["checks_every_rank"] = {k: all(o[k] for o in oks) for k in checks}
    finally:
        dist.destroy_process_group()
    out["ok"] = all(out["checks_every_rank"].values())
    if rank == 0:
        out["card"] = card_line() if args.device == "cuda" else "cpu"
        print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
