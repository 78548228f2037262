#!/usr/bin/env python3
"""Seconds a train step at the batch one card gets when a step is split over
4 cards, and at the whole batch, on one GPU.

    python3 scripts/measure_torch_step_batches.py

The SOLAR gradient step (``train.make_grad_fn``: ResNet101-SOLAR with
seeded weights, unfrozen, contrastive + 0.1 SOS, tuples of S=4 at 362 px,
normal-noise images) on 8 and on 32 images, each with a ``torch.profiler``
trace (``chip_smoke.trace_op``: device events, busy ms, idle share, top
kernels); the LoFTR f32 step (``train.make_loftr_train_step``, the default
config at 480 x 640, seeded weights) on 1, 2 and 4 pairs, with
``cudnn.benchmark`` off and on, and a trace of the 1-pair step. Matmul TF32
is off and cuDNN keeps its default, as in ``scripts/check_torch_parallel.py``.
Each time is the median of 3 host-clock synchronized calls after a warm-up.
Prints one JSON object with the card's name and power limit.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from image_search_engine_for_historical_research_tpu_torch.models import (  # noqa: E402
    init_network,
    loftr,
)
from image_search_engine_for_historical_research_tpu_torch.train import (  # noqa: E402
    init_loftr_train_state,
    make_grad_fn,
    make_loftr_optimizer,
    make_loftr_train_step,
    random_homography,
)


def seconds(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        print("measure_torch_step_batches: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"card": cs.card_line()}

    net = init_network({"architecture": "resnet101"}, seed=0, device=dev)
    module = net.module.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(13)
    images = torch.randn((32, 362, 362, 3), generator=g, device=dev)
    labels = torch.tensor([-1, 1, 0, 0], dtype=torch.int32, device=dev).repeat(8)
    grad_fn = make_grad_fn(module, 4, lambda_sos=0.1)
    for n in (8, 32):
        def step(n=n):
            module.zero_grad(set_to_none=True)
            grad_fn(images[:n], labels[:n])

        res[f"solar_grad_{n}_images_s"] = seconds(step)
        res[f"solar_grad_{n}_images_trace"] = cs.trace_op(step)
    del net, module, images
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    imgs = torch.rand((4, 480, 640, 1), generator=torch.Generator(device=dev).manual_seed(14),
                      device=dev)
    Hs = torch.as_tensor(np.stack([random_homography(rng, 480, 640, jitter=0.1)
                                   for _ in range(4)]), device=dev)
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for n in (1, 2, 4):
            matcher = loftr.init_matcher(seed=0, device=dev)
            state = init_loftr_train_state(matcher, *make_loftr_optimizer(matcher))
            step = make_loftr_train_step()
            res[f"loftr_{n}_pairs_benchmark_{bench}_s"] = seconds(
                lambda: step(state, imgs[:n], Hs[:n]))  # noqa: B023
            if n == 1 and not bench:
                res["loftr_1_pair_trace"] = cs.trace_op(lambda: step(state, imgs[:1], Hs[:1]))
            del matcher, state
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
