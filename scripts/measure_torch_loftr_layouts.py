#!/usr/bin/env python3
"""Time the PyTorch port's LoFTR count block under two cuDNN settings that
the port does not use, on the card.

    python3 scripts/measure_torch_loftr_layouts.py [--reps 5]

One block of 4 pairs at 480 x 640 (smooth random textures, the default
``LoFTRConfig``, seeded random weights, TF32 off) through the count path
that ``cli.test_reranking --methods loftr`` runs (``fine=False``), timed
with CUDA events after a warm-up, the median of ``--reps`` runs:

- ``count_block_ms``: as the port runs it (NCHW, ``cudnn.benchmark`` off);
- ``count_block_ms_channels_last``: the matcher and the images in
  ``torch.channels_last``;
- ``count_block_ms_cudnn_benchmark``: NCHW with cuDNN's algorithm search.

The backbone's 3x3 convolutions are most of the block; the question is
whether another layout or cuDNN's own search changes the algorithm it
picks. The last line is one JSON object with the times and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def textures(n, seed, hw=(480, 640)):
    """``n`` smooth grayscale images (n, H, W, 1) in [0, 1]."""
    rng = np.random.default_rng(seed)
    small = torch.as_tensor(rng.uniform(0, 1, (n, 1, hw[0] // 8, hw[1] // 8)), dtype=torch.float32)
    big = torch.nn.functional.interpolate(small, size=hw, mode="bicubic", align_corners=False)
    return big.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def measure(reps=5):
    from image_search_engine_for_historical_research_tpu_torch.models import loftr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = loftr.init_matcher(seed=0, device="cuda")
    q, c = (textures(4, s).cuda() for s in (1, 2))
    out = {"card": card_line(), "pairs": 4, "hw": [480, 640], "reps": reps}
    with torch.inference_mode():
        def block(*x):
            return lambda: m(*x, fine=False)

        out["count_block_ms"] = time_ms(block(q, c), reps)
        m.to(memory_format=torch.channels_last)     # (B, H, W, 1) inputs already are
        out["count_block_ms_channels_last"] = time_ms(block(q, c), reps)
        m.to(memory_format=torch.contiguous_format)
        torch.backends.cudnn.benchmark = True
        try:
            out["count_block_ms_cudnn_benchmark"] = time_ms(block(q, c), reps)
        finally:
            torch.backends.cudnn.benchmark = False
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(json.dumps(measure(args.reps)))


if __name__ == "__main__":
    main()
