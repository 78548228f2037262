"""Time the ``scan_topk`` kernel on the card beside its bound, its plain
version and the library pair it replaced (``torch.mm`` + ``torch.topk``).

Over 1,007,323 x 2048 f32 unit rows (the R1M gallery's size), at the
served shape (Q = 16, k = 10), the batch shape (Q = 70, k = 100), Q = 1 and
the kernel's largest tile (Q = 72, k = 128). ``ms`` is the median of CUDA
events around one call with the L2 flushed; ``device_ms`` queues a spin
kernel ahead of the first event, so the host's launch gaps are hidden.
``--mm`` also times ``torch.mm`` alone at Q = 64, 70, 72 and 128 (cuBLAS's
64-row query tiles). Prints one JSON line a shape, with the card's name and
power limit.

    python3 scripts/measure_torch_scan_topk.py [--mm]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from image_search_engine_for_historical_research_tpu_torch.ops import scan_topk as sk  # noqa: E402

N, D = 1_007_323, 2048
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
SLEEP_CYCLES = 2_000_000


def time_ms(fn, reps, flush, spin=False):
    """Median CUDA-event milliseconds of ``fn`` with the L2 flushed before
    each run; with ``spin`` behind a spin kernel (device time)."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(Q, k):
    """The larger of the FLOPs over the f32 peak and the bytes (gallery and
    queries in, the top-k out) over HBM's rate."""
    t_ops = 2 * Q * N * D / F32_FLOPS * 1e3
    t_bytes = (N * D * 4 + Q * D * 4 + Q * k * 12) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mm", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    if args.mm:
        for Q in (64, 70, 72, 128):
            q = torch.randn(Q, D, generator=g, device="cuda")
            ms = time_ms(lambda: torch.mm(q, x.T), args.reps, flush)
            print(json.dumps({"card": card, "op": "torch.mm", "Q": Q, "ms": ms,
                              "tflops": 2 * Q * N * D / ms / 1e9}), flush=True)
    for Q, k in ((1, 10), (16, 10), (70, 100), (sk.MAX_Q, sk.MAX_K)):
        q = torch.randn(Q, D, generator=g, device="cuda")
        q /= q.norm(dim=1, keepdim=True)
        s, i = sk.scan_topk(q, x, k)
        s_ref, i_ref = sk.scan_topk_reference(q, x, k)
        err = float((s - s_ref).abs().max())
        run = lambda: sk.scan_topk(q, x, k)  # noqa: E731
        ms = time_ms(run, args.reps, flush)
        device_ms = time_ms(run, args.reps, flush, spin=True)
        library_ms = time_ms(lambda: torch.topk(torch.mm(q, x.T), k, dim=1), args.reps, flush)
        plain_ms = time_ms(lambda: sk.scan_topk_reference(q, x, k), 3, flush)
        bnd, by = bound_ms(Q, k)
        print(json.dumps({"card": card, "op": "scan_topk", "Q": Q, "k": k, "N": N, "D": D,
                          "ms": ms, "device_ms": device_ms, "bound_ms": bnd, "bound_by": by,
                          "roofline_pct": 100 * bnd / device_ms, "library_ms": library_ms,
                          "plain_ms": plain_ms, "max_abs_err": err,
                          "ids_equal_share": float((i == i_ref).float().mean())}), flush=True)


if __name__ == "__main__":
    main()
