#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic mix are looked up in ``BENCHMARK.json`` by name; the mix's driver
builds the port's system from the seed, warms it, measures for
``--seconds``, and checks what the timed path produced against the
configuration's plain reference. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
last lines of standard error give each compared number beside its limit.
Exits non-zero, printing no result, without enough CUDA devices or when a
JAX module was loaded.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness import core  # noqa: E402

T_PROCESS = core.process_start_time()
core.set_cache_env(ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    args = parse(argv)
    cell = core.find_cell(core.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = core.Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    outcome = core.load_part("drivers", cell.traffic["driver"]).run(ctx)
    bad = core.forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    metrics = core.read_metrics(cell.per_layer if args.trace else cell.end_to_end,
                                outcome.record)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    breakdown = None
    if args.trace:
        ts = ctx.trace_summary
        device["busy_s"], device["window_s"] = ts["busy_s"], ts["window_s"]
        breakdown = {"device_ops": ts["device_ops"], "idle_gaps": ts["idle_gaps"]}
        print(f"trace reduced in {ts['reduce_s']:.2f} s over {ts['n_device_events']} "
              f"device events", file=sys.stderr)
    print(f"card: {card_line()}; setup_s {ctx.setup_s:.3f}", file=sys.stderr)
    for line in core.check_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(core.judge(outcome), outcome, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
