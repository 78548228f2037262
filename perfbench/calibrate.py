#!/usr/bin/env python3
"""Readings for the limits of ``correct``: run one cell on several seeds
in one process, each run followed by the control (the plain reference in
TF32 put in the program's place, on the same inputs), and print one JSON
line a seed with the program's numbers, the control's, and the run's
end-to-end metrics.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,13 --seconds 30 [--control]

The benchmark's own runs (``run.py``) never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness import core  # noqa: E402

core.set_cache_env(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    cell = core.find_cell(core.load_benchmark(ROOT), args.workload)
    driver = core.load_part("drivers", cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.Context(cell, seed, args.seconds, False, "cuda", time.time())
        torch.cuda.reset_peak_memory_stats()
        out = driver.run(ctx, control=args.control)
        line = {"workload": cell.name, "seed": seed,
                "program": {c.name: c.value for c in out.checks},
                "control": out.record.get("control"),
                "correct": core.judge(out), "attempted": out.attempted, "failed": out.failed,
                "metrics": {k: v["value"] for k, v in
                            core.read_metrics(cell.end_to_end, out.record).items()},
                "memory_peak_bytes": out.memory_peak_bytes}
        print(json.dumps(line), flush=True)
        del out, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
