#!/usr/bin/env python3
"""The served cell's knee: one set-up, then open-loop windows at fixed
rates, each reporting the 50th and 95th percentile latency, the completed
requests a second and how late the last requests finished. The knee is the
highest rate whose completions keep up with the offered load without a
growing backlog; the cell's fixed rate (its traffic file's
``rate_per_s``) is set at about four fifths of it.

    python3 perfbench/knee_sweep.py --workload solar-r1m.served-uploads --seed 5 \
        --rates 6,8,10,12,14 --seconds 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.harness import core  # noqa: E402
from perfbench.harness.readers import percentile  # noqa: E402

core.set_cache_env(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = core.find_cell(core.load_benchmark(ROOT), args.workload)
    driver = core.load_part("drivers", cell.traffic["driver"])
    ctx = core.Context(cell, args.seed, args.seconds, False, "cuda", time.time())
    st = driver.setup(ctx)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            out = driver.drive(st, rate, args.seconds, args.seed)
            lat = [r.latency_s if r.ok else float("inf") for r in out["replies"]]
            done = sum(r.ok for r in out["replies"])
            tail = sorted(out["due_s"])[-1]
            worst = {}
            for d, x in zip(out["due_s"], lat):
                worst[int(d // 2)] = max(worst.get(int(d // 2), 0.0), x)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat), "failed": len(lat) - done,
                "completed_per_s": done / out["window_s"],
                "p50_ms": 1e3 * percentile(lat, 50), "p90_ms": 1e3 * percentile(lat, 90),
                "p95_ms": 1e3 * percentile(lat, 95), "p99_ms": 1e3 * percentile(lat, 99),
                "worst_ms_by_2s": [round(1e3 * worst[k]) for k in sorted(worst)],
                "last_due_s": float(tail), "window_s": out["window_s"],
                "requests_per_batch": out["requests_served"] / max(1, out["batches_run"]),
            }), flush=True)
            st.index.log.clear()
    finally:
        driver.close(st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
