"""Open-loop uploads to a collection served with a ViT descriptor.

The served path, the schedule, the client, the checks and their readings
are ``served_uploads``' own (its functions, loaded from its file): the
port's ``make_wsgi_app`` over ``CoalescingService`` over ``SearchService``
with the configuration's descriptor, an exact ``FlatIndex`` and one qge1
iteration. What differs is the record: the descriptor's operations are
counted per upload over its valid tokens (``perfbench/flops``), and the
readers of the ViT's spans and counters find them in the port's store.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from perfbench.harness import core
from perfbench.harness.core import Outcome, checks

served = core.load_part("drivers", "served_uploads")
setup, drive, close, readings = served.setup, served.drive, served.close, served.readings


def _upload_counts(ctx, st, out) -> tuple:
    """FLOPs of the answered uploads over their valid tokens, and those of
    their attention cores (``perfbench/flops``)."""
    fl = ctx.flops()
    total = attention = 0
    for j, r in zip(out["choices"], out["replies"]):
        if r.ok:
            h, w = st.pool.hw[int(j)]
            total += fl.upload_flops(h, w, st.cfg)
            attention += fl.upload_attention_flops(h, w, st.cfg)
    return total, attention


def record(ctx, st, out: Dict[str, Any]) -> Dict[str, Any]:
    """What the metric readers read."""
    replies = out["replies"]
    upload_flops, attention_flops = _upload_counts(ctx, st, out)
    return {
        "setup_s": ctx.setup_s,
        "latencies_s": [r.latency_s if r.ok else math.inf for r in replies],
        "lateness_s": out["lateness_s"],
        "window_s": out["window_s"],
        "completed_in_window": out["completed_in_window"],
        "last_completion_s": out["last_completion_s"],
        "timings": [r.timing for r in replies if r.ok],
        "requests_served": out["requests_served"],
        "batches_run": out["batches_run"],
        "upload_flops": upload_flops,
        "attention_flops": attention_flops,
        "trace": ctx.trace_summary,
    }


def run(ctx, control: bool = False) -> Outcome:
    """One run; with ``control`` the record also holds the control's
    readings on the same inputs (``calibrate.py``)."""
    st = setup(ctx)
    ctx.setup_done()
    with ctx.window():
        out = drive(st, ctx.traffic["rate_per_s"], ctx.seconds, ctx.seed)
    rec = record(ctx, st, out)
    peak = ctx.memory_peak_bytes()
    close(st)
    st.service = st.front = st.app = None
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    vals = readings(ctx, st, out)
    if control:
        rec["control"] = readings(ctx, st, out, control=True)
    failed = sum(not r.ok for r in out["replies"])
    return Outcome(rec, checks(ctx.traffic, vals), len(out["replies"]), failed, peak)
