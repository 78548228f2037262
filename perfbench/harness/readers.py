"""Arithmetic shared by the metric readers (each reader is a file of its
own under ``perfbench/metrics/``, found by the metric's name)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from .peaks import F32_FLOPS


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (a failed request, ``inf``, counts as
    missing every limit)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def idle_pct(rec) -> Optional[float]:
    """The traced window's share with no device operation running."""
    tr = rec.get("trace")
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def batch_mean(rec, key) -> Optional[float]:
    """Mean over batches of ``key(timing)`` from the replies' timing dicts
    (each of a batch's B replies carries the batch's dict)."""
    t = rec.get("timings")
    if not t:
        return None
    return sum(key(x) / x["batch"] for x in t) / sum(1.0 / x["batch"] for x in t)


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0:
        return None
    return 100.0 * flops / seconds / F32_FLOPS
